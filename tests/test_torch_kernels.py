"""The port's kernel modules (plain CPU path) against the JAX reference.

Each module holding a CUDA kernel has a plain PyTorch version that its
wrapper runs for CPU tensors; these tests hold that version to the JAX
package bit for bit (exact equality: costs and MVs are integers and the
energies are exact at dyadic lambda).  The CUDA kernels themselves are held
to the plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from blockbasedmotionestimation_tpu.kernels.cv_diff import delta_pooled_cvs
from blockbasedmotionestimation_tpu.kernels.gather import gather_windows_dma
from blockbasedmotionestimation_tpu.kernels.reg_step import windowed_color_step_rival
from blockbasedmotionestimation_tpu.ops import regularize as jreg
from blockbasedmotionestimation_tpu.ops.search import _gather_windows
from blockbasedmotionestimation_tpu.ops.windowed import _compute_cv
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, reg_step


def _frames(rng, b, h, w):
    return rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)


# ---------------------------------------------------------------- gather (A)

@pytest.mark.parametrize("bs,ext", [(8, 4), (8, 8), (4, 2)])
def test_gather_matches_jax_batched(rng, bs, ext):
    b, h, w = 3, 40, 56
    im = _frames(rng, b, h, w)
    n = 11
    by = rng.integers(0, h - bs + 1, size=(b, n)).astype(np.int32)
    bx = rng.integers(0, w - bs + 1, size=(b, n)).astype(np.int32)
    by[0, :2], bx[0, :2] = (0, h - bs), (w - bs, 0)  # corners: zero-padded reads
    want = np.asarray(
        jax.vmap(lambda i, y, x: _gather_windows(i, y, x, bs, ext))(
            jnp.asarray(im), jnp.asarray(by), jnp.asarray(bx)
        )
    )
    got = gather.gather_windows(
        torch.as_tensor(im), torch.as_tensor(by), torch.as_tensor(bx), bs, ext
    )
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_matches_dma_kernel_interpret(rng):
    # the TPU kernel (row-shifted copies + superwindows + one-hot extract)
    # run in interpret mode on the ext-padded frame
    bs, ext, h, w, n = 8, 4, 48, 160, 9
    win = bs + 2 * ext
    im = _frames(rng, 1, h, w)
    by = rng.integers(0, h - bs + 1, size=(1, n)).astype(np.int32)
    bx = rng.integers(0, w - bs + 1, size=(1, n)).astype(np.int32)
    im2p = np.pad(im[0], ext)
    want = np.asarray(
        gather_windows_dma(
            jnp.asarray(im2p), jnp.asarray(by[0]), jnp.asarray(bx[0]), win,
            interpret=True,
        )
    )
    got = gather.gather_windows(
        torch.as_tensor(im), torch.as_tensor(by), torch.as_tensor(bx), bs, ext
    )
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_gather_rejects_bad_inputs(rng):
    im = torch.as_tensor(_frames(rng, 1, 16, 16))
    off = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.gather_windows(im.to(torch.int32), off, off, 4, 2)
    with pytest.raises(ValueError):
        gather.gather_windows(im, off.long(), off, 4, 2)
    launches = gather.gather_windows.launches
    gather.gather_windows(im, off, off, 4, 2)
    assert gather.gather_windows.launches == launches  # CPU: plain, no launch


# ------------------------------------------------------------ cost volume (B)

def _windows_for(im2, bs, ext, rng):
    b, h, w = im2.shape
    npy, npx = h // bs, w // bs
    by = rng.integers(0, h - bs + 1, size=(b, npy * npx)).astype(np.int32)
    bx = rng.integers(0, w - bs + 1, size=(b, npy * npx)).astype(np.int32)
    return gather.gather_windows(
        torch.as_tensor(im2), torch.as_tensor(by), torch.as_tensor(bx), bs, ext
    ).numpy()


@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("bs,r", [(8, 4), (8, 3), (4, 3)])
def test_pooled_cvs_match_compute_cv(rng, cost, bs, r):
    b, h, w = 2, 24, 40
    im1 = _frames(rng, b, h, w)
    wins = _windows_for(_frames(rng, b, h, w), bs, r, rng)
    got = cv_diff.pooled_cvs(torch.as_tensor(im1), torch.as_tensor(wins), bs, r, cost)
    npy, npx = h // bs, w // bs
    assert sorted(got) == [c for c in (2, 4, 8) if c <= bs]
    for bi in range(b):
        patches1 = im1[bi].reshape(npy, bs, npx, bs).transpose(0, 2, 1, 3).astype(np.int16)
        win4 = wins[bi].reshape(npy, npx, bs + 2 * r, bs + 2 * r).astype(np.int16)
        for cur, vol in got.items():
            want = np.asarray(
                _compute_cv(jnp.asarray(patches1), jnp.asarray(win4), bs, cur, r, r, cost)
            )
            assert vol.dtype == cv_diff.cv_dtype(cur, cost)
            assert str(want.dtype) == str(vol.dtype).replace("torch.", "")
            np.testing.assert_array_equal(vol[bi].numpy(), want)


def test_pooled_cvs_match_delta_pooled_kernel_interpret(rng):
    # the TPU kernel's chunk-major output, re-laid out per its docstring
    # (cv_diff.py:687-697): (yq, yp, xb, chunk, dy, dx, xq, lane) for
    # cur < bs, (dy, dx, 1, 1, nPad) for cur == bs
    bs, r, h, w = 8, 4, 16, 24
    npy, npx = h // bs, w // bs
    n_p = npy * npx
    side = 2 * r + 1
    im1 = _frames(rng, 1, h, w)
    wins = _windows_for(_frames(rng, 1, h, w), bs, r, rng)
    patches_t = (
        im1[0].reshape(npy, bs, npx, bs).transpose(1, 3, 0, 2).reshape(bs, bs, n_p)
    ).astype(np.int16)
    windows_t = wins[0].transpose(1, 2, 0).astype(np.int16)
    ref = delta_pooled_cvs(
        jnp.asarray(patches_t), jnp.asarray(windows_t), bs, r, r, "sad",
        interpret=True,
    )
    got = cv_diff.pooled_cvs(torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad")
    for cur, vol in got.items():
        f = bs // cur
        a = np.asarray(ref[cur])
        if cur < bs:
            a = a.transpose(4, 5, 0, 1, 6, 2, 3, 7).reshape(side * side, f, f, -1)
        a = a.reshape(side * side, f, f, -1)[..., :n_p].reshape(side * side, f, f, npy, npx)
        a = a.transpose(0, 3, 1, 4, 2).reshape(side * side, npy * f, npx * f)
        np.testing.assert_array_equal(vol[0].numpy().astype(np.int64), a.astype(np.int64))


def test_pooled_cvs_refuse_zsad(rng):
    im1 = torch.as_tensor(_frames(rng, 1, 8, 8))
    wins = torch.zeros((1, 1, 12, 12), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        cv_diff.pooled_cvs(im1, wins, 8, 2, "zsad")


# ------------------------------------------------------------ colour step (D)

def _color_inputs(x, ci, cj):
    return np.ascontiguousarray(x[..., ci::2, cj::2])


@pytest.mark.parametrize("color", [(0, 0), (1, 1)])
def test_color_step_matches_rival_kernel_interpret(rng, color):
    # one f = 1 colour step at the smallest tile shape of the TPU kernel
    # (M2 = 8 rows, N2 = 128 cols of one colour), with candidates spread
    # over in-window, rival-only and unevaluable deltas
    ci, cj = color
    cur, r, r2, lam = 8, 4, 3, 4.0
    m2, n2 = 8, 128
    nby, nbx = 2 * m2, 2 * n2
    h, w = nby * cur, nbx * cur
    side, side2 = 2 * r + 1, 2 * r2 + 1
    cv = rng.integers(0, 16000, size=(1, side * side, nby, nbx)).astype(np.uint16)
    rcv = rng.integers(0, 16000, size=(1, side2 * side2, nby, nbx)).astype(np.uint16)
    pm = rng.integers(-6, 7, size=(1, nby, nbx, 2)).astype(np.int32)
    rpm = (pm + rng.integers(-6, 7, size=pm.shape)).astype(np.int32)
    grid = (pm + rng.integers(-8, 9, size=pm.shape)).astype(np.int32)
    grid[0, :3, :3] = pm[0, :3, :3]  # a smooth corner
    grid[0, 5, 7] = (-40, -40)        # a candidate that leaves the image

    # the reference kernel's inputs, built as ops/windowed._pallas_round does
    gp = np.pad(grid[0], ((1, 1), (1, 1), (0, 0)))
    cands = np.stack([
        gp[1 + ci + dy : 1 + ci + dy + nby : 2, 1 + cj + dx : 1 + cj + dx + nbx : 2]
        for dy, dx in jreg.SLOTS
    ]).transpose(0, 3, 1, 2)  # (9, 2, m2, n2)
    gi = ci + 2 * np.arange(m2)[:, None]
    gj = cj + 2 * np.arange(n2)[None, :]
    case = np.asarray(jreg._border_case(jnp.asarray(gi), jnp.asarray(gj), nby, nbx))
    rank = jreg._RANK_TABLE[case]
    present = rank < jreg._BIG_RANK
    for k, (dy, dx) in enumerate(jreg.SLOTS):
        present[..., k] &= (gi + dy >= 0) & (gi + dy < nby) & (gj + dx >= 0) & (gj + dx < nbx)
    colors = ((0, 0), (0, 1), (1, 0), (1, 1))
    cidx = colors.index(color)

    def by_color(x):  # (..., nby, nbx) -> (4, ..., m2, n2), this colour filled
        out = np.zeros((4,) + x.shape[:-2] + (m2, n2), x.dtype)
        out[cidx] = _color_inputs(x, ci, cj)
        return out

    ref = windowed_color_step_rival(
        jnp.asarray([cidx, ci, cj, 0, 0], jnp.int32), jnp.float32(lam),
        jnp.asarray(by_color(cv[0])), jnp.asarray(by_color(rcv[0])),
        jnp.asarray(cands.astype(np.int32)),
        jnp.asarray(by_color(pm[0].transpose(2, 0, 1))),
        jnp.asarray(by_color(rpm[0].transpose(2, 0, 1))),
        jnp.asarray(np.broadcast_to(present.transpose(2, 0, 1).astype(np.int32), (4, 9, m2, n2))),
        jnp.asarray(np.broadcast_to(rank.transpose(2, 0, 1), (4, 9, m2, n2))),
        side, r, side2, r2, cur, h, w, interpret=True,
    )
    g = torch.as_tensor(grid.copy())
    reg_step.color_step(
        g, torch.as_tensor(cv), torch.as_tensor(pm), cur=cur, h=h, w=w, r=r,
        ci=ci, cj=cj, lam_mult=lam, rcv=torch.as_tensor(rcv),
        rpm=torch.as_tensor(rpm), r2=r2,
    )
    np.testing.assert_array_equal(
        g[0, ci::2, cj::2].numpy(), np.asarray(ref).transpose(1, 2, 0)
    )
    # the other colours are untouched
    mask = np.ones((nby, nbx), bool)
    mask[ci::2, cj::2] = False
    np.testing.assert_array_equal(g[0].numpy()[mask], grid[0][mask])
    assert (g[0, ci::2, cj::2].numpy() != grid[0, ci::2, cj::2]).any()


def test_color_step_rejects_mismatched_volume(rng):
    g = torch.zeros((1, 4, 4, 2), dtype=torch.int32)
    pm = torch.zeros((1, 4, 4, 2), dtype=torch.int32)
    cv = torch.zeros((1, 9, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        reg_step.color_step(g, cv, pm, cur=4, h=16, w=16, r=1, ci=0, cj=0, lam_mult=1.0)


# ------------------------------------------------- C entry points (ctypes)

def _c_params(src: str, name: str) -> list[str]:
    import re

    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


@pytest.mark.parametrize(
    "module,name,source",
    [(gather, "bbme_gather_windows", "gather.cu"),
     (cv_diff, "bbme_pooled_cvs", "cv_diff.cu"),
     (reg_step, "bbme_color_step", "reg_step.cu")],
)
def test_ctypes_argtypes_match_c_signature(module, name, source):
    # the library is built only on a CUDA machine; the declared argument
    # types are held to the C signature here, position by position
    import ctypes
    from pathlib import Path

    src = (Path(module.__file__).resolve().parent.parent / "csrc" / source).read_text()
    params = _c_params(src, name)
    assert len(params) == len(module.ARGTYPES), (params, module.ARGTYPES)
    for p, t in zip(params, module.ARGTYPES):
        if "*" in p:
            assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), (p, t)
        elif p.startswith("int "):
            assert t is ctypes.c_int, (p, t)
        else:
            assert p.startswith("float ") and t is ctypes.c_float, (p, t)
