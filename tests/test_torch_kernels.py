"""The port's kernel modules (plain CPU path) against the JAX reference.

Each module holding a CUDA kernel has a plain PyTorch version that its
wrapper runs for CPU tensors; these tests hold that version to the JAX
package bit for bit (exact equality: costs and MVs are integers and the
energies are exact at dyadic lambda).  The CUDA kernels themselves are held
to the plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from blockbasedmotionestimation_tpu.kernels.cv_diff import deep_pooled_cvs, delta_pooled_cvs
from blockbasedmotionestimation_tpu.kernels.gather import gather_windows_dma
from blockbasedmotionestimation_tpu.kernels.reg_step import windowed_color_step_rival
from blockbasedmotionestimation_tpu.ops import regularize as jreg
from blockbasedmotionestimation_tpu.ops.search import _gather_windows
from blockbasedmotionestimation_tpu.ops.windowed import _compute_cv
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, rounds, sad_search
from blockbasedmotionestimation_tpu_torch.ops.regularize import Strips


def _frames(rng, b, h, w):
    return rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)


# ---------------------------------------------------------------- gather (A)

@pytest.mark.parametrize("bs,ext", [(8, 4), (8, 8), (4, 2), (4, 3), (4, 4), (8, 16), (32, 12),
                                    (32, 16)])
def test_gather_matches_jax_batched(rng, bs, ext):
    # win 16, 24, 8, 10, 12, 40, 56 and 64: every store width of the kernel
    # (16, 8 or 4 bytes, or bytes where win % 4 != 0); windows at every
    # corner and edge of the frame (zero-padded reads) and at every column
    # residue mod 16 (a row's chunk starts at any byte)
    b, h, w = 3, 40, 56
    im = _frames(rng, b, h, w)
    n = 20
    by = rng.integers(0, h - bs + 1, size=(b, n)).astype(np.int32)
    bx = rng.integers(0, w - bs + 1, size=(b, n)).astype(np.int32)
    ys, xs = (0, (h - bs) // 2, h - bs), (0, (w - bs) // 2, w - bs)
    edges = [(y, x) for y in ys for x in xs if (y, x) != (ys[1], xs[1])]
    by[0, :8], bx[0, :8] = zip(*edges)
    bx[1, :16] = 3 + np.arange(16)
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


def _from_chunk_major(a, cur, bs, n_p, npy, npx):
    """A TPU volume in the port's (nd, npy*f, npx*f) layout.  The TPU
    kernels write cur < bs chunk-major (cv_diff.py:687-697): (yq, yp, xb,
    chunk, dy, dx, xq, lane); cur == bs as (dy, dx, 1, 1, nPad)."""
    f = bs // cur
    a = np.asarray(a)
    if cur < bs:
        nd = a.shape[4] * a.shape[5]
        a = a.transpose(4, 5, 0, 1, 6, 2, 3, 7).reshape(nd, f, f, -1)
    nd = a.shape[0] * a.shape[1] if cur == bs else a.shape[0]
    a = a.reshape(nd, f, f, -1)[..., :n_p].reshape(nd, f, f, npy, npx)
    return a.transpose(0, 3, 1, 4, 2).reshape(nd, npy * f, npx * f).astype(np.int64)


def _tpu_inputs(im1, wins, bs):
    """The TPU kernels' (bs, bs, nP) / (win, win, nP) int16 inputs."""
    h, w = im1.shape[1:]
    npy, npx = h // bs, w // bs
    patches_t = im1[0].reshape(npy, bs, npx, bs).transpose(1, 3, 0, 2).reshape(bs, bs, -1)
    return jnp.asarray(patches_t.astype(np.int16)), jnp.asarray(wins[0].transpose(1, 2, 0).astype(np.int16))


def test_pooled_cvs_match_delta_pooled_kernel_interpret(rng):
    bs, r, h, w = 8, 4, 16, 24
    npy, npx = h // bs, w // bs
    im1 = _frames(rng, 1, h, w)
    wins = _windows_for(_frames(rng, 1, h, w), bs, r, rng)
    ref = delta_pooled_cvs(*_tpu_inputs(im1, wins, bs), bs, r, r, "sad", interpret=True)
    got = cv_diff.pooled_cvs(torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad")
    for cur, vol in got.items():
        np.testing.assert_array_equal(
            vol[0].numpy().astype(np.int64), _from_chunk_major(ref[cur], cur, bs, npy * npx, npy, npx)
        )


@pytest.mark.parametrize("store_r", [0, 2])
def test_stored_band_matches_delta_pooled_kernel_interpret(rng, store_r):
    # the cur=2 band of the static kernel's store_r2 mode, at a 64x96 frame
    bs, r, h, w = 8, 6, 64, 96
    npy, npx = h // bs, w // bs
    im1 = _frames(rng, 1, h, w)
    wins = _windows_for(_frames(rng, 1, h, w), bs, r, rng)
    ref = delta_pooled_cvs(
        *_tpu_inputs(im1, wins, bs), bs, r, r, "sad", interpret=True, store_r2=store_r
    )
    got = cv_diff.pooled_cvs(
        torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad", store_r=store_r
    )
    side, st = 2 * r + 1, 2 * store_r + 1
    assert tuple(got[2].shape) == (1, side * st, h // 2, w // 2)
    np.testing.assert_array_equal(
        got[2][0].numpy().astype(np.int64), _from_chunk_major(ref[2], 2, bs, npy * npx, npy, npx)
    )
    # the band is the dense volume's dx columns [r - store_r, r + store_r]
    dense = cv_diff.pooled_cvs(torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad")[2]
    band = dense.reshape(1, side, side, h // 2, w // 2)[:, :, r - store_r : r + store_r + 1]
    assert torch.equal(got[2], band.reshape(got[2].shape))
    for cur in (4, 8):
        assert torch.equal(got[cur], cv_diff.pooled_cvs(
            torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad")[cur])


@pytest.mark.parametrize("fuse_max", [4, 2])
def test_deep_pooled_cvs_match_kernel_interpret(rng, fuse_max):
    # kernel C: only cur > fuse_max and cur = bs are written
    bs, r, h, w = 8, 5, 64, 96
    npy, npx = h // bs, w // bs
    im1 = _frames(rng, 1, h, w)
    wins = _windows_for(_frames(rng, 1, h, w), bs, r, rng)
    ref = deep_pooled_cvs(*_tpu_inputs(im1, wins, bs), bs, r, r, fuse_max, "sad", interpret=True)
    got = cv_diff.deep_pooled_cvs(torch.as_tensor(im1), torch.as_tensor(wins), bs, r, "sad", fuse_max)
    assert sorted(got) == sorted(ref) == cv_diff.deep_curs(bs, fuse_max)
    for cur, vol in got.items():
        assert vol.dtype == cv_diff.cv_dtype(cur, "sad")
        np.testing.assert_array_equal(
            vol[0].numpy().astype(np.int64), _from_chunk_major(ref[cur], cur, bs, npy * npx, npy, npx)
        )


def test_pooled_cvs_options_are_checked(rng):
    im1 = torch.as_tensor(_frames(rng, 1, 16, 16))
    wins = torch.zeros((1, 4, 16, 16), dtype=torch.uint8)
    for kw in (dict(store_r=5), dict(store_r=-1), dict(emit=[3]), dict(emit=[]),
               dict(store_r=1, emit=[4, 8])):
        with pytest.raises(ValueError):
            cv_diff.pooled_cvs(im1, wins, 8, 4, "sad", **kw)
    launches = cv_diff.deep_pooled_cvs.launches
    assert sorted(cv_diff.deep_pooled_cvs(im1, wins, 8, 4, "sad", 4)) == [8]
    assert cv_diff.deep_pooled_cvs.launches == launches  # CPU: plain, no launch


_GRIDS = [(1, 1, 1), (1, 2, 3), (3, 8, 12), (8, 5, 8), (8, 20, 32), (8, 40, 64)]


@pytest.mark.parametrize("bs", [2, 4, 8, 16, 32, 64, 128])
def test_volume_geometry_fits_the_block(bs):
    # the kernel's launch for every bs it is built for and every r <= 32:
    # shared memory within the H100's 232 448 bytes a block, whole warps of
    # whole (parent, cur=2 row) groups, at most 8 parents of one row
    for r in range(33):
        for (b, npy, npx), fine in itertools.product(_GRIDS, (False, True)):
            geo = cv_diff.volume_geometry(bs, r, b, npy, npx, fine)
            assert geo.smem_bytes <= cv_diff.SMEM_LIMIT == 232_448, (r, npx, geo)
            assert geo.threads % 32 == 0 and 32 <= geo.threads <= cv_diff.MAX_THREADS
            assert geo.threads % (max(1, bs // 2) * geo.parents_per_block) == 0, geo
            assert geo.parents_per_block in (1, 2, 4, 8) and geo.parents_per_block <= npx
            assert geo.smem_bytes == cv_diff.volume_smem(bs, r, geo.dy_per_block,
                                                         geo.parents_per_block)


@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("r", [16, 12, 8])
def test_volume_geometry_fills_the_card_at_level_3(r, fine):
    # the 1080p level 3 at B=8: a 5x8 parent grid per frame, 320 parents;
    # the main window (r 16) and the rival windows (r 12, 8)
    assert cv_diff.volume_geometry(32, r, 8, 5, 8, fine).blocks >= 2 * cv_diff.SMS
    # level 0 (a 40x64 grid): C and 13 read each window once
    level0 = cv_diff.volume_geometry(32, r, 8, 40, 64, fine)
    assert level0.blocks >= 2 * cv_diff.SMS
    assert level0.groups == 1


@pytest.mark.parametrize("bs,grid", [(2, (1, 1, 1)), (8, (1, 8, 12)), (32, (3, 8, 12)),
                                     (32, (8, 5, 8)), (64, (8, 40, 64))])
def test_volume_geometry_covers_every_dy_row_once(bs, grid):
    for r, fine in itertools.product(range(33), (False, True)):
        side = 2 * r + 1
        geo = cv_diff.volume_geometry(bs, r, *grid, fine)
        rows = [dy for g in range(geo.groups)
                for dy in range(g * geo.dy_per_block, min(side, (g + 1) * geo.dy_per_block))]
        assert rows == list(range(side)), (r, geo)
        assert (geo.groups - 1) * geo.dy_per_block < side  # no empty group


_LEVELS_1080P = [(8, 40, 64), (8, 20, 32), (8, 10, 16), (8, 5, 8)]  # B=8, npy, npx


@pytest.mark.parametrize(
    "bs,r,k_slots,grid",
    [(32, 16, 64, g) for g in _LEVELS_1080P]  # the cv_compact=64 path, every level
    + [(32, 16, 1089, _LEVELS_1080P[0]),  # K = side^2
       (64, 208, 64, (1, 2, 3)),  # the widest window cuda_refusals takes at bs 64
       (128, 5, 64, (2, 11, 13)), (16, 7, 225, (2, 11, 13)), (8, 3, 8, (2, 11, 13)),
       (4, 1, 1, (1, 1, 1))],
)
def test_compact_geometry_fits_the_block(bs, r, k_slots, grid):
    # kernel 14's launch: the shared bytes of cv_diff.cu compact_layout
    # within the H100's 232 448 bytes a block, whole warps of whole (parent,
    # slot) groups, every slot in exactly one group of whole iterations
    b, npy, npx = grid
    f2 = bs // 2
    geo = cv_diff.compact_geometry(bs, r, k_slots, b, npy, npx)
    pp = geo.parents_per_block
    assert geo.smem_bytes == cv_diff.compact_smem(bs, r, pp) <= cv_diff.SMEM_LIMIT, geo
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= cv_diff.MAX_THREADS
    assert geo.threads % (f2 * pp) == 0 and pp in (1, 2, 4, 8) and pp <= npx, geo
    assert geo.slots_per_block % (geo.threads // (f2 * pp)) == 0, geo
    assert (geo.groups - 1) * geo.slots_per_block < k_slots <= geo.groups * geo.slots_per_block
    assert geo.blocks == b * npy * -(-npx // pp) * geo.groups


def test_compact_geometry_fills_the_card_at_every_level():
    # the 1080p levels at B=8, K=64: levels 0-1 read each window once, the
    # smaller ones split the slots so the grid covers the 132 SMs
    geos = [cv_diff.compact_geometry(32, 16, 64, *g) for g in _LEVELS_1080P]
    assert [g.groups for g in geos] == [1, 1, 4, 8]
    assert all(g.blocks >= 4 * cv_diff.SMS and g.parents_per_block == 4 for g in geos)


@pytest.mark.parametrize("bs,r,pp,want", [
    (32, 16, 4, 17_664),   # ws 64: pitch 17, 64 * 17 = 1088 words -> 1104 (= 16 mod 32)
    (32, 16, 1, 4_416),
    (8, 3, 8, 3_200),      # ws 14: pitch 5, 70 words -> 100 (= 4 mod 32)
    (16, 7, 4, 4_736),     # ws 30: pitch 9, 270 words -> 296 (= 8 mod 32)
    (64, 208, 1, 232_320), # ws 480: pitch 121, 58 080 words (bs 64: no bank padding)
    (64, 209, 1, 237_144), # ws 482: pitch 122 -> 123: over the 232 448 bytes
    (128, 5, 4, 81_696),   # ws 138: pitch 36 -> 37, 5106 words
])
def test_compact_smem_is_the_c_layout(bs, r, pp, want):
    # compact_smem against cv_diff.cu compact_layout, worked by hand
    assert cv_diff.compact_smem(bs, r, pp) == want


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
    rounds.color_step(
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
        rounds.color_step(g, cv, pm, cur=4, h=16, w=16, r=1, ci=0, cj=0, lam_mult=1.0)


# ----------------------------------------------- hybrid colour steps (E, F)

@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("bs,cur", [(8, 2), (8, 4), (16, 8)])
def test_hybrid_steps_equal_dense_color_step(rng, cost, bs, cur):
    # E (dense main volume + rival recompute) and F (band + main-tail and
    # rival recompute) against D' on the dense volumes of the same windows,
    # candidates within +-20 of the centres: in band, in the tail, rival
    # only, unevaluable and off the frame's edge
    b, h, w, r, r2, store_r = 2, 4 * bs, 6 * bs, 7, 5, 2
    f = bs // cur
    npy, npx = h // bs, w // bs
    im1 = torch.as_tensor(_frames(rng, b, h, w))
    win = torch.as_tensor(_windows_for(_frames(rng, b, h, w), bs, r, rng))
    rwin = torch.as_tensor(_windows_for(_frames(rng, b, h, w), bs, r2, rng))
    dense = cv_diff.pooled_cvs(im1, win, bs, r, cost)
    rdense = cv_diff.pooled_cvs(im1, rwin, bs, r2, cost)
    band = cv_diff.pooled_cvs(im1, win, bs, r, cost, store_r=store_r, emit=[2])[2]
    pm = torch.as_tensor(rng.integers(-6, 7, size=(b, npy, npx, 2)), dtype=torch.int32)
    rpm = pm + torch.as_tensor(rng.integers(-12, 13, size=pm.shape), dtype=torch.int32)
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = g0 + torch.as_tensor(rng.integers(-20, 21, size=g0.shape), dtype=torch.int32)
    kw = dict(cur=cur, h=h, w=w, r=r, lam_mult=2.0 * f, r2=r2)
    for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
        want = g0.clone()
        rounds.color_step(want, dense[cur], pm, ci=ci, cj=cj, rcv=rdense[cur], rpm=rpm, **kw)
        assert not torch.equal(want, g0)
        got = g0.clone()
        rounds.color_step_hybrid(got, dense[cur], pm, ci=ci, cj=cj, im1=im1, rwin=rwin,
                                     rpm=rpm, cost=cost, **kw)
        assert torch.equal(got, want), (ci, cj)
        if cur == 2:
            got = g0.clone()
            rounds.color_step_hybrid_tail(
                got, band, pm, ci=ci, cj=cj, im1=im1, win=win, rwin=rwin, rpm=rpm,
                store_r=store_r, cost=cost, **kw,
            )
            assert torch.equal(got, want), (ci, cj)


def test_hybrid_steps_reject_bad_inputs(rng):
    launches = (rounds.color_step_hybrid.launches, rounds.color_step_hybrid_tail.launches)
    g = torch.zeros((1, 4, 4, 2), dtype=torch.int32)
    pm = torch.zeros((1, 1, 1, 2), dtype=torch.int32)
    im1 = torch.zeros((1, 8, 8), dtype=torch.uint8)
    rwin = torch.zeros((1, 1, 12, 12), dtype=torch.uint8)
    win = torch.zeros((1, 1, 14, 14), dtype=torch.uint8)
    kw = dict(cur=2, h=8, w=8, r=3, r2=2, ci=0, cj=0, lam_mult=1.0, cost="sad")
    good = torch.zeros((1, 49, 4, 4), dtype=torch.uint16)
    rounds.color_step_hybrid(g, good, pm, im1=im1, rwin=rwin, rpm=pm, **kw)
    with pytest.raises(ValueError):  # volume of the wrong radius
        rounds.color_step_hybrid(g, good[:, :25], pm, im1=im1, rwin=rwin, rpm=pm, **kw)
    with pytest.raises(ValueError):  # rival windows of the wrong edge
        rounds.color_step_hybrid(g, good, pm, im1=im1, rwin=win, rpm=pm, **kw)
    band = torch.zeros((1, 7 * 3, 4, 4), dtype=torch.uint16)
    rounds.color_step_hybrid_tail(g, band, pm, im1=im1, win=win, rwin=rwin, rpm=pm,
                                      store_r=1, **kw)
    with pytest.raises(ValueError):  # band of another store_r
        rounds.color_step_hybrid_tail(g, band, pm, im1=im1, win=win, rwin=rwin, rpm=pm,
                                          store_r=2, **kw)
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (rounds.color_step_hybrid.launches,
            rounds.color_step_hybrid_tail.launches) == launches


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
     (sad_search, "bbme_sad_spiral_argmin", "sad_search.cu"),
     (cv_diff, "bbme_compact_tables", "cv_diff.cu"),
     (rounds, "bbme_round", "fused_step.cu")],
)
def test_ctypes_argtypes_match_c_signature(module, name, source):
    # the library is built only on a CUDA machine; the declared argument
    # types are held to the C signature here, position by position
    import ctypes
    from pathlib import Path

    src = (Path(module.__file__).resolve().parent.parent / "csrc" / source).read_text()
    params = _c_params(src, name)
    argtypes = module.TABLES_ARGTYPES if name == "bbme_compact_tables" else module.ARGTYPES
    assert len(params) == len(argtypes), (params, argtypes)
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), (p, t)
        elif p.startswith("int "):
            assert t is ctypes.c_int, (p, t)
        else:
            assert p.startswith("float ") and t is ctypes.c_float, (p, t)


# the C enumerator of each form of the round kernel
C_FORMS = {"stored": "kStored", "compact": "kCompact", "hybrid": "kHybrid",
           "hybrid_tail": "kTail", "fused": "kFused", "fused_rival": "kFused"}


def _round_case(form: str, rng):
    """A call of form ``form`` on CPU tensors at bs 8, cur 4 (f = 2), r 2,
    r2 1, store_r 1, K 3: the grid, and the tensors before the keywords
    with the keywords."""
    b, cur, h, w, r, r2 = 1, 4, 16, 16, 2, 1
    nby, nbx, n_p = h // cur, w // cur, 4

    def ints(*shape, dtype=torch.int32, hi=3):
        return torch.as_tensor(rng.integers(0, hi, size=shape)).to(dtype)

    grid, pm, rpm = ints(b, nby, nbx, 2), ints(b, 2, 2, 2), ints(b, 2, 2, 2)
    im1 = ints(b, h, w, dtype=torch.uint8, hi=256)
    win = ints(b, n_p, 8 + 2 * r, 8 + 2 * r, dtype=torch.uint8, hi=256)
    rwin = ints(b, n_p, 8 + 2 * r2, 8 + 2 * r2, dtype=torch.uint8, hi=256)
    cv = ints(b, (2 * r + 1) ** 2, nby, nbx, dtype=torch.uint16, hi=900)
    kw = dict(cur=cur, h=h, w=w, r=r)
    recompute = dict(kw, im1=im1, cost="ssd")
    return grid, {
        "stored": ((cv, pm), dict(kw, rcv=ints(b, (2 * r2 + 1) ** 2, nby, nbx, hi=900), rpm=rpm,
                                  r2=r2)),
        "compact": ((ints(b, 3, nby, nbx, hi=900), pm, ints(b, 1, 3, 2, hi=5)),
                    dict(kw, smap=ints(b, 1, (2 * r + 1) ** 2, dtype=torch.uint16))),
        "hybrid": ((cv, pm), dict(recompute, rwin=rwin, rpm=rpm, r2=r2)),
        "hybrid_tail": ((ints(b, (2 * r + 1) * 3, nby, nbx, hi=900), pm),
                        dict(recompute, win=win, rwin=rwin, rpm=rpm, store_r=1, r2=r2)),
        "fused": ((pm,), dict(recompute, win=win)),
        "fused_rival": ((pm,), dict(recompute, win=win, rwin=rwin, rpm=rpm, r2=r2)),
    }[form]


@pytest.mark.parametrize("kind", ["step", "round"])
@pytest.mark.parametrize("form", list(rounds.FORMS))
def test_round_wrappers_pack_the_c_signature(monkeypatch, rng, form, kind):
    # the arguments each wrapper passes to bbme_round on the card's path
    # (taken here on CPU tensors, each launch recorded instead of made),
    # held to the C signature position by position and type by type
    import contextlib
    import ctypes
    import re
    from pathlib import Path

    src = (Path(rounds.__file__).resolve().parent.parent / "csrc" / "fused_step.cu").read_text()
    params = _c_params(src, "bbme_round")
    names = [p.split()[-1].lstrip("*") for p in params]
    enum = dict(re.findall(r"(k\w+) = (\d+)", re.search(r"enum Form \{([^}]*)\}", src).group(1)))
    sent = []
    monkeypatch.setattr(rounds, "_on_card", lambda grid: True)
    monkeypatch.setattr(rounds, "_entry", lambda: lambda *a: sent.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: None,
                        raising=False)
    row = rounds.FORMS[form]
    grid, (tensors, kw) = _round_case(form, rng)
    strips = None
    if kind == "round":
        fn = getattr(rounds, row.round_name)
        monkeypatch.setattr(fn, "launches", 0)
        fn(grid, *tensors, lam=0.3, sweeps=rounds.MAX_SWEEPS + 1, **kw)
        spans = [(0, 4 * rounds.MAX_SWEEPS, rounds.MAX_SWEEPS), (0, 4, 1)]
    else:
        fn = getattr(rounds, row.step_name)
        monkeypatch.setattr(fn, "launches", 0)
        if row.tiles:  # a 2-D tile of a frame twice as large
            one = torch.ones(1, dtype=torch.int32)
            strips = Strips(one, 32, torch.zeros((1, 2, 4, 2), dtype=torch.int32), one.clone(),
                            32, torch.zeros((1, 2, 6, 2), dtype=torch.int32))
        fn(grid, *tensors, ci=1, cj=0, lam_mult=0.3, strips=strips, **kw)
        spans = [(2, 1, 1)]
    assert fn.launches == len(sent) == len(spans)
    # what each named argument must carry: the tensors by name, null where
    # the form takes none; the stored costs are the first of several tensors
    vol = tensors[0] if len(tensors) > 1 else None
    ptr = {n: None if t is None else t.data_ptr() for n, t in (
        ("cv", vol), ("pm", tensors[1] if vol is not None else tensors[0]),
        *((n, kw.get(n)) for n in ("rcv", "im1", "win", "rwin", "rpm", "smap")))}
    ptr["rank_table"] = rounds._rank_table_on(grid.device).data_ptr()
    ptr["row0_b"], ptr["col0_b"] = (strips.row0_b.data_ptr(), strips.col0_b.data_ptr()) \
        if strips else (None, None)
    for args, span in zip(sent, spans):
        assert len(args) == len(params) == len(rounds.ARGTYPES), (params, args)
        for p, t, v in zip(params, rounds.ARGTYPES, args):
            if "*" in p:
                assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), (p, t)
            else:
                assert p.startswith("int ") and t is ctypes.c_int and type(v) is int, (p, t, v)
            t.from_param(v)  # ctypes takes the value as the declared type
        got = dict(zip(names, args))
        assert {n: got[n] for n in ptr} == ptr
        assert got["form"] == int(enum[C_FORMS[form]])
        assert (got["grid"], got["cur"], got["h"], got["w"], got["r"], got["f"]) == (
            grid.data_ptr(), 4, 16, 16, 2, 2)
        assert (got["cv16"], got["rcv16"]) == (int(vol is not None and vol.dtype == torch.uint16),
                                               int("rcv" in kw and kw["rcv"].dtype == torch.uint16))
        assert (got["r2"], got["ssd"]) == (kw.get("r2", 0), int(kw.get("cost") == "ssd"))
        if form == "hybrid_tail":
            assert got["store_r"] == kw["store_r"]
        assert (got["k_slots"], got["nch"]) == ((3, 1) if form == "compact" else (0, 0))
        assert (got["step0"], got["nsteps"], got["n_lam"], len(got["lams"])) == span + span[2:]
        assert (got["full_h"], got["full_w"]) == ((32, 32) if strips else (16, 16))
