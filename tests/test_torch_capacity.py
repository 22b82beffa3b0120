"""The capacity modes' modules against the JAX package's own kernels.

``cv_fused`` and ``cv_compact`` run five TPU kernels: 11 and 12
(``fused_step.windowed_color_step_pm_fused`` / ``_fused_rival``), 13
(``cv_diff.full_block_volume``), 14 (``cv_diff.compact_tables``) and 10
(``reg_step.windowed_color_step_pm_compact``), plus ``ops/compact``'s slot
lists (XLA code).  Each port module's plain version (what its wrapper runs
on CPU tensors) is held here to the JAX function, the kernels in interpret
mode, at the smallest shapes that exercise them (bs 8, small radii, one
128-parent chunk): exact equality.  The kernels' inputs are laid out as
``ops/windowed._pallas_round_pm`` lays them out (chunk-major, parent lanes
padded to 128); the outputs are laid back into the port's grid.  An
overflowing compact level (K = 4), one whose deltas travel further than
the ring (ring 0) and a B = 2 level of 192 parents a frame (two chunks,
slot lists across chunk edges, K large enough that no chunk overflows, so
only the ring excludes) run against JAX's whole interpret-mode level in a
fresh interpreter, as ``tests/test_torch_hybrid.py`` does.  With
``search_impl="xla"`` the port's engine runs the compact configuration as
JAX's XLA level does: the dense result.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import jax.numpy as jnp

from blockbasedmotionestimation_tpu.kernels import cv_diff as jcv
from blockbasedmotionestimation_tpu.kernels import fused_step as jfs
from blockbasedmotionestimation_tpu.kernels import reg_step as jrs
from blockbasedmotionestimation_tpu.ops import compact as jcompact
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, rounds
from blockbasedmotionestimation_tpu_torch.ops import compact
from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS, step_candidates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bs 8 on a 32x48 frame: 4x6 parents, one ragged chunk
BS, H, W, R, R2 = 8, 32, 48, 4, 3
NPY, NPX = H // BS, W // BS
N_P = NPY * NPX


def _cm(x):
    """(..., nP) -> chunk-major (nch, ..., 128), parent lanes zero-padded."""
    npp = -(-N_P // 128) * 128
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, npp - N_P)])
    return np.moveaxis(x.reshape(*x.shape[:-1], npp // 128, 128), -2, 0)


def _from_cm(x):
    """chunk-major (nch, ..., 128) -> (..., nP)."""
    y = np.moveaxis(np.asarray(x), 0, -2)
    return y.reshape(*y.shape[:-2], -1)[..., :N_P]


def _cells(x, f):
    """(m, n, ...) cells of one colour -> (..., s2, s2, nP) parent-major."""
    s2 = f // 2
    rest = x.shape[2:]
    y = x.reshape(NPY, s2, NPX, s2, *rest)
    nd = len(rest)
    y = y.transpose(*range(4, 4 + nd), 1, 3, 0, 2)
    return y.reshape(*rest, s2, s2, N_P)


def _uncells(x, f):
    """(..., s2, s2, nP) -> (m, n, ...): the inverse of ``_cells``."""
    s2 = f // 2
    rest = x.shape[:-3]
    nd = len(rest)
    y = x.reshape(*rest, s2, s2, NPY, NPX)
    y = y.transpose(nd + 2, nd, nd + 3, nd + 1, *range(nd))
    return y.reshape(NPY * s2, NPX * s2, *rest)


def _frames(rng):
    return torch.as_tensor(rng.integers(0, 256, size=(1, H, W), dtype=np.uint8))


def _windows(rng, im2, r):
    by = torch.as_tensor(rng.integers(0, H - BS + 1, size=(1, N_P)), dtype=torch.int32)
    bx = torch.as_tensor(rng.integers(0, W - BS + 1, size=(1, N_P)), dtype=torch.int32)
    return gather.gather_windows(im2, by, bx, BS, r)


def _tt(im1, wins):
    """The TPU kernels' (bs, bs, nP) / (win, win, nP) int16 inputs."""
    p = im1[0].numpy().reshape(NPY, BS, NPX, BS).transpose(1, 3, 0, 2).reshape(BS, BS, -1)
    return jnp.asarray(p.astype(np.int16)), jnp.asarray(wins[0].numpy().transpose(1, 2, 0).astype(np.int16))


def _step_inputs(grid, pm, cur, ci, cj):
    """The pm colour-step kernels' common inputs for colour (ci, cj)."""
    f = BS // cur
    cands, rank, present, _ = step_candidates(grid, cur, H, W, ci, cj)
    color = COLORS.index((ci, cj))

    def by_color(x):
        out = np.zeros((4,) + x.shape, x.dtype)
        out[color] = x
        return jnp.asarray(out)

    gi = 2 * np.arange(f // 2)[:, None] + ci + f * np.arange(NPY)[None, :]  # (s2, npy)
    gj = 2 * np.arange(f // 2)[:, None] + cj + f * np.arange(NPX)[None, :]
    oy = np.broadcast_to((cur * gi)[:, :, None], (f // 2, NPY, NPX)).reshape(f // 2, N_P)
    ox = np.broadcast_to((cur * gj)[:, None, :], (f // 2, NPY, NPX)).reshape(f // 2, N_P)
    return dict(
        scalars=jnp.asarray([color, ci, cj, 0], jnp.int32),
        cands_pm=jnp.asarray(_cm(_cells(cands[0].numpy(), f)).astype(np.int32)),
        pm_lane=jnp.asarray(_cm(pm[0].numpy().transpose(2, 0, 1).reshape(2, N_P))),
        present_pm=by_color(_cm(_cells(present.numpy().astype(np.int32), f))),
        rank_pm=by_color(_cm(_cells(rank.numpy().astype(np.int32), f))),
        oy_cell=by_color(_cm(oy[:, None].astype(np.int32))),
        ox_cell=by_color(_cm(ox.astype(np.int32))),
    )


def _winners(out, f):
    """A kernel's (nch, 2, s2, s2, 128) winners as the (m, n, 2) colour cells."""
    return _uncells(_from_cm(out), f)


def _centres(rng):
    pm = torch.as_tensor(rng.integers(-6, 7, size=(1, NPY, NPX, 2)), dtype=torch.int32)
    rpm = pm + torch.as_tensor(rng.integers(-9, 10, size=pm.shape), dtype=torch.int32)
    return pm, rpm


# ------------------------------------------------- cv_fused steps (11, 12)

@pytest.mark.parametrize("rival", [False, True])
@pytest.mark.parametrize("cost,cur", [("sad", 2), ("ssd", 4)])
def test_fused_steps_match_kernel_interpret(rng, rival, cost, cur):
    # random candidates within +-(R + R2 + 3) of the main centres: in the
    # main window, rival only, in neither, and off the frame
    f = BS // cur
    im1 = _frames(rng)
    win = _windows(rng, _frames(rng), R)
    rwin = _windows(rng, _frames(rng), R2)
    pm, rpm = _centres(rng)
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = g0 + torch.as_tensor(rng.integers(-10, 11, size=g0.shape), dtype=torch.int32)
    patches_t, windows_t = _tt(im1, win)
    patches_pl, wslab = jfs.prep_slabs(patches_t, windows_t, BS, R, R)
    changed = False
    for ci, cj in COLORS:
        kin = _step_inputs(g0, pm, cur, ci, cj)
        g = g0.clone()
        if rival:
            rwslab = jfs.prep_slabs(patches_t, _tt(im1, rwin)[1], BS, R2, R2)[1]
            rpm_lane = jnp.asarray(_cm(rpm[0].numpy().transpose(2, 0, 1).reshape(2, N_P)))
            ref = jfs.windowed_color_step_pm_fused_rival(
                kin["scalars"], jnp.float32(3.0), patches_pl, wslab, rwslab, kin["cands_pm"],
                kin["pm_lane"], rpm_lane, kin["present_pm"], kin["rank_pm"], kin["oy_cell"],
                kin["ox_cell"], BS, R, R, R2, cur, cost, H, W, interpret=True,
            )
            rounds.color_step_fused_rival(g, pm, im1=im1, win=win, rwin=rwin, rpm=rpm,
                                              cur=cur, h=H, w=W, r=R, r2=R2, ci=ci, cj=cj,
                                              lam_mult=3.0, cost=cost)
        else:
            ref = jfs.windowed_color_step_pm_fused(
                kin["scalars"], jnp.float32(3.0), patches_pl, wslab, kin["cands_pm"],
                kin["pm_lane"], kin["present_pm"], kin["rank_pm"], kin["oy_cell"],
                kin["ox_cell"], BS, R, R, cur, cost, H, W, interpret=True,
            )
            rounds.color_step_fused(g, pm, im1=im1, win=win, cur=cur, h=H, w=W, r=R,
                                        ci=ci, cj=cj, lam_mult=3.0, cost=cost)
        np.testing.assert_array_equal(g[0, ci::2, cj::2].numpy(), _winners(ref, f))
        changed |= not torch.equal(g, g0)
    assert changed


def test_fused_steps_equal_dense_color_step(rng):
    # the same steps against D/D' (and 8/9) on the dense volumes of the
    # same windows: recomputing a cost gives the stored value
    cur, f = 2, BS // 2
    im1 = _frames(rng)
    win = _windows(rng, _frames(rng), R)
    rwin = _windows(rng, _frames(rng), R2)
    pm, rpm = _centres(rng)
    dense = cv_diff.pooled_cvs(im1, win, BS, R, "sad")[cur]
    rdense = cv_diff.pooled_cvs(im1, rwin, BS, R2, "sad")[cur]
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = g0 + torch.as_tensor(rng.integers(-10, 11, size=g0.shape), dtype=torch.int32)
    kw = dict(cur=cur, h=H, w=W, r=R, lam_mult=2.0)
    launches = (rounds.color_step_fused.launches, rounds.color_step_fused_rival.launches)
    for ci, cj in COLORS:
        for rival in (False, True):
            want, got = g0.clone(), g0.clone()
            if rival:
                rounds.color_step(want, dense, pm, ci=ci, cj=cj, rcv=rdense, rpm=rpm, r2=R2, **kw)
                rounds.color_step_fused_rival(got, pm, im1=im1, win=win, rwin=rwin, rpm=rpm,
                                                  r2=R2, ci=ci, cj=cj, cost="sad", **kw)
            else:
                rounds.color_step(want, dense, pm, ci=ci, cj=cj, **kw)
                rounds.color_step_fused(got, pm, im1=im1, win=win, ci=ci, cj=cj, cost="sad",
                                            **kw)
            assert torch.equal(got, want), (ci, cj, rival)
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (rounds.color_step_fused.launches,
            rounds.color_step_fused_rival.launches) == launches
    with pytest.raises(ValueError):  # rival windows of the wrong edge
        rounds.color_step_fused_rival(g0.clone(), pm, im1=im1, win=win, rwin=win, rpm=rpm,
                                          r2=R2, ci=0, cj=0, cost="sad", **kw)


# ---------------------------------------------- the volume and tables (13, 14)

def test_full_block_volume_matches_kernel_interpret(rng):
    im1 = _frames(rng)
    win = _windows(rng, _frames(rng), R)
    ref = np.asarray(jcv.full_block_volume(*_tt(im1, win), BS, R, R, "sad", interpret=True))
    got = cv_diff.full_block_volume(im1, win, BS, R, "sad")
    assert sorted(got) == [BS] and got[BS].dtype == cv_diff.cv_dtype(BS, "sad")
    side = 2 * R + 1
    want = ref.reshape(side * side, -1)[:, :N_P].reshape(side * side, NPY, NPX)
    np.testing.assert_array_equal(got[BS][0].numpy().astype(np.int64), want)
    assert torch.equal(got[BS], cv_diff.pooled_cvs(im1, win, BS, R, "sad")[BS])


def _slots(rng, k_slots, n_used):
    """One chunk's slot list: n_used distinct deltas among -1 slots."""
    side = 2 * R + 1
    keys = rng.choice(side * side, size=n_used, replace=False)
    sl = np.full((1, 1, k_slots, 2), -1, np.int32)
    at = np.sort(rng.choice(k_slots, size=n_used, replace=False))
    sl[0, 0, at] = np.stack([keys // side, keys % side], -1)
    return sl


def _table_pm(t, f):
    """A port table (K, nby, nbx) in the TPU layout (s2, 2, 2, nch, K, s2, 128)."""
    s2 = f // 2
    k = t.shape[0]
    y = t.reshape(k, NPY, s2, 2, NPX, s2, 2).transpose(2, 3, 6, 0, 5, 1, 4)
    return np.moveaxis(_cm(y.reshape(s2, 2, 2, k, s2, N_P)), 0, 3)


@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_compact_tables_match_kernel_interpret(rng, cost):
    im1 = _frames(rng)
    win = _windows(rng, _frames(rng), R)
    sl = _slots(rng, 6, 4)
    ref = jcv.compact_tables(*_tt(im1, win), jnp.asarray(sl[0]), BS, R, R, 6, cost,
                             interpret=True)
    got = cv_diff.compact_tables(im1, win, torch.as_tensor(sl), BS, R, cost)
    assert sorted(got) == sorted(ref) == cv_diff.table_curs(BS)
    dense = cv_diff.pooled_cvs(im1, win, BS, R, cost)
    side = 2 * R + 1
    for cur, t in got.items():
        assert t.dtype == cv_diff.cv_dtype(cur, cost)
        f = BS // cur
        np.testing.assert_array_equal(
            _table_pm(t[0].numpy().astype(np.int64), f)[..., :N_P],
            np.asarray(ref[cur]).astype(np.int64)[..., :N_P],
        )
        for k, (dy, dx) in enumerate(sl[0, 0]):  # slot k holds delta k's volume plane
            want = dense[cur][0, dy * side + dx] if dy >= 0 else torch.zeros_like(t[0, k])
            assert torch.equal(t[0, k], want), (cur, k)


@pytest.mark.parametrize("cur", [2, 4])
def test_compact_step_matches_kernel_interpret(rng, cur):
    # slot lists with -1 slots; candidates that miss every slot, among them
    # cells whose own MV misses (the incumbent-safety guard keeps it)
    f, k_slots = BS // cur, 6
    pm, _ = _centres(rng)
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = (g0 + torch.as_tensor(rng.integers(-2, 3, size=g0.shape), dtype=torch.int32)).contiguous()
    # the slots: four of the deltas the candidates use most, so some cells
    # are covered and some are not
    d = (g0 - pm.repeat_interleave(f, 1).repeat_interleave(f, 2) + R).reshape(-1, 2).numpy()
    keys, counts = np.unique(d[:, 1] * (2 * R + 1) + d[:, 0], return_counts=True)
    top = keys[np.argsort(-counts, kind="stable")[:4]]
    sl = np.full((1, 1, k_slots, 2), -1, np.int32)
    sl[0, 0, [0, 2, 3, 5]] = np.stack([top // (2 * R + 1), top % (2 * R + 1)], -1)
    table = torch.as_tensor(rng.integers(0, 9000, size=(1, k_slots, H // cur, W // cur)),
                            dtype=torch.uint16)
    for ci, cj in COLORS:
        kin = _step_inputs(g0, pm, cur, ci, cj)
        ref = jrs.windowed_color_step_pm_compact(
            kin["scalars"], jnp.asarray(sl[0]), jnp.float32(2.0),
            jnp.asarray(_table_pm(table[0].numpy(), f)), kin["cands_pm"], kin["pm_lane"],
            kin["present_pm"], kin["rank_pm"], kin["oy_cell"], kin["ox_cell"], k_slots, R,
            cur, H, W, interpret=True,
        )
        g = g0.clone()
        rounds.color_step_compact(g, table, pm, torch.as_tensor(sl), cur=cur, h=H, w=W, r=R,
                                    ci=ci, cj=cj, lam_mult=2.0)
        np.testing.assert_array_equal(g[0, ci::2, cj::2].numpy(), _winners(ref, f))
    # the guard held somewhere: a cell off every slot kept its MV although a
    # neighbour's MV was covered
    cands = step_candidates(g0, cur, H, W, 0, 0)[0][0]
    own = (cands[..., 0, :] - pm.repeat_interleave(f, 1).repeat_interleave(f, 2)[0, ::2, ::2]
           + R).numpy()
    missed = ~np.isin(own[..., 1] * (2 * R + 1) + own[..., 0], top)
    assert missed.any() and (~missed).any()


@pytest.mark.parametrize("cur", [2, 4])
def test_compact_round_matches_kernel_interpret(rng, cur):
    # a whole round of kernel 10 (2 sweeps x 4 colours, sweep s at lam *
    # (s + 1), lam = lam0 * bs / cur as rounds_loop doubles it) on the CPU
    # against JAX's interpret-mode step applied step by step on the grid it
    # updates; slot lists with -1 slots, candidates that miss every slot,
    # among them cells whose own MV misses (the incumbent-safety guard)
    f, k_slots, sweeps = BS // cur, 6, 2
    lam = 1.5 * (BS // cur)
    pm, _ = _centres(rng)
    pmf = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = (pmf + torch.as_tensor(rng.integers(-2, 3, size=pmf.shape), dtype=torch.int32)).contiguous()
    side = 2 * R + 1
    d = (g0 - pmf + R).reshape(-1, 2).numpy()
    keys, counts = np.unique(d[:, 1] * side + d[:, 0], return_counts=True)
    top = keys[np.argsort(-counts, kind="stable")[:4]]
    sl = np.full((1, 1, k_slots, 2), -1, np.int32)
    sl[0, 0, [0, 2, 3, 5]] = np.stack([top // side, top % side], -1)
    slots = torch.as_tensor(sl)
    table = torch.as_tensor(rng.integers(0, 9000, size=(1, k_slots, H // cur, W // cur)),
                            dtype=torch.uint16)
    own = (g0 - pmf + R)[0].numpy()
    missed = ~np.isin(own[..., 1] * side + own[..., 0], top)
    assert missed.any() and (~missed).any()
    want = g0.clone()
    for sweep in range(sweeps):
        for ci, cj in COLORS:
            kin = _step_inputs(want, pm, cur, ci, cj)
            ref = jrs.windowed_color_step_pm_compact(
                kin["scalars"], jnp.asarray(sl[0]), jnp.float32(lam * (sweep + 1)),
                jnp.asarray(_table_pm(table[0].numpy(), f)), kin["cands_pm"], kin["pm_lane"],
                kin["present_pm"], kin["rank_pm"], kin["oy_cell"], kin["ox_cell"], k_slots, R,
                cur, H, W, interpret=True,
            )
            want[0, ci::2, cj::2] = torch.as_tensor(np.array(_winners(ref, f)))
    assert not torch.equal(want, g0)
    launches = rounds.color_round_compact.launches
    smap = compact.slot_map(slots, R)
    for m in (None, smap):
        got = g0.clone()
        rounds.color_round_compact(got, table, pm, slots, cur=cur, h=H, w=W, r=R, lam=lam,
                                     sweeps=sweeps, smap=m)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert rounds.color_round_compact.launches == launches  # CPU tensors: no launch
    with pytest.raises(ValueError, match="smap"):  # a map of another radius
        rounds.color_round_compact(g0.clone(), table, pm, slots, cur=cur, h=H, w=W, r=R,
                                     lam=lam, sweeps=sweeps, smap=compact.slot_map(slots, R - 1))


# --------------------------------------------------------- ops/compact

def test_chunk_delta_slots_match_jax(rng):
    # 11 x 13 = 143 parents: two chunks, the second ragged; frame 0 has few
    # distinct deltas, frame 1 many (more than K in its first chunk)
    r, k_slots, ring = 6, 8, 2
    npy, npx = 11, 13
    base = rng.integers(-4, 5, size=(2, npy, npx, 2)).astype(np.int32)
    base[0] = (2, -1)  # one centre: frame 0's deltas are its 4 offsets
    win = np.empty_like(base)
    win[0] = base[0] + rng.integers(0, 2, size=(npy, npx, 2)) * 3
    win[1] = base[1] + rng.integers(-r - 2, r + 3, size=(npy, npx, 2))
    got = compact.chunk_delta_slots(torch.as_tensor(win), torch.as_tensor(base), r, k_slots, ring)
    frac = compact.overflow_fraction(torch.as_tensor(win), torch.as_tensor(base), r, k_slots, ring)
    assert tuple(got.shape) == (2, 2, k_slots, 2) and got.dtype == torch.int32
    for b in range(2):
        want = np.asarray(jcompact.chunk_delta_slots(jnp.asarray(win[b]), jnp.asarray(base[b]),
                                                     r, k_slots, ring))
        np.testing.assert_array_equal(got[b].numpy(), want)
        jf = float(jcompact.overflow_fraction(jnp.asarray(win[b]), jnp.asarray(base[b]), r,
                                              k_slots, ring))
        assert float(frac[b]) == jf
    assert float(frac[0]) == 0.0 and float(frac[1]) > 0.0
    assert (got[0] == -1).any() and not torch.equal(got[0], got[1])


@pytest.mark.parametrize("k_slots", [6, (2 * 4 + 1) ** 2])
def test_slot_map_inverts_the_slot_lists(rng, k_slots):
    # for every chunk and delta key, map[key] == k exactly when slots[k]
    # holds that key (else NO_SLOT): 11 x 13 parents (two chunks, the second
    # ragged) of B = 2 frames, K = 6 (chunks overflow) and K = side^2 (every
    # delta of the window has a slot), and one chunk with every slot unused
    r, ring, npy, npx = 4, 2, 11, 13
    side = 2 * r + 1
    base = rng.integers(-3, 4, size=(2, npy, npx, 2)).astype(np.int32)
    win = base + rng.integers(-r - 1, r + 2, size=base.shape).astype(np.int32)
    slots = compact.chunk_delta_slots(torch.as_tensor(win), torch.as_tensor(base), r, k_slots,
                                      ring)
    slots[1, 1] = -1
    got = compact.slot_map(slots, r)
    assert got.dtype == torch.uint16 and tuple(got.shape) == (2, 2, side * side)
    sl = slots.numpy()
    used = sl[..., 0] >= 0
    assert used.any() and (~used[0]).any() == (k_slots == side * side) and not used[1, 1].any()
    holds = ((sl[..., 0, None] * side + sl[..., 1, None] == np.arange(side * side))
             & used[..., None])  # (B, nch, K, side^2): slot k holds key
    at = got.numpy().astype(np.int64)[:, :, None, :] == np.arange(k_slots)[None, None, :, None]
    np.testing.assert_array_equal(at, holds)
    np.testing.assert_array_equal(got.numpy() == compact.NO_SLOT, ~holds.any(axis=2))


# ------------------- compact levels that exclude deltas the dense volumes hold

K_OVER = 4
LEVEL = dict(bs=8, ss=16, lam0=4.0, sweeps=2)


def _compact_pair():
    """A two-motion pair at 48x64 (48 parents: one chunk) with its
    prediction: more than K_OVER distinct deltas in the chunk."""
    rng = np.random.default_rng(77)
    h, w = 48, 64
    tex = synth.textured_image(h + 32, w + 32, rng)
    im2 = tex[16 : 16 + h, 16 : 16 + w]
    left = tex[16 + 2 : 16 + 2 + h, 16 + 5 : 16 + 5 + w]
    right = tex[16 - 3 : 16 - 3 + h, 16 - 4 : 16 - 4 + w]
    im1 = np.where(np.arange(w)[None, :] < w // 2, left, right).astype(np.uint8)
    pred = np.zeros((h // 8, w // 8, 2), np.float32)
    pred[:, : w // 16] = (4, 2)
    return im1[None], im2[None], pred[None]


def _multi_chunk_pair():
    """B = 2 pairs at 96x128 (12x16 parents: chunks of 128 and 64, more
    than 2 * ring + 1 = 7 parents each way) with their predictions: a
    two-motion pair predicted per half and a global shift predicted off by
    one pixel in a strip of parent columns."""
    rng = np.random.default_rng(78)
    h, w = 96, 128
    tex = synth.textured_image(h + 32, w + 32, rng)
    a2 = tex[16 : 16 + h, 16 : 16 + w]
    left = tex[16 + 2 : 16 + 2 + h, 16 + 3 : 16 + 3 + w]
    right = tex[16 - 1 : 16 - 1 + h, 16 - 4 : 16 - 4 + w]
    a1 = np.where(np.arange(w)[None, :] < 5 * w // 8, left, right).astype(np.uint8)
    tex = synth.textured_image(h + 32, w + 32, rng)
    b2 = tex[16 : 16 + h, 16 : 16 + w]
    b1 = tex[16 + 1 : 16 + 1 + h, 16 - 2 : 16 - 2 + w]
    pred = np.zeros((2, h // 8, w // 8, 2), np.float32)
    pred[0, :, : 5 * w // 64] = (3, 2)
    pred[0, :, 5 * w // 64 :] = (-4, -1)
    pred[1] = (-2, 1)
    pred[1, :, 6:9] = (-1, 1)
    return np.stack([a1, b1]), np.stack([a2, b2]), pred


PAIRS = {"one-chunk": _compact_pair, "multi-chunk": _multi_chunk_pair}


def _jax_compact_level(out_path: str, k_slots: int, ring: int, pair: str) -> None:
    """JAX's compact level in interpret mode, frame by frame -> out_path."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from blockbasedmotionestimation_tpu.ops.windowed import windowed_level

    im1, im2, pred = PAIRS[pair]()
    fn = jax.jit(lambda a, b, p: windowed_level(
        a, b, p, LEVEL["bs"], LEVEL["ss"], LEVEL["lam0"], LEVEL["sweeps"],
        impl="pallas_interpret", compact=k_slots, compact_ring=ring,
    ))
    np.save(out_path, np.stack([np.asarray(fn(*x)) for x in zip(im1, im2, pred)]))


def _compact_level_against_jax(tmp_path, monkeypatch, k_slots, ring, pair="one-chunk"):
    """The port's compact level, JAX's (in a subprocess) and the port's
    dense level on ``PAIRS[pair]``, plus each frame's overflow fraction."""
    from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

    out = str(tmp_path / "compact.npy")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out, str(k_slots), str(ring), pair], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    overflow = []

    def slots_and_overflow(grid0, base, r, k, rg):
        overflow.extend(compact.overflow_fraction(grid0, base, r, k, rg).tolist())
        return compact.chunk_delta_slots(grid0, base, r, k, rg)

    monkeypatch.setattr(tw, "chunk_delta_slots", slots_and_overflow)
    im1, im2, pred = (torch.as_tensor(x) for x in PAIRS[pair]())
    args = (im1, im2, pred, LEVEL["bs"], LEVEL["ss"], LEVEL["lam0"], LEVEL["sweeps"])
    got = tw.windowed_level(*args, compact=k_slots, compact_ring=ring)
    dense = tw.windowed_level(*args)
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return got, np.load(out), dense, overflow


def test_overflowing_compact_level_matches_jax_interpret(tmp_path, monkeypatch):
    got, want, dense, overflow = _compact_level_against_jax(tmp_path, monkeypatch, K_OVER, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert overflow[0] > 0
    assert (got != dense).any()  # K = 4 excludes deltas the dense volumes hold


def test_out_of_ring_compact_level_matches_jax_interpret(tmp_path, monkeypatch):
    # 6 x 8 parents with ring 0: no chunk overflows, but a winner adopted
    # from a neighbouring parent can have a delta from its new parent's
    # centre that is in no slot of the chunk; it is excluded, as in JAX
    got, want, dense, overflow = _compact_level_against_jax(tmp_path, monkeypatch, 8, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert overflow == [0.0]
    assert (got != dense).any()


def test_multi_chunk_compact_level_matches_jax_interpret(tmp_path, monkeypatch):
    # B = 2 frames of 12 x 16 parents: two chunks a frame (the slot lists
    # of parents near the chunk edge reach into the other chunk's winners),
    # ring 3 inside a grid wider than 7 parents each way, and K = 24 slots,
    # which no chunk fills: only the ring excludes
    got, want, dense, overflow = _compact_level_against_jax(
        tmp_path, monkeypatch, 24, 3, pair="multi-chunk")
    assert got.shape == (2, 96, 128, 2)
    assert overflow == [0.0, 0.0]
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), want[b], err_msg=f"frame {b}")


def test_xla_search_impl_runs_compact_as_jax_xla(rng):
    # search_impl="xla": the reference's XLA level ignores cv_compact, and
    # so does the port's engine; "auto" keeps the compact tables (K = 4
    # overflows on this pair, so the two differ)
    from blockbasedmotionestimation_tpu.ops.windowed import windowed_level as jax_level
    from blockbasedmotionestimation_tpu_torch import MotionConfig
    from blockbasedmotionestimation_tpu_torch.models import engine

    im1, im2, pred = _compact_pair()
    want = np.asarray(jax_level(
        jnp.asarray(im1[0]), jnp.asarray(im2[0]), jnp.asarray(pred[0]), LEVEL["bs"],
        LEVEL["ss"], LEVEL["lam0"], LEVEL["sweeps"], impl="xla", compact=K_OVER,
    ))
    cfg = MotionConfig(block_sizes=(LEVEL["bs"],), search_sizes=(LEVEL["ss"],),
                       interp_factor=1, sweeps_per_round=LEVEL["sweeps"],
                       lambda_scale=LEVEL["lam0"] / LEVEL["bs"], rival_window=False,
                       cv_compact=K_OVER, search_impl="xla")
    args = [torch.as_tensor(x) for x in (im1, im2, pred)] + [LEVEL["bs"], LEVEL["ss"]]
    got = engine._run_level(*args, cfg, 0)
    np.testing.assert_array_equal(got[0].numpy(), want)
    for impl in ("auto", "pallas"):
        compact_flow = engine._run_level(*args, cfg.replace(search_impl=impl), 0)
        assert (compact_flow != got).any(), impl


if __name__ == "__main__":
    _jax_compact_level(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
