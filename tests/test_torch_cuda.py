"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device.  Imports neither jax nor the conftest fixtures,
so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch import MotionConfig
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, fused_step, gather, reg_step, sad_search
from blockbasedmotionestimation_tpu_torch.models import engine
from blockbasedmotionestimation_tpu_torch.ops.regularize import Strips, on_strips
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ext,r2", [(8, 8, 4), (32, 16, 12), (4, 3, 1)])
def test_cuda_kernels_equal_plain(cuda, bs, ext, r2):
    rng = np.random.default_rng(bs)
    b, h, w = 2, 4 * bs, 6 * bs
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    im2 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    n_p = (h // bs) * (w // bs)
    by = torch.as_tensor(rng.integers(0, h - bs + 1, size=(b, n_p)), dtype=torch.int32, device=cuda)
    bx = torch.as_tensor(rng.integers(0, w - bs + 1, size=(b, n_p)), dtype=torch.int32, device=cuda)
    wins = gather.gather_windows(im2, by, bx, bs, ext)
    assert torch.equal(wins, gather.gather_windows_plain(im2, by, bx, bs, ext))
    for cost in ("sad", "ssd"):
        k = cv_diff.pooled_cvs(im1, wins, bs, ext, cost)
        p = cv_diff.pooled_cvs_plain(im1, wins, bs, ext, cost)
        for cur in k:
            assert k[cur].dtype == p[cur].dtype
            assert torch.equal(k[cur].to(torch.int32), p[cur].to(torch.int32)), (cost, cur)
    rw = gather.gather_windows(im2, by, bx, bs, r2)
    cvs = cv_diff.pooled_cvs(im1, wins, bs, ext, "sad")
    rcvs = cv_diff.pooled_cvs(im1, rw, bs, r2, "sad")
    pm = torch.as_tensor(rng.integers(-4, 5, size=(b, h // bs, w // bs, 2)), dtype=torch.int32, device=cuda)
    rpm = (pm + 2 * r2).contiguous()
    for cur in cvs:
        f = bs // cur
        g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
        g0 = g0 + torch.as_tensor(
            rng.integers(-ext - 2 * r2, ext + 2 * r2 + 1, size=g0.shape), dtype=torch.int32, device=cuda
        )
        for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
            for rival in (True, False):
                kw = dict(cur=cur, h=h, w=w, r=ext, ci=ci, cj=cj, lam_mult=3.0 * f)
                if rival:
                    kw.update(rcv=rcvs[cur], rpm=rpm, r2=r2)
                gk, gp = g0.clone().contiguous(), g0.clone().contiguous()
                reg_step.color_step(gk, cvs[cur], pm, **kw)
                reg_step.color_step_plain(gp, cvs[cur], pm, **kw)
                assert torch.equal(gk, gp), (cur, ci, cj, rival)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ext", [(2, 1), (4, 3), (4, 4), (8, 4), (8, 8), (8, 16), (32, 12),
                                    (32, 16)])
def test_cuda_gather_equals_plain(cuda, bs, ext):
    # kernel A at win 4, 10, 12, 16, 24, 40, 56 and 64 (every store width:
    # 16, 8 or 4 bytes, or bytes where win % 4 != 0), B=3, windows at every
    # corner and edge of the frame and at every column residue mod 16, on
    # frames whose rows start at every byte alignment (odd widths, and a
    # view at an offset of 0-3 bytes into its buffer)
    rng = np.random.default_rng(1000 + 100 * bs + ext)
    b, n = 3, 64
    for w_extra, off in ((0, 0), (1, 1), (3, 2), (5, 3)):
        h, w = 3 * bs + 5, 5 * bs + 16 + w_extra
        buf = torch.as_tensor(rng.integers(0, 256, size=off + b * h * w, dtype=np.uint8),
                              device=cuda)
        im2 = buf[off:].view(b, h, w)
        assert im2.is_contiguous() and im2.data_ptr() % 4 == off
        by = rng.integers(0, h - bs + 1, size=(b, n)).astype(np.int32)
        bx = rng.integers(0, w - bs + 1, size=(b, n)).astype(np.int32)
        ys, xs = (0, (h - bs) // 2, h - bs), (0, (w - bs) // 2, w - bs)
        edges = [(y, x) for y in ys for x in xs if (y, x) != (ys[1], xs[1])]
        by[0, :8], bx[0, :8] = zip(*edges)
        bx[1, :16] = 5 + np.arange(16)
        by, bx = (torch.as_tensor(a, device=cuda) for a in (by, bx))
        before = gather.gather_windows.launches
        got = gather.gather_windows(im2, by, bx, bs, ext)
        assert gather.gather_windows.launches == before + 1
        assert torch.equal(got, gather.gather_windows_plain(im2, by, bx, bs, ext)), (w, off)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r", [0, 1, 3, 12, 16])
@pytest.mark.parametrize("bs", [2, 4, 8, 16, 32, 64, 128])
def test_cuda_volume_kernel_equals_plain(cuda, bs, r):
    # B, C and 13 (one kernel, templated on bs) against pooled_cvs_plain:
    # sad and ssd, the band at store_r 0 and 4 and none, the emit sets of B
    # (every size), C (deep_curs) and 13 (cur = bs); 8x10 parents a frame,
    # so B's blocks of 4 parents leave a ragged last block in each row, and
    # at B=3, r >= 12 C's delta rows split into groups with a short last one
    # (bs 128: one parent a block, 4x5 parents a frame)
    rng = np.random.default_rng(100 * bs + r)
    npy, npx, wc = (4, 5, bs + 2 * r) if bs >= 128 else (8, 10, bs + 2 * r)
    emits = {"B": None, "C": cv_diff.deep_curs(bs, min(16, bs // 2)), "13": [bs]}
    for b in (1, 3):
        if 8 <= bs <= 64:
            assert cv_diff.volume_geometry(bs, r, b, npy, npx, True).parents_per_block == 4
        geo = cv_diff.volume_geometry(bs, r, b, npy, npx, False)
        if b == 3 and r >= 12:
            assert geo.groups * geo.dy_per_block > 2 * r + 1, geo
        im1 = torch.as_tensor(rng.integers(0, 256, size=(b, npy * bs, npx * bs), dtype=np.uint8),
                              device=cuda)
        win = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, wc, wc), dtype=np.uint8),
                              device=cuda)
        for cost in ("sad", "ssd"):
            for what, emit in emits.items():
                for store_r in (None, 0, 4):
                    if store_r is not None and (what != "B" or store_r > r):
                        continue
                    before = cv_diff.pooled_cvs.launches
                    k = cv_diff.pooled_cvs(im1, win, bs, r, cost, store_r=store_r, emit=emit)
                    assert cv_diff.pooled_cvs.launches == before + 1
                    p = cv_diff.pooled_cvs_plain(im1, win, bs, r, cost, store_r=store_r, emit=emit)
                    assert sorted(k) == sorted(p)
                    for cur in k:
                        assert k[cur].dtype == p[cur].dtype and k[cur].shape == p[cur].shape
                        assert torch.equal(k[cur].to(torch.int32), p[cur].to(torch.int32)), (
                            b, cost, what, store_r, cur)


@pytest.mark.requires_cuda
def test_cuda_volume_kernel_refuses_unbuilt_bs(cuda):
    # the kernel is built for bs 2 .. 128; a larger block raises, nothing falls back
    im1 = torch.zeros((1, 256, 256), dtype=torch.uint8, device=cuda)
    win = torch.zeros((1, 1, 258, 258), dtype=torch.uint8, device=cuda)
    before = cv_diff.pooled_cvs.launches
    with pytest.raises(RuntimeError, match="pooled_cvs"):
        cv_diff.pooled_cvs(im1, win, 256, 1, "sad")
    assert cv_diff.pooled_cvs.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ext,r2,store_r", [(8, 8, 4, 2), (32, 16, 12, 4), (16, 6, 6, 0)])
def test_cuda_hybrid_kernels_equal_plain(cuda, bs, ext, r2, store_r):
    # C, the stored band of B, E and F against their plain versions
    rng = np.random.default_rng(bs + store_r)
    b, h, w = 2, 4 * bs, 6 * bs
    npy, npx = h // bs, w // bs
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    im2 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)

    def offs():
        return torch.as_tensor(rng.integers(0, h - bs + 1, size=(b, npy * npx)), dtype=torch.int32,
                               device=cuda), torch.as_tensor(
            rng.integers(0, w - bs + 1, size=(b, npy * npx)), dtype=torch.int32, device=cuda)

    win = gather.gather_windows(im2, *offs(), bs, ext)
    rwin = gather.gather_windows(im2, *offs(), bs, r2)
    fuse_max = min(16, bs // 2)
    for cost in ("sad", "ssd"):
        k = cv_diff.deep_pooled_cvs(im1, rwin, bs, r2, cost, fuse_max)
        p = cv_diff.deep_pooled_cvs_plain(im1, rwin, bs, r2, cost, fuse_max)
        assert sorted(k) == sorted(p) == cv_diff.deep_curs(bs, fuse_max)
        for cur in k:
            assert k[cur].dtype == p[cur].dtype
            assert torch.equal(k[cur].to(torch.int32), p[cur].to(torch.int32)), (cost, cur)
        k = cv_diff.pooled_cvs(im1, win, bs, ext, cost, store_r=store_r)
        p = cv_diff.pooled_cvs_plain(im1, win, bs, ext, cost, store_r=store_r)
        for cur in k:
            assert k[cur].shape == p[cur].shape
            assert torch.equal(k[cur].to(torch.int32), p[cur].to(torch.int32)), (cost, cur)
        dense = cv_diff.pooled_cvs(im1, win, bs, ext, cost)
        pm = torch.as_tensor(rng.integers(-4, 5, size=(b, npy, npx, 2)), dtype=torch.int32, device=cuda)
        rpm = (pm + torch.as_tensor(rng.integers(-12, 13, size=pm.shape), dtype=torch.int32,
                                    device=cuda)).contiguous()
        for cur in [c for c in dense if c <= fuse_max]:
            f = bs // cur
            g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
            g0 = (g0 + torch.as_tensor(rng.integers(-20, 21, size=g0.shape), dtype=torch.int32,
                                       device=cuda)).contiguous()
            kw = dict(cur=cur, h=h, w=w, r=ext, r2=r2, lam_mult=3.0 * f, im1=im1, rwin=rwin,
                      rpm=rpm, cost=cost)
            for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
                gk, gp = g0.clone(), g0.clone()
                fused_step.color_step_hybrid(gk, dense[cur], pm, ci=ci, cj=cj, **kw)
                fused_step.color_step_hybrid_plain(gp, dense[cur], pm, ci=ci, cj=cj, **kw)
                assert torch.equal(gk, gp), ("E", cost, cur, ci, cj)
                if cur == 2:
                    gk, gp = g0.clone(), g0.clone()
                    fused_step.color_step_hybrid_tail(gk, k[2], pm, ci=ci, cj=cj, win=win,
                                                      store_r=store_r, **kw)
                    fused_step.color_step_hybrid_tail_plain(gp, k[2], pm, ci=ci, cj=cj, win=win,
                                                            store_r=store_r, **kw)
                    assert torch.equal(gk, gp), ("F", cost, ci, cj)


@pytest.mark.requires_cuda
def test_cuda_engine_equals_cpu(cuda):
    # odd coarse parent grid (5x7 at level 1), per-level rival radius
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=(2, 80, 112), dtype=np.uint8)
    b = np.roll(a, (3, -5), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                       rival_radius=(4, None))
    for c in (cfg, cfg.replace(cv_store_radius=None), cfg.replace(cost="ssd", rival_window=False)):
        on_gpu, _ = engine.estimate_flow_batched(a, b, c, device=cuda)
        on_cpu, _ = engine.estimate_flow_batched(a, b, c, device="cpu")
        assert torch.equal(on_gpu.cpu(), on_cpu)


def _at_offset(a: np.ndarray, off: int, cuda) -> torch.Tensor:
    """``a`` on the card as a contiguous view ``off`` bytes into its buffer."""
    buf = torch.empty(a.size + off, dtype=torch.uint8, device=cuda)
    view = buf[off:].view(a.shape)
    view.copy_(torch.as_tensor(a, device=cuda))
    return view


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ss", [(32, 64), (8, 24), (4, 12), (4, 10), (2, 6), (2, 8), (16, 48),
                                   (64, 96), (8, 20)])
def test_cuda_sad_spiral_argmin_equals_plain(cuda, bs, ss):
    # kernel 7 at bs 2..64 and windows of 6..96 bytes (win % 16 == 0, win %
    # 4 == 0 and neither), sad and ssd: centres near and past the frame's
    # edges mask offsets; blocks 0 and 1 have every offset masked (every
    # row, every column: they keep the centre); block 5 and its window are
    # constant, so every unmasked offset costs the same and the spiral rank
    # decides; frames and windows also at a 1-byte offset into their
    # buffers (the word and byte staging paths)
    rng = np.random.default_rng(100 * bs + ss)
    b, h, w = 2, 4 * bs, 6 * bs
    ext = spiral_extent(ss - bs)
    win, nblk = bs + 2 * ext, 24
    im1 = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)
    wins = rng.integers(0, 256, size=(b, nblk, win, win), dtype=np.uint8)
    im1[:, :bs, 5 * bs : 6 * bs] = 9
    wins[:, 5] = 9
    cy = rng.integers(-ext - 2, h - bs + ext + 3, size=(b, nblk)).astype(np.int32)
    cx = rng.integers(-ext - 2, w - bs + ext + 3, size=(b, nblk)).astype(np.int32)
    cy[:, 0] = -ext - 3
    cx[:, 1] = w - bs + ext + 3
    centres = [torch.as_tensor(a, device=cuda) for a in (cy, cx)]
    for off in (0, 1):
        args = [_at_offset(im1, off, cuda), _at_offset(wins, off, cuda)] + centres
        for cost in ("sad", "ssd"):
            before = sad_search.sad_spiral_argmin.launches
            got = sad_search.sad_spiral_argmin(*args, bs, ss, cost)
            assert sad_search.sad_spiral_argmin.launches == before + 1
            want = sad_search.sad_spiral_argmin_plain(*args, bs, ss, cost)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (cost, off)
            assert (got[0][:, :2] == ext).all() and (got[1][:, :2] == ext).all()


@pytest.mark.requires_cuda
def test_cuda_search_schedules_equal_cpu(cuda):
    # the configurations that search first (kernel 7), then regularize
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, size=(2, 80, 112), dtype=np.uint8)
    b = np.roll(a, (-2, 3), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                       rival_radius=(4, None))
    for c in (cfg.replace(regularizer="fourcolor"), cfg.replace(regularizer="jacobi", cost="ssd"),
              cfg.replace(window_center="search", reg_radius=3),
              cfg.replace(search_order="raster"),
              cfg.replace(regularizer="exact", block_sizes=(4, 4), search_sizes=(8, 8))):
        before = sad_search.sad_spiral_argmin.launches
        on_gpu, _ = engine.estimate_flow_batched(a, b, c, device=cuda)
        on_cpu, _ = engine.estimate_flow_batched(a, b, c, device="cpu")
        assert torch.equal(on_gpu.cpu(), on_cpu), c
        spiral = c.search_order == "spiral"
        assert sad_search.sad_spiral_argmin.launches == before + (2 if spiral else 0), c


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ext,r2", [(8, 8, 4), (32, 16, 12)])
def test_cuda_capacity_kernels_equal_plain(cuda, bs, ext, r2):
    # cv_fused's 11 and 12, cv_compact's 13, 14 and 10, against their plain
    # versions; slot lists with unused (-1) slots, candidates that miss
    # every slot (the incumbent guard included); 3 chunks, the last ragged
    from blockbasedmotionestimation_tpu_torch.ops import compact

    rng = np.random.default_rng(bs + 1)
    b, h, w = 2, 12 * bs, 28 * bs
    npy, npx = h // bs, w // bs
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    im2 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)

    def offs():
        return torch.as_tensor(rng.integers(0, h - bs + 1, size=(b, npy * npx)), dtype=torch.int32,
                               device=cuda), torch.as_tensor(
            rng.integers(0, w - bs + 1, size=(b, npy * npx)), dtype=torch.int32, device=cuda)

    win = gather.gather_windows(im2, *offs(), bs, ext)
    rwin = gather.gather_windows(im2, *offs(), bs, r2)
    pm = torch.as_tensor(rng.integers(-4, 5, size=(b, npy, npx, 2)), dtype=torch.int32, device=cuda)
    rpm = (pm + torch.as_tensor(rng.integers(-12, 13, size=pm.shape), dtype=torch.int32,
                                device=cuda)).contiguous()
    winners = (pm + torch.as_tensor(rng.integers(-3, 4, size=pm.shape), dtype=torch.int32,
                                    device=cuda)).contiguous()
    for cost in ("sad", "ssd"):
        k = cv_diff.full_block_volume(im1, win, bs, ext, cost)
        assert torch.equal(k[bs], cv_diff.full_block_volume_plain(im1, win, bs, ext, cost)[bs])
        for k_slots in (8, 64):
            slots = compact.chunk_delta_slots(winners, pm, ext, k_slots)
            assert slots.shape[1] == 3
            slots[:, :, 1::7] = -1  # unused slots among the used ones
            tk = cv_diff.compact_tables(im1, win, slots, bs, ext, cost)
            tp = cv_diff.compact_tables_plain(im1, win, slots, bs, ext, cost)
            smap = compact.slot_map(slots, ext)
            assert sorted(tk) == sorted(tp) == cv_diff.table_curs(bs)
            for cur in tk:
                assert tk[cur].dtype == tp[cur].dtype and torch.equal(tk[cur], tp[cur]), (cost, cur)
                f = bs // cur
                g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
                g0 = (g0 + torch.as_tensor(rng.integers(-4, 5, size=g0.shape), dtype=torch.int32,
                                           device=cuda)).contiguous()
                kw = dict(cur=cur, h=h, w=w, r=ext, lam_mult=3.0 * f)
                for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    gk, gp = g0.clone(), g0.clone()
                    reg_step.color_step_compact(gk, tk[cur], pm, slots, ci=ci, cj=cj, smap=smap,
                                                **kw)
                    reg_step.color_step_compact_plain(gp, tk[cur], pm, slots, ci=ci, cj=cj, **kw)
                    assert torch.equal(gk, gp), ("10", cost, k_slots, cur, ci, cj)
                    if k_slots == 8:
                        continue
                    g1 = (g0 + torch.as_tensor(rng.integers(-20, 21, size=g0.shape),
                                               dtype=torch.int32, device=cuda)).contiguous()
                    for rival in (False, True):
                        gk, gp = g1.clone(), g1.clone()
                        fkw = dict(im1=im1, win=win, cost=cost, ci=ci, cj=cj, **kw)
                        if rival:
                            fkw.update(rwin=rwin, rpm=rpm, r2=r2)
                            fused_step.color_step_fused_rival(gk, pm, **fkw)
                            fused_step.color_step_fused_rival_plain(gp, pm, **fkw)
                        else:
                            fused_step.color_step_fused(gk, pm, **fkw)
                            fused_step.color_step_fused_plain(gp, pm, **fkw)
                        assert torch.equal(gk, gp), ("11/12", rival, cost, cur, ci, cj)


def _compact_slots(rng, b, nch, k_slots, r, cuda):
    """(b, nch, K, 2) slot lists: distinct deltas of the (2r+1)^2 window a
    chunk (K = side^2: all of them, shuffled), every fifth slot and the
    whole last list of the last frame unused (-1)."""
    side = 2 * r + 1
    keys = np.stack([np.stack([rng.permutation(side * side)[:k_slots] for _ in range(nch)])
                     for _ in range(b)])
    sl = np.stack([keys // side, keys % side], -1).astype(np.int32)
    sl[:, :, 2::5] = -1
    sl[-1, -1] = -1
    return torch.as_tensor(sl, device=cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize(
    "bs,r,k_slots",
    [(4, 3, 8), (4, 2, "all"), (8, 4, 1), (8, 5, 64), (16, 7, "all"), (16, 8, 8),
     (32, 16, 64), (32, 3, "all"), (64, 9, 64), (64, 4, 1), (128, 5, 8), (128, 2, "all")],
)
def test_cuda_compact_tables_equal_plain(cuda, bs, r, k_slots):
    # kernel 14 against its plain version at every bs it is built for, ws =
    # bs + 2r a multiple of 4 or not (r odd), K = 1, 8, 64 and side^2 with
    # unused slots among the used ones; 11 x 13 parents a frame, so a
    # parent row straddles the two chunks (parents 117-129), the last chunk
    # is ragged (15 parents) and 13 is no multiple of a block's parents
    rng = np.random.default_rng(bs * 100 + r)
    b, npy, npx = 2, 11, 13
    h, w, ws = npy * bs, npx * bs, bs + 2 * r
    k_slots = (2 * r + 1) ** 2 if k_slots == "all" else k_slots
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    win = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, ws, ws), dtype=np.uint8),
                          device=cuda)
    slots = _compact_slots(rng, b, 2, k_slots, r, cuda)
    for cost in ("sad", "ssd"):
        before = cv_diff.compact_tables.launches
        tk = cv_diff.compact_tables(im1, win, slots, bs, r, cost)
        assert cv_diff.compact_tables.launches == before + 1
        tp = cv_diff.compact_tables_plain(im1, win, slots, bs, r, cost)
        assert sorted(tk) == sorted(tp) == cv_diff.table_curs(bs)
        for cur in tk:
            assert tk[cur].dtype == tp[cur].dtype == cv_diff.cv_dtype(cur, cost)
            assert torch.equal(tk[cur], tp[cur]), (cost, cur)
            assert not tk[cur][-1, :, -bs // cur:].to(torch.int32).any()  # the unused last list: zeros


@pytest.mark.requires_cuda
def test_cuda_compact_tables_refuse_unbuilt_bs(cuda):
    # kernel 14 is built for bs 4 .. 128; a larger block raises, nothing
    # falls back and no launch is counted
    im1 = torch.zeros((1, 256, 256), dtype=torch.uint8, device=cuda)
    win = torch.zeros((1, 1, 258, 258), dtype=torch.uint8, device=cuda)
    slots = torch.zeros((1, 1, 2, 2), dtype=torch.int32, device=cuda)
    before = cv_diff.compact_tables.launches
    with pytest.raises(RuntimeError, match="compact_tables"):
        cv_diff.compact_tables(im1, win, slots, 256, 1, "sad")
    assert cv_diff.compact_tables.launches == before


@pytest.mark.requires_cuda
def test_cuda_compact_level_equals_cpu(cuda):
    # one cv_compact=64 level at the slice's bs 32 and S 16, rival off, on
    # 13 x 16 parents (two chunks, the second ragged): CUDA == CPU
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, size=(2, 416, 512), dtype=np.uint8)
    b = np.roll(a, (3, -5), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(32,), search_sizes=(64,), interp_factor=1,
                       cv_compact=64, rival_window=False)
    before = cv_diff.compact_tables.launches
    on_gpu, _ = engine.estimate_flow_batched(a, b, cfg, device=cuda)
    assert cv_diff.compact_tables.launches == before + 1
    on_cpu, _ = engine.estimate_flow_batched(a, b, cfg, device="cpu")
    assert torch.equal(on_gpu.cpu(), on_cpu)


@pytest.mark.requires_cuda
def test_cuda_capacity_modes_equal_cpu(cuda):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=(2, 80, 112), dtype=np.uint8)
    b = np.roll(a, (2, -3), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                       rival_radius=(4, None))
    for c in (cfg.replace(cv_fused=4), cfg.replace(cv_fused=4, rival_window=False, cost="ssd"),
              cfg.replace(cv_compact=64, rival_window=False),
              cfg.replace(cv_compact=4, rival_window=False)):
        on_gpu, _ = engine.estimate_flow_batched(a, b, c, device=cuda)
        on_cpu, _ = engine.estimate_flow_batched(a, b, c, device="cpu")
        assert torch.equal(on_gpu.cpu(), on_cpu), c


def _round_inputs(cuda, rng, bs, cur, cost, spread=20):
    """E/F/11/12 inputs at bs on 4x6 parents, B=2: windows at random
    offsets, the dense main volume at cur, its band at store_r 3 (any cur:
    the band is a slice of the dense volume), rival centres within +-12 of
    the main ones and candidates within +-spread of them."""
    b, h, w, r, r2, store_r = 2, 4 * bs, 6 * bs, 16, 12, 3
    npy, npx = h // bs, w // bs
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    im2 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)

    def offs():
        return (torch.as_tensor(rng.integers(0, h - bs + 1, size=(b, npy * npx)),
                                dtype=torch.int32, device=cuda),
                torch.as_tensor(rng.integers(0, w - bs + 1, size=(b, npy * npx)),
                                dtype=torch.int32, device=cuda))

    win = gather.gather_windows(im2, *offs(), bs, r)
    rwin = gather.gather_windows(im2, *offs(), bs, r2)
    dense = cv_diff.pooled_cvs(im1, win, bs, r, cost, emit=[cur])[cur]
    side, nby, nbx = 2 * r + 1, h // cur, w // cur
    band = dense.reshape(b, side, side, nby, nbx)[:, :, r - store_r:r + store_r + 1]
    band = band.reshape(b, side * (2 * store_r + 1), nby, nbx).contiguous()
    pm = torch.as_tensor(rng.integers(-4, 5, size=(b, npy, npx, 2)), dtype=torch.int32,
                         device=cuda)
    rpm = (pm + torch.as_tensor(rng.integers(-12, 13, size=pm.shape), dtype=torch.int32,
                                device=cuda)).contiguous()
    f = bs // cur
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = (g0 + torch.as_tensor(rng.integers(-spread, spread + 1, size=g0.shape),
                               dtype=torch.int32, device=cuda)).contiguous()
    common = dict(im1=im1, cur=cur, h=h, w=w, r=r, cost=cost)
    forms = {
        "E": (fused_step.color_round_hybrid, fused_step.color_step_hybrid_plain, (dense, pm),
              dict(common, rwin=rwin, rpm=rpm, r2=r2)),
        "F": (fused_step.color_round_hybrid_tail, fused_step.color_step_hybrid_tail_plain,
              (band, pm), dict(common, win=win, rwin=rwin, rpm=rpm, r2=r2, store_r=store_r)),
        "11": (fused_step.color_round_fused, fused_step.color_step_fused_plain, (pm,),
               dict(common, win=win)),
        "12": (fused_step.color_round_fused_rival, fused_step.color_step_fused_rival_plain, (pm,),
               dict(common, win=win, rwin=rwin, rpm=rpm, r2=r2)),
    }
    return g0, forms


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("cur", [2, 4, 16])
@pytest.mark.parametrize("form", ["E", "F", "11", "12"])
def test_cuda_round_kernel_equals_plain_step_loop(cuda, form, cur, cost):
    # one cooperative launch per round, grid barriers between its colour
    # steps, against the plain steps one by one: sweeps 1, 2 and 3, B=2,
    # bs 32 (so cur 16 has 2x2 cells a parent), candidates within +-20
    rng = np.random.default_rng(1000 * cur + len(form) + (cost == "ssd"))
    g0, forms = _round_inputs(cuda, rng, 32, cur, cost)
    wrapper, step_plain, args, kw = forms[form]
    lam = 1.5 * 32 / cur
    for sweeps in (1, 2, 3):
        gk, gp = g0.clone(), g0.clone()
        before = wrapper.launches
        wrapper(gk, *args, lam=lam, sweeps=sweeps, **kw)
        assert wrapper.launches == before + 1
        for mult in fused_step.sweep_lams(lam, sweeps):
            for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
                step_plain(gp, *args, ci=ci, cj=cj, lam_mult=mult, **kw)
        assert not torch.equal(gp, g0)
        assert torch.equal(gk, gp), (form, cur, cost, sweeps)


@pytest.mark.requires_cuda
def test_cuda_round_kernel_splits_long_rounds(cuda):
    # more sweeps than one launch's argument struct holds: two launches,
    # the same steps in the same order
    rng = np.random.default_rng(9)
    g0, forms = _round_inputs(cuda, rng, 32, 4, "sad", spread=6)
    wrapper, step_plain, args, kw = forms["E"]
    sweeps = fused_step.MAX_SWEEPS + 1
    gk, gp = g0.clone(), g0.clone()
    before = wrapper.launches
    wrapper(gk, *args, lam=2.0, sweeps=sweeps, **kw)
    assert wrapper.launches == before + 2
    fused_step.color_round_hybrid_plain(gp, *args, lam=2.0, sweeps=sweeps, **kw)
    assert torch.equal(gk, gp)


@pytest.mark.requires_cuda
def test_cuda_bs128_engine_equals_cpu(cuda):
    # bs 128 end to end on the card (the volume kernel's bs-128 instance, D
    # at cur 128/64/32, E at 16/8/4, F at 2) against the plain path
    rng = np.random.default_rng(128)
    a = rng.integers(0, 256, size=(2, 256, 384), dtype=np.uint8)
    b = np.roll(a, (5, -9), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(128,), search_sizes=(160,), interp_factor=1,
                       rival_radius=8)
    assert not engine.cuda_refusals(cfg)
    before = (cv_diff.pooled_cvs.launches, fused_step.color_round_hybrid.launches)
    on_gpu, _ = engine.estimate_flow_batched(a, b, cfg, device=cuda)
    assert (cv_diff.pooled_cvs.launches - before[0],
            fused_step.color_round_hybrid.launches - before[1]) == (1, 3)
    on_cpu, _ = engine.estimate_flow_batched(a, b, cfg, device="cpu")
    assert torch.equal(on_gpu.cpu(), on_cpu)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths", ["u16,i32", "i32,u16", "u16,u16", "i32,i32"])
@pytest.mark.parametrize("cur", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("form", ["D", "D'", "8", "9"])
def test_cuda_stored_round_equals_plain_step_loop(cuda, form, cur, widths):
    # the stored form of the round kernel (D, D', 8, 9) against the plain
    # steps one by one: f = 1 (D, 8) and f = 2 (D', 9) on 20x70 parents, B=2
    # (several tiles a colour), main and rival volumes of the given widths
    # (random costs, up to 2^24 in i32), rival centres within +-12 of the
    # main ones and candidates within +-20 of them; sweeps 1, 2, 3 in one
    # launch and MAX_SWEEPS + 1 in two; and one colour step (a span of one)
    gen = torch.Generator(device=cuda).manual_seed(100 * cur + len(form) + len(widths))
    b, npy, npx, r, r2 = 2, 20, 70, 7, 5
    f = 1 if form in ("D", "8") else 2
    nby, nbx = npy * f, npx * f
    h, w = nby * cur, nbx * cur

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda, dtype=torch.int64).to(dtype)

    def volume(side, width):
        if width == "u16":
            return ints(0, 2**16, (b, side * side, nby, nbx), torch.uint16)
        return ints(0, 2**24, (b, side * side, nby, nbx))

    cv_w, rcv_w = widths.split(",")
    cv = volume(2 * r + 1, cv_w)
    pm = ints(-4, 5, (b, npy, npx, 2))
    kw = dict(cur=cur, h=h, w=w, r=r)
    if form in ("D", "D'"):
        rpm = (pm + ints(-12, 13, pm.shape)).contiguous()
        kw.update(rcv=volume(2 * r2 + 1, rcv_w), rpm=rpm, r2=r2)
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = (g0 + ints(-20, 21, g0.shape)).contiguous()
    lam = 1.5 * 32 / cur
    rows = reg_step.color_round_stored.row_launches
    for sweeps in (1, 2, 3, fused_step.MAX_SWEEPS + 1):
        gk, gp = g0.clone(), g0.clone()
        before = (reg_step.color_round_stored.launches, rows[form])
        reg_step.color_round_stored(gk, cv, pm, lam=lam, sweeps=sweeps, **kw)
        n = len(fused_step._spans(sweeps))
        assert (reg_step.color_round_stored.launches, rows[form]) == (before[0] + n, before[1] + n)
        reg_step.color_round_stored_plain(gp, cv, pm, lam=lam, sweeps=sweeps, **kw)
        assert not torch.equal(gp, g0)
        assert torch.equal(gk, gp), (form, cur, widths, sweeps)
    gk, gp = g0.clone(), g0.clone()
    before = reg_step.color_step.row_launches[form]
    reg_step.color_step(gk, cv, pm, ci=1, cj=0, lam_mult=lam, **kw)
    assert reg_step.color_step.row_launches[form] == before + 1
    reg_step.color_step_plain(gp, cv, pm, ci=1, cj=0, lam_mult=lam, **kw)
    assert torch.equal(gk, gp)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("width", ["u16", "i32"])
@pytest.mark.parametrize("k_slots", [6, 64, "side^2"])
@pytest.mark.parametrize("cur", [2, 4, 8, 16])
def test_cuda_compact_round_equals_plain_step_loop(cuda, cur, k_slots, width):
    # kernel 10, the round kernel's compact form (each candidate's slot
    # looked up in ops.compact.slot_map), against the plain steps (the slot
    # compares) one by one: B=2 frames of 13x40 parents at f = 2 (5 chunks
    # a frame, the last ragged; a 26x80 grid, so the tiles of a colour are
    # ragged both ways), candidates within +-2 of the centres, slot lists
    # of each chunk drawn from the more frequent candidate deltas (some
    # missing in each chunk, so some candidates miss every slot, own MVs
    # among them) at random slots, a fifth of the slots unused (-1), K = 6,
    # 64 and side^2; random tables (u16, or i32 up to 2^24); sweeps 1, 2, 3
    # in one launch and MAX_SWEEPS + 1 in two; and one colour step (a span
    # of one, its map built inside)
    from blockbasedmotionestimation_tpu_torch.ops import compact

    seed = 1000 * cur + len(str(k_slots)) + len(width)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rng = np.random.default_rng(seed)
    b, npy, npx, r, f = 2, 13, 40, 7, 2
    side = 2 * r + 1
    k = side * side if k_slots == "side^2" else k_slots
    nby, nbx = npy * f, npx * f
    h, w = nby * cur, nbx * cur

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda, dtype=torch.int64).to(dtype)

    pm = ints(-4, 5, (b, npy, npx, 2))
    pmf = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = (pmf + ints(-2, 3, pmf.shape)).contiguous()
    d = (g0 - pmf + r).reshape(-1, 2).cpu().numpy()
    keys, counts = np.unique(d[:, 1] * side + d[:, 0], return_counts=True)
    pref = list(keys[np.argsort(-counts, kind="stable")])
    pref += list(rng.permutation(np.setdiff1d(np.arange(side * side), keys)))
    nch = -(-npy * npx // compact.CHUNK)
    n_used = k - max(1, k // 5)
    sl = np.full((b, nch, k, 2), -1, np.int32)
    for bi in range(b):
        for c in range(nch):
            chosen = rng.choice(np.array(pref[:n_used + 3]), size=n_used, replace=False)
            at = rng.choice(k, size=n_used, replace=False)
            sl[bi, c, at] = np.stack([chosen // side, chosen % side], -1)
    slots = torch.as_tensor(sl, device=cuda)
    if width == "u16":
        table = ints(0, 2**16, (b, k, nby, nbx), torch.uint16)
    else:
        table = ints(0, 2**24, (b, k, nby, nbx))
    smap = compact.slot_map(slots, r)
    kw = dict(cur=cur, h=h, w=w, r=r)
    lam = 1.5 * 32 / cur
    for sweeps in (1, 2, 3, fused_step.MAX_SWEEPS + 1):
        gk, gp = g0.clone(), g0.clone()
        before = reg_step.color_round_compact.launches
        reg_step.color_round_compact(gk, table, pm, slots, lam=lam, sweeps=sweeps, smap=smap, **kw)
        n = len(fused_step._spans(sweeps))
        assert reg_step.color_round_compact.launches == before + n
        reg_step.color_round_compact_plain(gp, table, pm, slots, lam=lam, sweeps=sweeps, **kw)
        assert not torch.equal(gp, g0)
        assert torch.equal(gk, gp), (cur, k, width, sweeps)
    gk, gp = g0.clone(), g0.clone()
    before = reg_step.color_step_compact.launches
    reg_step.color_step_compact(gk, table, pm, slots, ci=1, cj=0, lam_mult=lam, smap=smap, **kw)
    assert reg_step.color_step_compact.launches == before + 1
    reg_step.color_step_compact_plain(gp, table, pm, slots, ci=1, cj=0, lam_mult=lam, **kw)
    assert torch.equal(gk, gp)
    # on the card the map is required: no launch without it
    with pytest.raises(ValueError, match="smap"):
        reg_step.color_step_compact(gk, table, pm, slots, ci=1, cj=0, lam_mult=lam, **kw)
    with pytest.raises(ValueError, match="smap"):
        reg_step.color_round_compact(gk, table, pm, slots, lam=lam, sweeps=1, **kw)
    assert reg_step.color_step_compact.launches == before + 1


# ------------------------------------------------------------------ zsad

def _zsad_pair(h=256, w=384):
    """A two-motion pair (halves moved by (7, -3) and (-12, 5)), frame 1
    through a gain of 1.1 and an offset of 12."""
    rng = np.random.default_rng(21)
    tex = rng.integers(0, 256, size=(h + 64, w + 64), dtype=np.uint8)
    a2 = tex[32:32 + h, 32:32 + w]
    left = tex[32 - 3:32 - 3 + h, 32 + 7:32 + 7 + w]
    right = tex[32 + 5:32 + 5 + h, 32 - 12:32 - 12 + w]
    a1 = np.where(np.arange(w)[None, :] < w // 2, left, right).astype(np.float64)
    a1 = np.clip(np.rint(a1 * 1.1 + 12), 0, 255).astype(np.uint8)
    return a1[None], a2[None]


def _kernel_launches():
    fns = [cv_diff.pooled_cvs, cv_diff.deep_pooled_cvs, cv_diff.full_block_volume,
           cv_diff.compact_tables, sad_search.sad_spiral_argmin, reg_step.color_step,
           reg_step.color_round_stored, reg_step.color_step_compact,
           reg_step.color_round_compact, fused_step.color_step_hybrid,
           fused_step.color_step_hybrid_tail, fused_step.color_round_hybrid,
           fused_step.color_round_hybrid_tail, fused_step.color_step_fused,
           fused_step.color_step_fused_rival, fused_step.color_round_fused,
           fused_step.color_round_fused_rival]
    return {f.__name__: f.launches for f in fns}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("override", [dict(), dict(regularizer="fourcolor"),
                                      dict(window_center="search")],
                         ids=["default", "fourcolor", "search"])
def test_cuda_zsad_equals_cpu_and_launches_only_the_gather(cuda, override):
    # zsad has no kernel: on the card only the gathers (A) launch one, and
    # the flow equals the CPU's (exact: f32 elementwise adds in a fixed
    # order round alike on both)
    cfg = MotionConfig(interp_factor=1, cost="zsad", **override)
    im1, im2 = _zsad_pair()
    before, gathers = _kernel_launches(), gather.gather_windows.launches
    on_gpu, _ = engine.estimate_flow_batched(im1, im2, cfg, device=cuda)
    assert _kernel_launches() == before
    assert gather.gather_windows.launches > gathers
    on_cpu, _ = engine.estimate_flow_batched(im1, im2, cfg, device="cpu")
    assert torch.equal(on_gpu.cpu(), on_cpu)


@pytest.mark.requires_cuda
def test_cuda_color_round_stored_refuses_f32(cuda):
    grid = torch.zeros((1, 8, 8, 2), dtype=torch.int32, device=cuda)
    pm = torch.zeros((1, 2, 2, 2), dtype=torch.int32, device=cuda)
    vol = torch.zeros((1, 25, 8, 8), dtype=torch.float32, device=cuda)
    before = reg_step.color_round_stored.launches
    with pytest.raises(ValueError, match="uint16/int32"):
        reg_step.color_round_stored(grid, vol, pm, cur=2, h=16, w=16, r=2, lam=1.0, sweeps=1)
    assert reg_step.color_round_stored.launches == before


@pytest.mark.requires_cuda
def test_cuda_run_sequence_equals_cpu(cuda, tmp_path):
    from blockbasedmotionestimation_tpu_torch.models import sequence

    rng = np.random.default_rng(22)
    base = rng.integers(0, 256, size=(256 + 32, 384 + 32), dtype=np.uint8)
    frames = [base[16 - k:16 - k + 256, 16 + 2 * k:16 + 2 * k + 384].copy() for k in range(4)]
    cfg = MotionConfig(interp_factor=1)
    for where, kw in (("gpu", dict(device=cuda)), ("cpu", dict(device="cpu"))):
        sequence.run_sequence(frames, tmp_path / where, cfg, batch_size=2, **kw)
    for i in range(3):
        name = sequence.flo_name(i)
        assert (tmp_path / "gpu" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()


def _strips(cuda, gen, b, t, nby, nbx, cur, first=0):
    """Strips of b frames (entry k * t + i is strip i of frame k, whose
    first grid row is first + i * nby, in a frame one row taller than the
    strips reach), with random ghost rows."""
    row0_b = (first + torch.arange(b * t, device=cuda) % t * nby).to(torch.int32)
    ghost = torch.randint(-30, 31, (b * t, 2, nbx, 2), generator=gen, device=cuda,
                          dtype=torch.int64).to(torch.int32)
    return Strips(row0_b, (first + t * nby + 1) * cur, ghost)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cur", [2, 4, 16])
@pytest.mark.parametrize("form", ["D", "D'", "8", "9", "E", "F", "11", "12"])
def test_cuda_round_kernel_on_strips_equals_plain(cuda, form, cur):
    # one colour step of each form on row strips (a span of one launch with
    # row0_b and ghost rows): 3 strips of 2 frames, each strip an odd number
    # of grid rows at f = 1 (every other strip starts on an odd frame row),
    # random ghost rows, against the plain step on the same CUDA tensors
    # under on_strips; each of the four frame colours, sad and ssd
    gen = torch.Generator(device=cuda).manual_seed(7 * cur + len(form))
    rng = np.random.default_rng(31 * cur + len(form))
    if form in ("D", "D'", "8", "9"):
        b, npy, npx, r, r2 = 6, 3, 40, 7, 5
        f = 1 if form in ("D", "8") else 2
        nby, nbx = npy * f, npx * f
        h, w = nby * cur, nbx * cur

        def ints(lo, hi, shape, dtype=torch.int32):
            return torch.randint(lo, hi, shape, generator=gen, device=cuda,
                                 dtype=torch.int64).to(dtype)

        cv = ints(0, 2**16, (b, (2 * r + 1) ** 2, nby, nbx), torch.uint16)
        pm = ints(-4, 5, (b, npy, npx, 2))
        kw = dict(cur=cur, h=h, w=w, r=r)
        if form in ("D", "D'"):
            kw.update(rcv=ints(0, 2**24, (b, (2 * r2 + 1) ** 2, nby, nbx)),
                      rpm=(pm + ints(-12, 13, pm.shape)).contiguous(), r2=r2)
        g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
        g0 = (g0 + ints(-20, 21, g0.shape)).contiguous()
        wrapper, step_plain, args = reg_step.color_step, reg_step.color_step_plain, (cv, pm)
        costs = ("sad",)
    else:
        costs = ("sad", "ssd")
    for cost in costs:
        if form not in ("D", "D'", "8", "9"):
            g0, forms = _round_inputs(cuda, rng, 32, cur, cost)
            round_fn, step_plain, args, kw = forms[form]
            wrapper = round_fn.step
            nby, nbx = g0.shape[1:3]
            # the two entries as strips starting on odd frame rows
            strips = _strips(cuda, gen, 1, 2, nby, nbx, cur, first=1)
        else:
            strips = _strips(cuda, gen, 2, 3, nby, nbx, cur)
        for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
            gk, gp = g0.clone(), g0.clone()
            before = wrapper.launches
            wrapper(gk, *args, ci=ci, cj=cj, lam_mult=2.5, strips=strips, **kw)
            assert wrapper.launches == before + 1
            on_strips(step_plain, gp, *args, ci=ci, cj=cj, lam_mult=2.5, strips=strips, **kw)
            assert not torch.equal(gp, g0)
            assert torch.equal(gk, gp), (form, cur, cost, ci, cj)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,ss", [(32, 64), (8, 24), (4, 12)])
def test_cuda_sad_spiral_argmin_on_strips_equals_plain(cuda, bs, ss):
    # kernel 7 on a row strip: blocks from the strip, centres and the
    # in-frame test in the frame's rows (full_h three strips high), centres
    # near and past the frame's top and bottom
    rng = np.random.default_rng(7 * bs + ss)
    b, h, w = 2, 3 * bs, 6 * bs
    full_h = 3 * h
    ext = spiral_extent(ss - bs)
    win, nblk = bs + 2 * ext, 18
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=cuda)
    wins = torch.as_tensor(rng.integers(0, 256, size=(b, nblk, win, win), dtype=np.uint8),
                           device=cuda)
    cy = rng.integers(-ext - 2, full_h - bs + ext + 3, size=(b, nblk)).astype(np.int32)
    cy[:, :3] = full_h - bs - rng.integers(0, ext + 1, size=3)  # the frame's bottom rows
    cx = rng.integers(0, w - bs + 1, size=(b, nblk)).astype(np.int32)
    args = [im1, wins, torch.as_tensor(cy, device=cuda), torch.as_tensor(cx, device=cuda)]
    for cost in ("sad", "ssd"):
        got = sad_search.sad_spiral_argmin(*args, bs, ss, cost, full_h)
        want = sad_search.sad_spiral_argmin_plain(*args, bs, ss, cost, full_h)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), cost
        whole = sad_search.sad_spiral_argmin_plain(*args, bs, ss, cost)
        assert not torch.equal(whole[0], want[0])  # the strip's own height masks other rows


@pytest.mark.requires_cuda
@pytest.mark.parametrize("override", [dict(), dict(regularizer="fourcolor"),
                                      dict(window_center="search"), dict(cv_fused=4)])
def test_cuda_row_tiled_equals_untiled(cuda, override):
    # the in-process row tiling on the card (every round a launch a step,
    # ghost rows between steps) equals the untiled engine, and the CPU
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1, mv_cap=16,
                       **override)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, size=(2, 288, 128), dtype=np.uint8)
    im1, im2 = base[:, :256, :96].copy(), base[:, 3:259, 5:101].copy()
    mesh = tiled.Mesh((1, 2))
    plan = tiled.plan_tiling(cfg, 256, 96, 2)
    assert [e["rows_ok"] for e in plan] == [True, True]
    got = tiled.estimate_flow_padded_batch_tiled(im1, im2, cfg, mesh, device=cuda)
    want = engine.estimate_flow_padded(torch.as_tensor(im1, device=cuda),
                                       torch.as_tensor(im2, device=cuda), cfg)
    assert torch.equal(got, want)
    cpu = tiled.estimate_flow_padded_batch_tiled(im1, im2, cfg, mesh, device="cpu")
    assert torch.equal(got.cpu(), cpu)
