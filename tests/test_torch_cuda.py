"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device.  Imports neither jax nor the conftest fixtures,
so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch import MotionConfig
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, reg_step
from blockbasedmotionestimation_tpu_torch.models import engine


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
def test_cuda_engine_equals_cpu(cuda):
    # odd coarse parent grid (5x7 at level 1), per-level rival radius
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=(2, 80, 112), dtype=np.uint8)
    b = np.roll(a, (3, -5), axis=(1, 2))
    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                       rival_radius=(4, None))
    for c in (cfg, cfg.replace(cost="ssd", rival_window=False)):
        on_gpu, _ = engine.estimate_flow_batched(a, b, c, device=cuda)
        on_cpu, _ = engine.estimate_flow_batched(a, b, c, device="cpu")
        assert torch.equal(on_gpu.cpu(), on_cpu)
