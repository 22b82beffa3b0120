"""The resample kernels (``csrc/resample.cu``) against their plain PyTorch
versions, on the card: ``resize_linear_u8`` (the driver's upscale) and
``pyrdown_u8`` (every pyramid level), bit for bit.

Skips without a CUDA device.  Imports neither jax nor the conftest fixtures,
so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_resample_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch import MotionConfig
from blockbasedmotionestimation_tpu_torch.kernels import resample as kres
from blockbasedmotionestimation_tpu_torch.models import engine
from blockbasedmotionestimation_tpu_torch.ops import resample
from blockbasedmotionestimation_tpu_torch.utils import profiling

KERNELS = {"resize_linear_u8": "resize_linear_kernel", "pyrdown_u8": "pyrdown_kernel"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


def _frames(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8), device=dev)


def _launched(fn) -> dict:
    """Kernels of ``csrc/resample.cu`` that ``fn()`` launched, by wrapper
    name, from the profiler's device trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {w: sum(1 for n in names if k in n) for w, k in KERNELS.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("factor", [1, 2, 3, 4])
@pytest.mark.parametrize("h,w", [(17, 23), (30, 40), (31, 9), (5, 61), (64, 96)])
def test_upscale_equals_plain(cuda, b, factor, h, w):
    # widths whose upscale is or is not a multiple of 16 (the vector and
    # the byte stores), odd source sizes
    img = _frames((b, h, w), 100 * h + w + factor, cuda)
    got = resample.resize_scale_u8(img, factor)
    want = kres.resize_linear_u8_plain(img, h * factor, w * factor)
    assert got.shape == want.shape == (b, h * factor, w * factor)
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("src,dst", [((17, 23), (68, 92)), ((20, 30), (40, 60)),
                                     ((31, 9), (45, 27)), ((48, 64), (20, 30)), ((7, 7), (7, 7))])
def test_resize_to_any_size_equals_plain(cuda, src, dst):
    # non-integer factors and a downscale: the tables, not the factor, drive
    # the kernel
    img = _frames((3,) + src, sum(src) + sum(dst), cuda)
    assert torch.equal(kres.resize_linear_u8(img, *dst), kres.resize_linear_u8_plain(img, *dst))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h,w", [(2, 2), (4, 4), (2, 6), (6, 10), (34, 50), (130, 258),
                                 (64, 96), (96, 160), (48, 32)])
def test_pyrdown_equals_plain(cuda, b, h, w):
    # 2x2 and 4x4 fold reflect-101 at both edges; widths that are not
    # multiples of 16 take the byte path, multiples of 16 the vector path
    img = _frames((b, h, w), 10 * h + w, cuda)
    got = kres.pyrdown_u8(img)
    assert got.shape == (b, h // 2, w // 2)
    assert torch.equal(got, kres.pyrdown_u8_plain(img))


@pytest.mark.requires_cuda
def test_layouts_equal_plain(cuda):
    """A single frame, extra leading dims and a strided view give what the
    plain versions give on the same tensors."""
    img = _frames((2, 3, 40, 64), 5, cuda)
    view = _frames((4, 40, 128), 6, cuda)[:, :, 32:96]
    for x in (img[0, 0], img, view):
        assert torch.equal(kres.pyrdown_u8(x), kres.pyrdown_u8_plain(x))
        assert torch.equal(kres.resize_linear_u8(x, 120, 200),
                           kres.resize_linear_u8_plain(x, 120, 200))


@pytest.mark.requires_cuda
def test_full_hd_driver_shapes_equal_plain(cuda):
    """The full-HD cell's shapes: 8 frames of 1080x1920 upscaled 4x to
    4320x7680, and the pyramid of 7680x4352 frames, level by level."""
    img = _frames((8, 1080, 1920), 21, cuda)
    up = resample.resize_scale_u8(img, 4)
    assert torch.equal(up, kres.resize_linear_u8_plain(img, 4320, 7680))
    padded = torch.nn.functional.pad(up, (0, 0, 16, 16))
    del up
    levels = resample.build_pyramid(padded, 4)
    assert [tuple(x.shape) for x in levels] == [(8, 4352 >> k, 7680 >> k) for k in range(4)]
    for fine, coarse in zip(levels, levels[1:]):
        for i in range(8):  # the plain path frame by frame (its int32 passes)
            assert torch.equal(coarse[i], kres.pyrdown_u8_plain(fine[i]))


@pytest.mark.requires_cuda
def test_launches_count_the_kernels_launched(cuda):
    """Each wrapper adds one to ``.launches`` a kernel it launched, as the
    profiler's trace counts them: the benchmark's launch check."""
    img = _frames((8, 60, 80), 7, cuda)
    resample.build_pyramid(resample.resize_scale_u8(img, 4), 4)  # the build, the tables
    torch.cuda.synchronize()
    before = {w: getattr(kres, w).launches for w in KERNELS}
    seen = _launched(lambda: resample.build_pyramid(resample.resize_scale_u8(img, 4), 4))
    counted = {w: getattr(kres, w).launches - before[w] for w in KERNELS}
    assert counted == seen == {"resize_linear_u8": 1, "pyrdown_u8": 3}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("interp", [1, 4])
def test_a_warmed_driver_call_takes_the_kernel_route(cuda, interp):
    """Every upscale and pyrDown of a warmed request on the card runs the
    kernel (``resample_by_route``), with no sync, and the pyramid reads no
    table there."""
    cfg = MotionConfig(interp_factor=interp)
    a = _frames((2, 128, 256), 8, cuda)
    b = torch.roll(a, (1, 2), dims=(1, 2))
    engine.estimate_flow_driver_batched(a, b, cfg)
    torch.cuda.synchronize()
    c0 = profiling.counters()
    engine.estimate_flow_driver_batched(a, b, cfg)
    c1 = profiling.counters()
    route = {k: v - c0["resample_by_route"].get(k, 0) for k, v in c1["resample_by_route"].items()}
    calls = (2 if interp > 1 else 0) + 2 * (cfg.num_levels - 1)
    assert {k: v for k, v in route.items() if v} == {"kernel": calls}
    assert c1["syncs"] == c0["syncs"]
    pyramid_hits = (c1["table_hits_by_site"].get("pyramid", 0)
                    - c0["table_hits_by_site"].get("pyramid", 0))
    assert pyramid_hits == 0
