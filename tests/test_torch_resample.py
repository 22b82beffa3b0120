"""The resample wrappers of ``kernels/resample.py`` on the CPU: they route
to their plain versions, refuse what those refuse, count the route in
``utils.profiling`` (``resample_by_route``) and read the tables the plain
versions read.  The kernels themselves: ``tests/test_torch_resample_cuda.py``
on the card.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import tracing  # noqa: E402
from blockbasedmotionestimation_tpu_torch import MotionConfig  # noqa: E402
from blockbasedmotionestimation_tpu_torch.kernels import resample as kres  # noqa: E402
from blockbasedmotionestimation_tpu_torch.models import engine  # noqa: E402
from blockbasedmotionestimation_tpu_torch.ops import resample  # noqa: E402
from blockbasedmotionestimation_tpu_torch.utils import profiling  # noqa: E402

SMALL = dict(block_sizes=(8, 8, 8, 8), search_sizes=(16, 16, 16, 16),
             rival_radius=(2, None, 2, 2))
U8 = np.zeros((2, 8, 12), np.uint8)


def _diff(c0: dict, c1: dict, by: str) -> dict:
    got = {k: v - c0[by].get(k, 0) for k, v in c1[by].items()}
    return {k: v for k, v in got.items() if v}


def _error(fn, *args) -> str | None:
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


BAD_PYRDOWN = {
    "float": torch.zeros((8, 12), dtype=torch.float32),
    "int32": torch.zeros((2, 8, 12), dtype=torch.int32),
    "one dim": torch.zeros((12,), dtype=torch.uint8),
    "odd height": torch.zeros((2, 7, 12), dtype=torch.uint8),
    "odd width": torch.zeros((2, 8, 13), dtype=torch.uint8),
    "empty": torch.zeros((2, 0, 0), dtype=torch.uint8),
}
BAD_RESIZE = {
    "float": (torch.zeros((8, 12), dtype=torch.float32), 16, 24),
    "bool": (torch.zeros((8, 12), dtype=torch.bool), 16, 24),
    "one dim": (torch.zeros((12,), dtype=torch.uint8), 16, 24),
    "no rows out": (torch.as_tensor(U8), 0, 24),
    "no columns out": (torch.as_tensor(U8), 16, -1),
    "empty frame": (torch.zeros((2, 0, 12), dtype=torch.uint8), 16, 24),
}


@pytest.mark.parametrize("name", list(BAD_PYRDOWN))
def test_pyrdown_wrapper_refuses_what_plain_refuses(name):
    x = BAD_PYRDOWN[name]
    c0 = profiling.counters()
    want = _error(kres.pyrdown_u8_plain, x)
    assert want is not None
    assert _error(kres.pyrdown_u8, x) == want
    assert _error(resample.pyrdown_u8, x) == want
    # a refused call takes no route
    assert _diff(c0, profiling.counters(), "resample_by_route") == {}


@pytest.mark.parametrize("name", list(BAD_RESIZE))
def test_resize_wrapper_refuses_what_plain_refuses(name):
    args = BAD_RESIZE[name]
    c0 = profiling.counters()
    want = _error(kres.resize_linear_u8_plain, *args)
    assert want is not None
    assert _error(kres.resize_linear_u8, *args) == want
    assert _diff(c0, profiling.counters(), "resample_by_route") == {}


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kres.pyrdown_u8(x)
    with pytest.raises(ValueError, match="unsupported device"):
        kres.resize_linear_u8(x, 16, 24)


@pytest.mark.parametrize("h,w", [(2, 2), (4, 4), (2, 6), (6, 2), (10, 14), (36, 52)])
def test_pyrdown_folds_small_frames_as_opencv(h, w):
    """Reflect-101 folds twice on a 2-wide axis: 2x2 and 4x4 frames give
    OpenCV's pyrDown (the fold's indices all lie in the frame)."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(h * 100 + w).integers(0, 256, size=(h, w), dtype=np.uint8)
    for n in (h, w):
        idx = kres._reflect101_indices(n)
        assert idx.min() >= 0 and idx.max() < n
    got = kres.pyrdown_u8(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(got, cv2.pyrDown(img))


@pytest.mark.parametrize("n", [3, 4, 5, 8, 17, 64])
def test_reflect101_indices_are_the_single_fold(n):
    """Past 2 wide, the indices are the plain ``|p|`` then ``2(n-1) - p``
    fold of the reference package."""
    idx = np.abs(np.arange(-2, n + 2))
    want = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    np.testing.assert_array_equal(kres._reflect101_indices(n), want)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_wrappers_equal_plain_on_cpu(factor):
    img = torch.as_tensor(np.random.default_rng(factor).integers(0, 256, size=(3, 14, 22),
                                                                 dtype=np.uint8))
    assert torch.equal(resample.resize_scale_u8(img, factor),
                       kres.resize_linear_u8_plain(img, 14 * factor, 22 * factor))
    assert torch.equal(resample.pyrdown_u8(img), kres.pyrdown_u8_plain(img))


@pytest.mark.parametrize("interp", [1, 4])
def test_the_cpu_route_is_plain_and_launches_nothing(interp):
    """A request on the CPU runs every upscale and pyrDown on the plain
    route, counted once a call, and launches no kernel."""
    cfg = MotionConfig(interp_factor=interp, **SMALL)
    a = np.random.default_rng(3).integers(0, 256, size=(2, 32, 48), dtype=np.uint8)
    b = np.roll(a, (1, 2), axis=(1, 2))
    launches = (kres.pyrdown_u8.launches, kres.resize_linear_u8.launches)
    c0 = profiling.counters()
    engine.estimate_flow_driver_batched(a, b, cfg, device="cpu")
    calls = (2 if interp > 1 else 0) + 2 * (cfg.num_levels - 1)
    assert _diff(c0, profiling.counters(), "resample_by_route") == {"plain": calls}
    assert (kres.pyrdown_u8.launches, kres.resize_linear_u8.launches) == launches


def test_cpu_calls_read_their_tables_once_a_shape():
    """The plain route reads the tables it always read: a pyrDown a row and
    a column index (``pyramid``), an upscale four tables an axis
    (``resize``), found on the device after the first call."""
    img = torch.as_tensor(np.random.default_rng(4).integers(0, 256, size=(2, 18, 26),
                                                            dtype=np.uint8))
    resample.build_pyramid(resample.resize_scale_u8(img, 4), 3)
    c0 = profiling.counters()
    resample.build_pyramid(resample.resize_scale_u8(img, 4), 3)
    c1 = profiling.counters()
    assert _diff(c0, c1, "table_hits_by_site") == {"resize": 8, "pyramid": 4}
    assert _diff(c0, c1, "syncs_by_site") == {}


def test_the_benchmark_finds_the_wrappers_and_their_kernels():
    """The benchmark's launch check counts these wrappers (functions of
    ``kernels`` modules with an int ``launches``) against the trace's
    kernels of ``csrc/``; no kernel name starts as a roofline reader's
    kernel does."""
    found = {fn.__name__ for fn in tracing.kernel_wrappers()}
    assert {"pyrdown_u8", "resize_linear_u8"} <= found
    pkg = Path(kres.__file__).resolve().parents[1]
    names = tracing.port_kernel_names(pkg)
    assert {"resize_linear_kernel", "pyrdown_kernel"} <= names
    src = (pkg / "csrc" / "resample.cu").read_text()
    mine = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)", src))
    assert mine == {"resize_linear_kernel", "pyrdown_kernel"}
    for name in mine:
        assert not name.startswith(("pooled_cvs_kernel", "round_kernel", "sad_spiral_argmin"))
