"""The windowed level on row strips (``parallel/tiled.py``) against JAX.

The port's fused windowed level (the default config's path) and
``windowed_schedule`` on row strips (the in-process transport on the CPU:
the kernels' plain versions, ghost rows exchanged before every colour step)
equal JAX's UNTILED engine bit for bit: rival windows, odd strips, batches
over the batch axis (mirrors of ``tests/test_tiled.py``; the capped paths
and the capacity forms are in ``tests/test_torch_tiled_forms.py``).  One
case runs against JAX's own
``estimate_flow_padded_tiled`` on an 8-device CPU mesh, in a fresh
interpreter (this file run as a script).  Pairs made from a seed with
numpy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the case run against JAX's tiled engine: odd strips, rival windows
ODD_RIVAL = dict(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                 regularizer="windowed", rival_window=True)


def _pair(rng, h, w, dy=2, dx=-3, margin=16):
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin : margin + h, margin : margin + w]
    im2 = base[margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _jax_tiled(out: str) -> None:
    """JAX's tiled engine on the ODD_RIVAL pair over 8 CPU devices."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from blockbasedmotionestimation_tpu.config import MotionConfig
    from blockbasedmotionestimation_tpu.parallel import tiled as jtiled

    im1, im2 = _pair(np.random.default_rng(77), 96, 64, dy=2, dx=-1)
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("ty",))
    flow = jtiled.estimate_flow_padded_tiled(im1, im2, MotionConfig(**ODD_RIVAL), mesh)
    np.save(out, np.asarray(flow))


if __name__ == "__main__":
    _jax_tiled(sys.argv[1])
    sys.exit(0)


from blockbasedmotionestimation_tpu.config import MotionConfig  # noqa: E402
from blockbasedmotionestimation_tpu.models import engine as jeng  # noqa: E402
from blockbasedmotionestimation_tpu_torch import config as tconfig  # noqa: E402
from blockbasedmotionestimation_tpu_torch.parallel import tiled  # noqa: E402


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


def _rows(t=8):
    return tiled.Mesh((t,), ("ty",))


def _tiled_vs_jax(cfg, im1, im2, t=8):
    got = tiled.estimate_flow_padded_tiled(im1, im2, _port(cfg), _rows(t), device="cpu")
    want = np.asarray(jeng.estimate_flow_padded(im1, im2, cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.fixture(scope="module")
def jax_tiled(tmp_path_factory):
    """JAX's tiled run, started first in its own interpreter."""
    out = tmp_path_factory.mktemp("jax_tiled") / "flow.npy"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    proc.kill()
    proc.communicate()


def test_odd_rival_equals_jax_tiled_engine(jax_tiled):
    # the port's tiled engine against JAX's own, and both against untiled
    proc, out = jax_tiled
    im1, im2 = _pair(np.random.default_rng(77), 96, 64, dy=2, dx=-1)
    got = tiled.estimate_flow_padded_tiled(im1, im2, _port(MotionConfig(**ODD_RIVAL)), _rows(),
                                           device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    want = np.load(out)
    np.testing.assert_array_equal(got.numpy(), want)
    untiled = np.asarray(jeng.estimate_flow_padded(im1, im2, MotionConfig(**ODD_RIVAL)))
    np.testing.assert_array_equal(want, untiled)


@pytest.mark.parametrize("rows,dy", [(128, 1), (96, 2)], ids=["even", "odd-strips"])
def test_rival_tiled_equals_jax_untiled(rng, rows, dy):
    # tests/test_tiled.py::test_rival_tiled_equals_untiled and the odd-strip
    # rival case: the rival pick reads the neighbouring strips' winners
    cfg = MotionConfig(**ODD_RIVAL)
    _tiled_vs_jax(cfg, *_pair(rng, rows, 64, dy=dy, dx=-1))


def test_odd_block_rows_windowed_equals_jax_untiled(rng):
    # tests/test_tiled.py::test_tiled_odd_block_rows_equals_untiled (windowed)
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                       regularizer="windowed", rival_window=False)
    _tiled_vs_jax(cfg, *_pair(rng, 96, 64, dy=1, dx=-1))


def test_batch_tiled_equals_jax_untiled(rng):
    # tests/test_tiled.py::test_batch_tiled_combined_matches_untiled: pairs
    # over "batch", rows over "ty" (the search-centred case is in
    # tests/test_torch_tiled_forms.py)
    _batch_tiled_vs_jax(rng, MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6),
                                          interp_factor=1, regularizer="windowed"))


def _batch_tiled_vs_jax(rng, cfg):
    pairs = [_pair(rng, 64, 64, dy=d % 3, dx=-(d % 2)) for d in range(4)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    got = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, _port(cfg), tiled.Mesh((2, 4)),
                                                 device="cpu")
    for b in range(4):
        want = np.asarray(jeng.estimate_flow_padded(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(got[b].numpy(), want)
