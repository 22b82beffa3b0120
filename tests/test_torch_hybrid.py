"""The port's hybrid form and ``cv_fused`` against JAX's own kernels.

``windowed_level(rival=True, store_radius=s)`` of the port (its plain
versions, on the CPU) against JAX ``windowed_level(impl="pallas_interpret",
...)``, which runs the TPU kernels ``deep_pooled_cvs`` (C),
``windowed_color_step_pm_hybrid`` (E) and ``windowed_color_step_pm_hybrid_tail``
(F) in interpret mode.  bs = 8 covers C, E at cur = 4 and F at cur = 2;
bs = 16 adds E at cur = 8.  At bs = 8 the ``cv_fused`` level with rival
windows (``fuse=4``: C for both windows, D at cur = 8, kernel 12 at cur 4
and 2) runs against JAX's too.  The pair has two motions 26 px apart, so the
rival windows and the band's tail decide cells.  Exact equality.

The JAX side runs in a fresh interpreter (this file run as a script), one
jitted level at a time: the interpret-mode programs are among the suite's
largest, and XLA:CPU is safer compiling them with no history in the process
(DESIGN.md section 8b).
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

from blockbasedmotionestimation_tpu.utils import synth

H, W, DX = 64, 96, 20
LAM0, SWEEPS, RIVAL_R, STORE_R = 4.0, 2, 4, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def two_motion_batch(bs: int, seed: int = 1234):
    """Two pairs and predictions at bs: a two-motion scene (flow (DX, 0)
    left, (-6, 3) right) predicted per half, and a global (DX, 0) shift
    whose prediction has a zeroed strip of two parent columns."""
    rng = np.random.default_rng(seed)
    tex = synth.textured_image(H + 64, W + 64, rng)
    a2 = tex[32 : 32 + H, 32 : 32 + W]
    left = tex[32 : 32 + H, 32 + DX : 32 + DX + W]
    right = tex[32 + 3 : 32 + 3 + H, 32 - 6 : 32 - 6 + W]
    a1 = np.where(np.arange(W)[None, :] < W // 2, left, right).astype(np.uint8)
    tex = synth.textured_image(H + 64, W + 64, rng)
    b1 = tex[32 : 32 + H, 32 : 32 + W]
    b2 = tex[32 : 32 + H, 32 - DX : 32 - DX + W]
    npy, npx = H // bs, W // bs
    pred = np.zeros((2, npy, npx, 2), np.float32)
    pred[0, :, : npx // 2] = (DX, 0)
    pred[0, :, npx // 2 :] = (-6, 3)
    pred[1] = (DX, 0)
    pred[1, :, npx // 2 - 1 : npx // 2 + 1] = 0.0
    return np.stack([a1, b1]), np.stack([a2, b2]), pred


FUSE = 4  # cv_fused at bs = 8: kernel 12 in rounds cur 4 and 2


def _jax_levels(bs: int, ss: int, out_dir: str) -> None:
    """JAX's hybrid level (and at bs = 8 its cv_fused level), frame by
    frame, in interpret mode -> out_dir/{hybrid,fused}.npy."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from blockbasedmotionestimation_tpu.ops.windowed import windowed_level

    im1, im2, pred = two_motion_batch(bs)
    forms = {"hybrid": dict(store_radius=STORE_R)}
    if bs == 8:
        forms["fused"] = dict(fuse=FUSE)
    for name, kw in forms.items():
        fn = jax.jit(lambda a, b, p, kw=kw: windowed_level(
            a, b, p, bs, ss, LAM0, SWEEPS, impl="pallas_interpret", rival=True,
            rival_radius=RIVAL_R, **kw,
        ))
        out = [np.asarray(fn(im1[b], im2[b], pred[b])) for b in range(im1.shape[0])]
        np.save(os.path.join(out_dir, f"{name}.npy"), np.stack(out))


SIZES = [(8, 24), (16, 48)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Both sizes' JAX levels, started at once in their own interpreters."""
    tmp = tmp_path_factory.mktemp("jax_hybrid")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    runs = {}
    for bs, ss in SIZES:
        out = tmp / f"bs{bs}"
        out.mkdir()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(bs), str(ss), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        runs[bs] = (proc, out)
    yield runs
    for proc, _ in runs.values():
        proc.kill()
        proc.communicate()


def _jax_result(jax_runs, bs: int, name: str) -> np.ndarray:
    proc, out = jax_runs[bs]
    if proc.returncode is None:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    assert proc.returncode == 0
    return np.load(out / f"{name}.npy")


@pytest.mark.parametrize("bs,ss", SIZES)
def test_hybrid_level_matches_jax_interpret(jax_runs, bs, ss):
    from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

    want = _jax_result(jax_runs, bs, "hybrid")
    im1, im2, pred = (torch.as_tensor(x) for x in two_motion_batch(bs))
    args = (im1, im2, pred, bs, ss, LAM0, SWEEPS)
    got = tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R, store_radius=STORE_R)
    np.testing.assert_array_equal(got.numpy(), want)
    # the band changes no bit; the rival windows change cells
    dense = tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R, store_radius=None)
    assert torch.equal(got, dense)
    no_rival = tw.windowed_level(*args, rival=False)
    assert (got != no_rival).any()


def test_fused_rival_level_matches_jax_interpret(jax_runs):
    # cv_fused with rival windows: kernel 12 recomputes every candidate from
    # the main and rival windows; the flow is the hybrid form's
    from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

    bs, ss = SIZES[0]
    want = _jax_result(jax_runs, bs, "fused")
    im1, im2, pred = (torch.as_tensor(x) for x in two_motion_batch(bs))
    args = (im1, im2, pred, bs, ss, LAM0, SWEEPS)
    got = tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R, fuse=FUSE)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R))


if __name__ == "__main__":
    _jax_levels(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
