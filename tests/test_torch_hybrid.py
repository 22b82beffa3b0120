"""The port's hybrid form against JAX's own kernels C, E and F.

``windowed_level(rival=True, store_radius=s)`` of the port (its plain
versions, on the CPU) against JAX ``windowed_level(impl="pallas_interpret",
...)``, which runs the TPU kernels ``deep_pooled_cvs`` (C),
``windowed_color_step_pm_hybrid`` (E) and ``windowed_color_step_pm_hybrid_tail``
(F) in interpret mode.  bs = 8 covers C, E at cur = 4 and F at cur = 2;
bs = 16 adds E at cur = 8.  The pair has two motions 26 px apart, so the
rival windows and the band's tail decide cells.  Exact equality.

The JAX side runs in a fresh interpreter (this file run as a script): the
interpret-mode programs are among the suite's largest, and XLA:CPU is safer
compiling them with no history in the process (DESIGN.md section 8b).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def _jax_levels(bs: int, ss: int, out_path: str) -> None:
    """JAX's hybrid level, frame by frame, in interpret mode -> out_path."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from blockbasedmotionestimation_tpu.ops.windowed import windowed_level

    im1, im2, pred = two_motion_batch(bs)
    out = [
        np.asarray(windowed_level(
            jnp.asarray(im1[b]), jnp.asarray(im2[b]), jnp.asarray(pred[b]), bs, ss,
            LAM0, SWEEPS, impl="pallas_interpret", rival=True, rival_radius=RIVAL_R,
            store_radius=STORE_R,
        ))
        for b in range(im1.shape[0])
    ]
    np.save(out_path, np.stack(out))


SIZES = [(8, 24), (16, 48)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Both sizes' JAX levels, started at once in their own interpreters."""
    tmp = tmp_path_factory.mktemp("jax_hybrid")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    runs = {}
    for bs, ss in SIZES:
        out = str(tmp / f"bs{bs}.npy")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(bs), str(ss), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        runs[bs] = (proc, out)
    yield runs
    for proc, _ in runs.values():
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("bs,ss", SIZES)
def test_hybrid_level_matches_jax_interpret(jax_runs, bs, ss):
    from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

    proc, out = jax_runs[bs]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    want = np.load(out)

    im1, im2, pred = (torch.as_tensor(x) for x in two_motion_batch(bs))
    args = (im1, im2, pred, bs, ss, LAM0, SWEEPS)
    got = tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R, store_radius=STORE_R)
    np.testing.assert_array_equal(got.numpy(), want)
    # the band changes no bit; the rival windows change cells
    dense = tw.windowed_level(*args, rival=True, rival_radius=RIVAL_R, store_radius=None)
    assert torch.equal(got, dense)
    no_rival = tw.windowed_level(*args, rival=False)
    assert (got != no_rival).any()


if __name__ == "__main__":
    _jax_levels(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
