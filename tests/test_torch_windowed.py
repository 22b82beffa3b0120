"""The port's fused windowed level against JAX ``windowed_level(impl="xla")``.

Inputs are two-motion pairs made with numpy from a seed; the port runs them
as one batch, JAX one frame at a time.  Exact equality.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from blockbasedmotionestimation_tpu.ops.windowed import _pick_rival
from blockbasedmotionestimation_tpu.ops.windowed import windowed_level as jax_windowed_level
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

H, W, BS, SS, DX = 96, 128, 8, 24, 20


def _two_motion_pair(rng, h, w, left, right):
    """(im1, im2): flow `left` (u, v) on the left half, `right` on the right."""
    tex = synth.textured_image(h + 64, w + 64, rng)
    im2 = tex[32 : 32 + h, 32 : 32 + w]
    (ul, vl), (ur, vr) = left, right
    a = tex[32 + vl : 32 + vl + h, 32 + ul : 32 + ul + w]
    b = tex[32 + vr : 32 + vr + h, 32 + ur : 32 + ur + w]
    im1 = np.where(np.arange(w)[None, :] < w // 2, a, b).astype(np.uint8)
    return im1, im2


def _batch(rng):
    """Two pairs: a two-motion scene, and a global dx=20 translation whose
    prediction has a zeroed 2-parent strip (rival windows must repair it)."""
    a1, a2 = _two_motion_pair(rng, H, W, (DX, 0), (-6, 3))
    tex = synth.textured_image(H + 64, W + 64, rng)
    b1 = tex[32 : 32 + H, 32 : 32 + W]
    b2 = tex[32 : 32 + H, 32 - DX : 32 - DX + W]
    pred = np.zeros((2, H // BS, W // BS, 2), np.float32)
    pred[0, :, : W // BS // 2] = (DX, 0)
    pred[0, :, W // BS // 2 :] = (-6, 3)
    pred[1] = (DX, 0)
    pred[1, :, 6:8] = 0.0
    pred[1, 0, 0] = (999.0, 999.0)  # the zero-MV early-out
    pred[0, 3, 4] = (-2.7, 1.9)     # truncation toward zero
    return np.stack([a1, b1]), np.stack([a2, b2]), pred


@functools.lru_cache(maxsize=None)
def _jax_level(cost: str, rival: bool, radius):
    """JAX's XLA level, jitted once per program the tests below share."""
    return jax.jit(
        lambda a, b, p: jax_windowed_level(
            a, b, p, BS, SS, 4.0, 2, cost=cost, impl="xla", rival=rival,
            rival_radius=radius,
        )
    )


@pytest.mark.parametrize(
    "rival,radius,cost",
    [(True, None, "sad"), (True, 4, "sad"), (False, None, "sad"), (True, 4, "ssd")],
)
def test_windowed_level_matches_jax(rng, rival, radius, cost):
    im1, im2, pred = _batch(rng)
    fn = _jax_level(cost, rival, radius)
    got = tw.windowed_level(
        torch.as_tensor(im1), torch.as_tensor(im2), torch.as_tensor(pred), BS, SS,
        4.0, 2, cost=cost, rival=rival, rival_radius=radius,
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, H, W, 2)
    for b in range(2):
        want = np.asarray(fn(jnp.asarray(im1[b]), jnp.asarray(im2[b]), jnp.asarray(pred[b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
    if rival:
        # the repaired strip: every interior pixel at the planted motion
        strip = got[1, 16:80, 6 * BS : 8 * BS].numpy()
        assert (strip[..., 0] == DX).all() and (strip[..., 1] == 0).all()


@pytest.mark.parametrize("store_radius", [None, 0, 2])
@pytest.mark.parametrize("radius", [None, 4])
@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_hybrid_level_matches_jax_xla(rng, monkeypatch, cost, radius, store_radius):
    # the hybrid form (bs % 8 == 0 with rival windows: C, E and F's plain
    # versions; F only with a band) against JAX's dense XLA level, and the
    # dense-rival form against both
    im1, im2, pred = _batch(rng)
    fn = _jax_level(cost, True, radius)
    args = (torch.as_tensor(im1), torch.as_tensor(im2), torch.as_tensor(pred), BS, SS, 4.0, 2)
    kw = dict(cost=cost, rival=True, rival_radius=radius)
    got = tw.windowed_level(*args, store_radius=store_radius, **kw)
    for b in range(2):
        want = np.asarray(fn(jnp.asarray(im1[b]), jnp.asarray(im2[b]), jnp.asarray(pred[b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
    monkeypatch.setattr(tw, "hybrid_form", lambda bs, rival: False)
    assert torch.equal(got, tw.windowed_level(*args, store_radius=store_radius, **kw))


def test_pick_rival_matches_jax(rng):
    # few distinct values -> many coverage ties (first neighbour in raster
    # order wins) and parents with nothing excluded (keep base)
    vals = rng.integers(-3, 4, size=(2, 5, 7, 2)).astype(np.int32) * 6
    base = rng.integers(-3, 4, size=(2, 5, 7, 2)).astype(np.int32) * 6
    got = tw.pick_rival(torch.as_tensor(vals), torch.as_tensor(base), 8)
    for b in range(2):
        want = np.asarray(_pick_rival(jnp.asarray(vals[b]), jnp.asarray(base[b]), 8))
        np.testing.assert_array_equal(got[b].numpy(), want)
