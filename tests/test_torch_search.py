"""The port's block search against the JAX package, on the CPU.

Kernel 7's plain version (``kernels/sad_search.py``) against the TPU kernel
``sad_spiral_argmin`` run in interpret mode; the port's
``block_search_level`` (spiral, through kernel A's and kernel 7's plain
versions, and raster) against the JAX function's XLA and interpret-mode
paths and the NumPy oracle.  Every value is an integer: the tolerance is
exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import jax.numpy as jnp

from blockbasedmotionestimation_tpu.kernels.sad_search import sad_spiral_argmin as jax_argmin
from blockbasedmotionestimation_tpu.models import oracle
from blockbasedmotionestimation_tpu.ops import search as jsearch
from blockbasedmotionestimation_tpu_torch.kernels import sad_search
from blockbasedmotionestimation_tpu_torch.ops import search as tsearch
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent


def _pairs(rng, b, h, w, dy=2, dx=-3, margin=8):
    """b random base images and their translated crops: (b, h, w) u8 each."""
    base = rng.integers(0, 256, size=(b, h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[:, margin : margin + h, margin : margin + w]
    im2 = base[:, margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _preds(rng, b, nby, nbx, lo=-6, hi=7):
    """Integer predictions, some far outside the frame (the early-out)."""
    pred = rng.integers(lo, hi, size=(b, nby, nbx, 2)).astype(np.float32)
    pred[:, 0, 0] = (1000.0, 1000.0)
    pred[:, -1, 1] = (-3.0, -999.0)
    return pred


# ------------------------------------------------------------ kernel 7 (plain)

@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_plain_argmin_matches_tpu_kernel_interpret(rng, cost):
    # 10 x 15 = 150 blocks: not a multiple of the TPU kernel's 128-block chunk
    bs, ss, h, w = 4, 12, 40, 60
    ext = spiral_extent(ss - bs)
    win = bs + 2 * ext
    im1 = rng.integers(0, 256, size=(1, h, w), dtype=np.uint8)
    nblk = (h // bs) * (w // bs)
    # windows need not come from a gather: the argmin takes any pixels
    windows = rng.integers(0, 256, size=(1, nblk, win, win), dtype=np.uint8)
    cy = rng.integers(-ext - 2, h - bs + ext + 3, size=(1, nblk)).astype(np.int32)
    cx = rng.integers(-ext - 2, w - bs + ext + 3, size=(1, nblk)).astype(np.int32)
    cy[0, 3], cx[0, 3] = -100, 5  # every offset masked: the centre wins
    # equal costs everywhere: the spiral rank decides
    windows[0, 7] = 9
    im1[0, 0:bs, 7 * bs : 8 * bs] = 9
    blocks = jsearch.extract_blocks(jnp.asarray(im1[0]), bs)
    want_dy, want_dx = jax_argmin(
        blocks, jnp.asarray(windows[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        bs, ss, h, w, interpret=True, cost=cost,
    )
    args = (torch.as_tensor(im1), torch.as_tensor(windows), torch.as_tensor(cy),
            torch.as_tensor(cx), bs, ss, cost)
    got_dy, got_dx = sad_search.sad_spiral_argmin(*args)  # a CPU tensor: the plain version
    assert got_dy.dtype == torch.int32 and tuple(got_dy.shape) == (1, nblk)
    np.testing.assert_array_equal(got_dy[0].numpy(), np.asarray(want_dy))
    np.testing.assert_array_equal(got_dx[0].numpy(), np.asarray(want_dx))
    assert (got_dy[0, 3], got_dx[0, 3]) == (ext, ext)
    plain = sad_search.sad_spiral_argmin_plain(*args)
    assert torch.equal(plain[0], got_dy) and torch.equal(plain[1], got_dx)


def test_argmin_rejects_bad_inputs(rng):
    im1 = torch.as_tensor(rng.integers(0, 256, size=(1, 16, 16), dtype=np.uint8))
    wins = torch.zeros((1, 16, 12, 12), dtype=torch.uint8)
    c = torch.zeros((1, 16), dtype=torch.int32)
    fn = sad_search.sad_spiral_argmin
    with pytest.raises(ValueError):
        fn(im1, wins[:, :, :10, :10], c, c, 4, 12, "sad")  # window edge != bs + 2S
    with pytest.raises(ValueError):
        fn(im1, wins, c.to(torch.int64), c, 4, 12, "sad")
    with pytest.raises(ValueError):
        fn(im1[:, :14], wins, c, c, 4, 12, "sad")  # frame not a multiple of bs
    with pytest.raises(NotImplementedError, match="zsad runs sad_spiral_argmin_plain"):
        fn(im1, wins, c, c, 4, 12, "zsad")


# ------------------------------------------------------- block_search_level

@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("bs,ss", [(4, 8), (8, 16)])
@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_spiral_search_matches_jax(rng, impl, bs, ss, cost):
    b, h, w = 2, 32, 40
    im1, im2 = _pairs(rng, b, h, w)
    pred = _preds(rng, b, h // bs, w // bs)
    got = tsearch.block_search_level(
        torch.as_tensor(im1), torch.as_tensor(im2), torch.as_tensor(pred), bs, ss, cost=cost
    )
    assert got.dtype == torch.int32
    for k in range(b):
        want = jsearch.block_search_level(im1[k], im2[k], pred[k], bs, ss, impl=impl, cost=cost)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("bs,ss", [(4, 8), (4, 12), (8, 16)])
@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_raster_search_matches_jax(rng, bs, ss, cost):
    b, h, w = 2, 32, 40
    im1, im2 = _pairs(rng, b, h, w)
    pred = _preds(rng, b, h // bs, w // bs, -9, 10)
    got = tsearch.block_search_level(
        torch.as_tensor(im1), torch.as_tensor(im2), torch.as_tensor(pred), bs, ss,
        order="raster", cost=cost,
    )
    # the predicted position kept by a window clipped away entirely
    assert tuple(got[0, 0, 0].tolist()) == (1000, 1000)
    for k in range(b):
        want = jsearch.block_search_level(
            im1[k], im2[k], pred[k], bs, ss, impl="xla", order="raster", cost=cost
        )
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("order", ["spiral", "raster"])
@pytest.mark.parametrize("bs,ss", [(4, 8), (4, 12), (8, 16)])
def test_search_matches_oracle(rng, order, bs, ss):
    h, w = 32, 40
    im1, im2 = _pairs(rng, 1, h, w)
    pred = _preds(rng, 1, h // bs, w // bs)
    got = tsearch.block_search_level(
        torch.as_tensor(im1), torch.as_tensor(im2), torch.as_tensor(pred), bs, ss, order=order
    )
    flow = np.zeros((h, w, 2), dtype=np.float32)
    flow[::bs, ::bs] = pred[0]
    oracle.calc_level_bm(im1[0], im2[0], flow, bs, ss, order=order)
    np.testing.assert_array_equal(got[0].numpy(), flow[::bs, ::bs])


def test_search_rejects_unknown_order(rng):
    im = torch.as_tensor(rng.integers(0, 256, size=(1, 16, 16), dtype=np.uint8))
    pred = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="order"):
        tsearch.block_search_level(im, im, pred, 4, 8, order="zigzag")
