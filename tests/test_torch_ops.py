"""The port's padding, resampling and regularizer tables against the JAX reference.

Same inputs (numpy, from a seed) through both packages; exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import jax.numpy as jnp

from blockbasedmotionestimation_tpu.config import MotionConfig, tiny_config
from blockbasedmotionestimation_tpu.ops import pad as jpad
from blockbasedmotionestimation_tpu.ops import regularize as jreg
from blockbasedmotionestimation_tpu.ops import resample as jres
from blockbasedmotionestimation_tpu_torch.ops import pad as tpad
from blockbasedmotionestimation_tpu_torch.ops import regularize as treg
from blockbasedmotionestimation_tpu_torch.ops import resample as tres


@pytest.mark.parametrize(
    "h,w,cfg",
    [
        (1080, 1920, MotionConfig()),
        (388, 584, MotionConfig()),
        (1552, 2336, MotionConfig()),
        (80, 112, tiny_config()),
        (37 * 2, 51 * 2, tiny_config((4, 8), (8, 16))),
    ],
)
def test_compute_padding_matches_jax(h, w, cfg):
    want = jpad.compute_padding(h, w, cfg)
    got = tpad.compute_padding(h, w, cfg)
    assert tuple(vars(got).values()) == tuple(vars(want).values())
    if (h, w) == (1080, 1920):
        assert (got.padded_h, got.padded_w) == (1280, 2048)


def test_pad_frame_matches_jax(rng):
    img = rng.integers(0, 256, size=(2, 30, 42), dtype=np.uint8)
    p = tpad.compute_padding(30, 42, tiny_config())
    got = tpad.pad_frame(torch.as_tensor(img), p).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jpad.pad_frame(jnp.asarray(img[b]), p)))


@pytest.mark.parametrize("h,w", [(8, 8), (24, 40), (64, 96)])
def test_pyrdown_matches_jax(rng, h, w):
    img = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    got = tres.pyrdown_u8(torch.as_tensor(img)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(jres.pyrdown_u8(jnp.asarray(img[b]))))


@pytest.mark.parametrize("src,dst", [((17, 23), (68, 92)), ((20, 30), (40, 60)), ((31, 9), (45, 27))])
def test_resize_linear_matches_jax(rng, src, dst):
    img = rng.integers(0, 256, size=(2,) + src, dtype=np.uint8)
    got = tres.resize_linear_u8(torch.as_tensor(img), *dst).numpy()
    for b in range(2):
        want = np.asarray(jres.resize_linear_u8(jnp.asarray(img[b]), *dst))
        np.testing.assert_array_equal(got[b], want)


def test_resize_scale_and_pyramid_match_jax(rng):
    img = rng.integers(0, 256, size=(25, 33), dtype=np.uint8)
    np.testing.assert_array_equal(
        tres.resize_scale_u8(torch.as_tensor(img), 4).numpy(),
        np.asarray(jres.resize_scale_u8(jnp.asarray(img), 4)),
    )
    img = rng.integers(0, 256, size=(64, 128), dtype=np.uint8)
    got = tres.build_pyramid(torch.as_tensor(img), 4)
    want = jres.build_pyramid(jnp.asarray(img), 4)
    assert len(got) == len(want) == 4
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_resample_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, size=(36, 52), dtype=np.uint8)
    np.testing.assert_array_equal(tres.pyrdown_u8(torch.as_tensor(img)).numpy(), cv2.pyrDown(img))
    np.testing.assert_array_equal(
        tres.resize_scale_u8(torch.as_tensor(img), 4).numpy(),
        cv2.resize(img, None, fx=4, fy=4, interpolation=cv2.INTER_LINEAR),
    )


def test_rank_tables_equal_jax():
    assert treg.SLOTS == jreg.SLOTS
    assert treg._CASE_ORDERINGS == jreg._CASE_ORDERINGS
    assert treg._BIG_RANK == int(jreg._BIG_RANK)
    np.testing.assert_array_equal(treg._RANK_TABLE, jreg._RANK_TABLE)
    assert treg._RANK_TABLE.dtype == jreg._RANK_TABLE.dtype


@pytest.mark.parametrize("nby,nbx", [(5, 7), (1, 6), (6, 1), (2, 2)])
def test_border_case_matches_jax(nby, nbx):
    i = np.arange(-1, nby + 1)[:, None]
    j = np.arange(-1, nbx + 1)[None, :]
    want = np.asarray(jreg._border_case(jnp.asarray(i), jnp.asarray(j), nby, nbx))
    got = treg.border_case(torch.as_tensor(i), torch.as_tensor(j), nby, nbx).numpy()
    np.testing.assert_array_equal(got, want)


def test_select_lexicographic_matches_jax(rng):
    # many exact energy ties, absent slots at _BIG_RANK, all-excluded rows
    energy = rng.integers(0, 4, size=(64, 9)).astype(np.float32)
    energy[rng.random((64, 9)) < 0.3] = np.finfo(np.float32).max
    energy[:4] = np.finfo(np.float32).max
    rank = treg._RANK_TABLE[rng.integers(0, 9, size=64)]
    want = np.asarray(jreg._select_lexicographic(jnp.asarray(energy), jnp.asarray(rank)))
    got = treg.select_lexicographic(torch.as_tensor(energy), torch.as_tensor(rank)).numpy()
    np.testing.assert_array_equal(got, want)
