"""The volume kernel's store paths, from shapes alone (no kernel runs here).

``kernels/cv_diff.paired_curs`` is the rule by which a launch of the volume
kernel (B, C, 13) has lane pairs store a size's runs together, whole 32-byte
sectors a store; ``csrc/cv_diff.cu`` paired_cur2 is the same rule.  The
wrappers count each stored volume's bytes by path in
``utils.profiling.counters()`` (``volume_store_bytes_by_path``), for CUDA
launches only; ``tests/test_torch_cuda.py`` holds the counts to the
launches on the card.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch.kernels import cv_diff
from blockbasedmotionestimation_tpu_torch.utils import profiling


def _emits(bs):
    """The emit sets of B (every size, or the cur=2 size alone), C
    (``deep_curs``) and 13 (bs)."""
    return {"B": cv_diff._curs(bs), "B2": [2], "C": cv_diff.deep_curs(bs, min(16, bs // 2)),
            "13": [bs]}


@pytest.mark.parametrize("bs", [2, 4, 8, 16, 32, 64, 128])
def test_paired_sizes_are_whole_sector_runs_of_two_parents_a_warp(bs):
    # for every cost, parents a block (1-8, as volume_launch may be forced)
    # and emit set: only cur 2 pairs, where it is emitted, a lane's run of
    # bs/2 cells is whole 32-byte sectors, a warp's 32 lanes hold two
    # parents' rows (bs/2 <= 16) and the block more than one parent
    for cost, pp, (what, emit) in itertools.product(("sad", "ssd"), (1, 2, 4, 8),
                                                     _emits(bs).items()):
        paired = cv_diff.paired_curs(bs, cost, emit, pp)
        lane_run = bs // 2 * cv_diff.cv_dtype(2, cost).itemsize
        want = 2 in emit and lane_run % 32 == 0 and bs // 2 <= 16 and pp > 1
        assert paired == ([2] if want else []), (cost, pp, what)
        assert set(paired) <= set(emit)


@pytest.mark.parametrize("bs,cost,emit,pp,want", [
    # bs 32, sad: a lane's cur=2 run is 16 uint16 cells, one sector
    (32, "sad", [2, 4, 8, 16, 32], 4, [2]),
    (32, "sad", [2], 2, [2]),
    (32, "sad", [2, 4, 8, 16, 32], 1, []),  # one parent a block: no partner
    # C and 13 at bs 32 (cur 8 runs 8 bytes, cur 16 4, cur 32 4)
    (32, "sad", [16, 32], 2, []),
    (32, "sad", [32], 2, []),
    # bs 16: sad runs 8 cells x 2 bytes, half a sector; ssd 8 x 4, one
    (16, "sad", [2, 4, 8, 16], 4, []),
    (16, "ssd", [2, 4, 8, 16], 4, [2]),
    # bs 32 ssd: 16 x 4 bytes, two sectors
    (32, "ssd", [2, 4, 8, 16, 32], 4, [2]),
    # bs 64: 64-byte runs, but a warp holds one parent's 32 rows
    (64, "sad", [2, 4, 8, 16, 32, 64], 4, []),
    # bs 8 ssd: 4 x 4 bytes; bs 2: one 2-byte cell
    (8, "ssd", [2, 4, 8], 4, []),
    (2, "sad", [2], 8, []),
])
def test_paired_sizes_worked_by_hand(bs, cost, emit, pp, want):
    assert cv_diff.paired_curs(bs, cost, emit, pp) == want


@pytest.mark.parametrize("npy,npx,store_r,emit,want", [
    # search-centred level 0 (2048x2560, B=8) and 3 (256x320): dense B, and
    # the default's band; 4 parents a block at every level
    (64, 80, None, None, [2]),
    (8, 10, None, None, [2]),
    (64, 80, 4, None, [2]),
    # the rival window's C (2 parents a block) and 13
    (64, 80, None, [16, 32], []),
    (64, 80, None, [32], []),
])
def test_paired_sizes_at_the_cells_launches(npy, npx, store_r, emit, want):
    bs, r = 32, 16
    emit = cv_diff._check_options(bs, r, store_r, emit)
    geo = cv_diff.volume_geometry(bs, r, 8, npy, npx, writes_fine=bool({2, 4} & set(emit)))
    assert geo.parents_per_block == (4 if 2 in emit else 2)
    assert cv_diff.paired_curs(bs, "sad", emit, geo.parents_per_block) == want


def test_counters_carry_the_store_paths_and_plain_calls_add_nothing():
    c0 = profiling.counters()
    before = dict(c0["volume_store_bytes_by_path"])
    im1 = torch.zeros((1, 16, 32), dtype=torch.uint8)
    win = torch.zeros((1, 8, 12, 12), dtype=torch.uint8)
    out = cv_diff.pooled_cvs(im1, win, 8, 2, "sad")
    assert sorted(out) == [2, 4, 8]
    assert profiling.counters()["volume_store_bytes_by_path"] == before
    profiling.volume_store("pairs", 10)
    profiling.volume_store("lanes", 6)
    got = profiling.counters()["volume_store_bytes_by_path"]
    assert got["pairs"] - before.get("pairs", 0) == 10
    assert got["lanes"] - before.get("lanes", 0) == 6
