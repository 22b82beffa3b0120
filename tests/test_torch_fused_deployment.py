"""The benchmark's full-HD ``cv_fused=4`` deployment
(``benchmark/configs/fused4-interp4-1920x1080.json``) at a frame the CPU
runs in seconds: the port's plain path against the benchmark's plain
reference, the form its levels take, and the program's counters of
volume bytes and rounds by form (``utils/profiling.py``).

The configuration is the file's, all but the frame: 48x64 clips of the
``clip-b8`` traffic (``benchmark/gen.py``), upscaled 4x to 192x256 and
padded to 256x256, two pairs a request.
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import gen  # noqa: E402
from benchmark.reference import flow as reference  # noqa: E402
from blockbasedmotionestimation_tpu_torch.config import MotionConfig  # noqa: E402
from blockbasedmotionestimation_tpu_torch.kernels.cv_diff import cv_dtype  # noqa: E402
from blockbasedmotionestimation_tpu_torch.models import engine  # noqa: E402
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent  # noqa: E402
from blockbasedmotionestimation_tpu_torch.utils import profiling  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark/configs/fused4-interp4-1920x1080.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/clip-b8.json").read_text())
FRAME = (48, 64)  # 256x256 once upscaled and padded: a 1x1 grid of parents at level 3
PADDED = 256
BATCH = 2
LIST_FIELDS = ("block_sizes", "search_sizes", "rival_radius")


def _fields(**over) -> dict:
    """The configuration file's MotionConfig fields (lists as tuples)."""
    fields = {k: tuple(v) if k in LIST_FIELDS and isinstance(v, list) else v
              for k, v in CONFIG["motion_config"].items()}
    return dict(fields, **over)


def _pairs(seed: int):
    tr = dict(TRAFFIC, batch=BATCH, pool_requests=1)
    frames = gen.pool(tr, *FRAME, seed, "cpu")
    return frames[:BATCH], frames[1:BATCH + 1]


def _diff(c0: dict, c1: dict) -> dict:
    out = {"volume_bytes": c1["volume_bytes"] - c0["volume_bytes"], "syncs": c1["syncs"] - c0["syncs"]}
    for by in ("volume_bytes_by_form", "rounds_by_form", "syncs_by_site"):
        got = {k: v - c0[by].get(k, 0) for k, v in c1[by].items()}
        out[by] = {k: v for k, v in got.items() if v}
    return out


def _request(fields: dict, im1, im2) -> tuple[torch.Tensor, dict]:
    """One request of the plain path and what the counters counted over it."""
    cfg = MotionConfig.from_fields(fields)
    c0 = profiling.counters()
    flow = engine.estimate_flow_driver_batched(im1, im2, cfg, device="cpu")
    return flow, _diff(c0, profiling.counters())


@pytest.mark.parametrize("seed", [2**33 + 21, 7])
def test_plain_path_equals_the_reference(seed):
    """The port's plain path of the deployment gives the benchmark
    reference's flow bit for bit (the reference stores every volume; the
    fused form recomputes rounds 4 and 2 from the windows)."""
    im1, im2 = _pairs(seed)
    flow, _ = _request(_fields(), im1, im2)
    want = reference.estimate(im1, im2, _fields())
    assert flow.shape == want.shape == (BATCH, *FRAME, 2)
    assert reference.mismatched_pixels(flow, want) == 0
    assert torch.unique(flow[..., 0]).numel() > 3  # the motion is not trivial


def test_the_fused_form_is_taken():
    """4 levels of bs 32 with cv_fused=4: rounds 32, 16 and 8 on stored
    volumes (D), rounds 4 and 2 recomputed (kernel 12), both windows'
    volumes counted as the fused form's."""
    fields = _fields()
    _, got = _request(fields, *_pairs(3))
    levels = len(fields["block_sizes"])
    assert got["rounds_by_form"] == {"stored": 3 * levels, "fused": 2 * levels}
    assert set(got["volume_bytes_by_form"]) == {"fused"}


def _volume_bytes(fields: dict) -> dict:
    """Bytes of the volumes one request allocates, form by form, from the
    level shapes alone: (2r+1)^2 deltas a cell at each stored size, the
    cur = 2 band (2r+1)(2 store_r+1), the dtype of each size's worst cost."""
    b, out = BATCH, {}

    def add(form, r, curs, store_r=None):
        side = 2 * r + 1
        for cur in curs:
            deltas = side * (2 * store_r + 1) if cur == 2 and store_r is not None else side * side
            n = b * deltas * (h // cur) * (w // cur) * cv_dtype(cur, fields["cost"]).itemsize
            out[form] = out.get(form, 0) + n

    for level, (bs, ss) in enumerate(zip(fields["block_sizes"], fields["search_sizes"])):
        h = w = PADDED >> level
        r = spiral_extent(ss - bs)
        rr = fields["rival_radius"][min(level, len(fields["rival_radius"]) - 1)]
        r2 = r if rr is None else min(rr, r)
        every = [2, 4, 8, 16, 32]
        if fields["cv_fused"] is not None:
            add("fused", r, [8, 16, 32])
            add("fused", r2, [8, 16, 32])
        elif fields["window_center"] == "search":
            add("dense", r, every)
            add("dense", r2, every)
        else:
            store = fields["cv_store_radius"]
            add("dense" if store is None else "band", r, every, store)
            add("hybrid_rival", r2, [32])
    return out


@pytest.mark.parametrize("over", [
    {},                                                           # fused
    dict(cv_fused=None),                                          # band + hybrid rival
    dict(cv_fused=None, cv_store_radius=None),                    # dense + hybrid rival
    dict(cv_fused=None, window_center="search"),                  # dense, both windows
])
def test_volume_bytes_are_the_shapes(over):
    """``volume_bytes`` of a request equals its volumes' bytes worked out
    from the shapes, in each form; the fused form's are the fewest."""
    fields = _fields(**over)
    _, got = _request(fields, *_pairs(5))
    want = _volume_bytes(fields)
    assert got["volume_bytes_by_form"] == want
    assert got["volume_bytes"] == sum(want.values())
    if over:
        assert got["volume_bytes"] > sum(_volume_bytes(_fields()).values())


@pytest.mark.parametrize("over", [dict(cv_fused=None), {}], ids=["default", "fused"])
def test_the_smoke_scripts_plain_swap_runs_a_request(over):
    """``chip_smoke._plain_kernels``, which holds the main path against the
    kernels' plain versions on the card, runs a request of the default and
    of the fused form through them: the wrappers' flow, volume bytes and
    rounds, form by form."""
    import chip_smoke

    fields = _fields(**over)
    im1, im2 = _pairs(13)
    flow, got = _request(fields, im1, im2)
    with chip_smoke._plain_kernels():
        plain, plain_got = _request(fields, im1, im2)
    assert torch.equal(plain, flow)
    assert plain_got["volume_bytes_by_form"] == got["volume_bytes_by_form"]
    assert plain_got["rounds_by_form"] == got["rounds_by_form"]
    assert set(got["volume_bytes_by_form"]) == ({"band", "hybrid_rival"} if over else {"fused"})


def test_counting_adds_no_sync_and_spans_off_cost_a_null_context():
    """A warmed request counts volumes and rounds without a sync (its
    tables are on the device already), and with spans off every span,
    whatever its form, is the one shared null context."""
    im1, im2 = _pairs(9)
    _request(_fields(), im1, im2)  # tables copied once
    _, got = _request(_fields(), im1, im2)
    assert got["syncs"] == 0 and got["syncs_by_site"] == {}
    assert got["volume_bytes"] > 0 and sum(got["rounds_by_form"].values()) == 20
    assert profiling.span("volumes", form="fused") is profiling.span("round", cur=2, form="fused")


def test_spans_name_the_form(monkeypatch):
    """With spans on, each ``mf.volumes`` and ``mf.round`` range carries
    its form: ``fused`` volumes, rounds 32-8 ``stored``, 4 and 2 ``fused``."""
    seen = []

    def record(name, args=None):
        seen.append((name, args))
        return profiling._NULL

    monkeypatch.setattr(torch.profiler, "record_function", record)
    im1, im2 = _pairs(11)
    prev = profiling.spans(True)
    try:
        _request(_fields(), im1, im2)
    finally:
        profiling.spans(prev)
    volumes = [a for n, a in seen if n == "mf.volumes"]
    rounds = [a for n, a in seen if n == "mf.round"]
    assert volumes == ["form=fused"] * 4
    want = [f"cur={c}, form={'stored' if c > 4 else 'fused'}" for c in (32, 16, 8, 4, 2)]
    assert rounds == want * 4
