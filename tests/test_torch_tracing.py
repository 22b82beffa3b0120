"""The port's counters and spans (``utils/profiling.py``), on the CPU, and
on the card that every sync the program makes is one it counts.

Imports neither jax nor the conftest fixtures, so the card's test also
runs on a machine without JAX:

    python -m pytest tests/test_torch_tracing.py --noconftest -o addopts="" -q
"""

import json
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch import MotionConfig, tiny_config
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, fused_step, gather, reg_step
from blockbasedmotionestimation_tpu_torch.kernels import resample as kres
from blockbasedmotionestimation_tpu_torch.kernels import sad_search
from blockbasedmotionestimation_tpu_torch.models import engine
from blockbasedmotionestimation_tpu_torch.parallel import tiled
from blockbasedmotionestimation_tpu_torch.utils import profiling

# the cells' structure (4 levels, the x4 upscale, rival windows and the
# band) at 8 px blocks, on frames a CPU runs in a second
SMALL = dict(block_sizes=(8, 8, 8, 8), search_sizes=(16, 16, 16, 16),
             rival_radius=(2, None, 2, 2))
CONFIGS = {
    "default": dict(SMALL),
    "search-centred": dict(SMALL, window_center="search"),
    "host-arrays": dict(SMALL),
}


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)
    return a, np.roll(a, (1, 2), axis=(1, 2))


def tables_from_the_code(cfg: MotionConfig, device: str = "cpu") -> dict:
    """Constant tables a request of ``estimate_flow_driver_batched`` reads
    on ``device``, site by site, read from the code (``profiling.table``:
    copied once a shape and device, found there after)."""
    levels = cfg.num_levels
    want = {
        # resize_linear_u8: 4 row and 4 column tables, a frame (the plain
        # version and the kernel alike)
        "resize": 2 * 8 if cfg.interp_factor > 1 else 0,
        # pyrdown_u8's plain version: a row and a column index, a level
        # below the finest, both frames; the kernel reflects by arithmetic
        "pyramid": 2 * 2 * (levels - 1) if device == "cpu" else 0,
        # transfer_mvs: a row and a column index, a level below the coarsest
        "transfer": 2 * (levels - 1),
        # spiral_argmin of the fused windowed level: the rank table, dy, dx
        "argmin": 3 * levels if cfg.uses_fused_windowed else 0,
    }
    return {k: v for k, v in want.items() if v}


def syncs_from_the_code(cfg: MotionConfig, host_arrays: bool) -> dict:
    """Syncs a warmed request of ``estimate_flow_driver_batched`` makes,
    site by site, read from the code: its tables are on the device
    already, so only frames that come as host arrays are copied
    (``_as_frames``, ``profiling.upload``: the copy waits for the stream)."""
    return {"frames": 2} if host_arrays else {}


def _diff(c0: dict, c1: dict) -> dict:
    out = {k: c1[k] - c0[k]
           for k in ("requests", "fields", "host_ns", "syncs", "sync_ns", "table_hits")}
    for by in ("syncs_by_site", "table_hits_by_site"):
        sites = {k: v - c0[by].get(k, 0) for k, v in c1[by].items()}
        out[by] = {k: v for k, v in sites.items() if v}
    return out


def _drop_tables():
    """No table on any device, as in a fresh process."""
    with profiling._TABLES_LOCK:
        profiling._TABLES.clear()


@pytest.fixture
def cold_tables():
    _drop_tables()


def _inputs(a, b, host_arrays, device):
    """A request's frames and the entry's ``device``: host arrays, or
    tensors already on the device."""
    if host_arrays:
        return a, b, device
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device), None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counted_syncs_are_the_codes(name):
    cfg = MotionConfig(**CONFIGS[name])
    host = name == "host-arrays"
    ta, tb, dev = _inputs(*_frames(2, 16, 24), host, "cpu")
    engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)  # tables copied once
    c0 = profiling.counters()
    flow = engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
    got = _diff(c0, profiling.counters())
    want = syncs_from_the_code(cfg, host)
    assert flow.shape == (2, 16, 24, 2)
    assert got["syncs_by_site"] == want
    assert got["syncs"] == sum(want.values())
    assert (got["requests"], got["fields"]) == (1, 2)
    assert 0 <= got["sync_ns"] <= got["host_ns"]


def test_counted_syncs_per_field_of_the_cells():
    """The counts PERF.md derives for a warmed request: no sync in the
    clip cells, the two frames a pair in the live cell; the tables found on
    the device, 46 a request of 8 fields in the default clip cell, 34 in
    the search-centred one, 46 a pair in the live cell; on the card, where
    the pyramid reads no table, 34 and 22."""
    per = lambda cfg, host, batch: sum(syncs_from_the_code(cfg, host).values()) / batch
    assert per(MotionConfig(), False, 8) == 0
    assert per(MotionConfig(window_center="search"), False, 8) == 0
    assert per(MotionConfig(), True, 1) == 2
    hits = lambda cfg: sum(tables_from_the_code(cfg).values())
    assert (hits(MotionConfig()), hits(MotionConfig(window_center="search"))) == (46, 34)
    card = lambda cfg: sum(tables_from_the_code(cfg, "cuda").values())
    assert (card(MotionConfig()), card(MotionConfig(window_center="search"))) == (34, 22)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_copied_once_then_found(name, cold_tables):
    """A process's first request copies each table it reads once (a sync
    a distinct table) and finds the rest on the device; the second copies
    none and finds every one, as many as the code reads a request."""
    cfg = MotionConfig(**CONFIGS[name])
    host = name == "host-arrays"
    ta, tb, dev = _inputs(*_frames(2, 16, 24), host, "cpu")
    want = tables_from_the_code(cfg)
    c0 = profiling.counters()
    first = engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
    got = _diff(c0, profiling.counters())
    copied = dict(got["syncs_by_site"])
    assert copied.pop("frames", 0) == (2 if host else 0)
    distinct = {}
    for site, _, _ in profiling._TABLES:
        distinct[site] = distinct.get(site, 0) + 1
    assert copied == distinct  # no table copied twice
    for site, n in want.items():
        assert 0 < copied[site] <= n, site
        assert copied[site] + got["table_hits_by_site"].get(site, 0) == n, site
    c1 = profiling.counters()
    second = engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
    got = _diff(c1, profiling.counters())
    assert got["syncs_by_site"] == syncs_from_the_code(cfg, host)
    assert {k: got["table_hits_by_site"][k] for k in want} == want
    assert got["table_hits"] == sum(got["table_hits_by_site"].values())
    assert torch.equal(first, second)


def test_tables_keep_the_most_recently_used(monkeypatch, cold_tables):
    """The device's tables are bounded: past ``TABLES_KEPT`` the least
    recently used goes, and a later call copies it again."""
    monkeypatch.setattr(profiling, "TABLES_KEPT", 3)
    cpu = torch.device("cpu")
    get = lambda k: profiling.table("test", k, lambda: np.arange(k + 1), cpu)
    first = [get(k) for k in range(3)]
    assert get(0) is first[0]  # a hit, now the most recent
    c0 = profiling.counters()
    get(3)  # drops 1, the least recently used
    assert [k for _, k, _ in profiling._TABLES] == [2, 0, 3]
    assert get(2) is first[2] and get(0) is first[0]
    again = get(1)
    got = _diff(c0, profiling.counters())
    assert got["syncs_by_site"] == {"test": 2} and got["table_hits_by_site"] == {"test": 2}
    assert again is not first[1] and torch.equal(again, first[1])
    assert len(profiling._TABLES) == 3


@pytest.mark.parametrize("sizes", [((16, 24), (24, 16)), ((16, 24), (32, 24))])
def test_frame_sizes_keep_tables_of_their_own(sizes, cold_tables):
    """Two frame sizes in one process each copy their own tables and give
    the flows each gives with no table on the device: a key that missed an
    argument would hand one size's stale table to the other."""
    cfg = MotionConfig(**CONFIGS["default"])
    pairs = [_frames(2, h, w, seed=5) for h, w in sizes]
    run = lambda a, b: engine.estimate_flow_driver_batched(torch.as_tensor(a),
                                                           torch.as_tensor(b), cfg)
    fresh = []
    for a, b in pairs:
        _drop_tables()
        fresh.append(run(a, b))
    _drop_tables()
    copied = []
    for (a, b), want in zip(pairs + pairs, fresh + fresh):
        c0 = profiling.counters()
        assert torch.equal(run(a, b), want)
        copied.append(_diff(c0, profiling.counters())["syncs"])
    # each size copies tables the other does not have, once
    assert copied[0] > 0 and copied[1] > 0 and copied[2:] == [0, 0]


ENTRIES = {
    "estimate_flow_driver": (lambda cfg, a, b: engine.estimate_flow_driver(
        a[0], b[0], cfg, device="cpu"), 1),
    "estimate_flow_driver_batched": (lambda cfg, a, b: engine.estimate_flow_driver_batched(
        a, b, cfg, device="cpu"), 2),
    "estimate_flow_batched": (lambda cfg, a, b: engine.estimate_flow_batched(
        a, b, cfg, device="cpu"), 2),
    "estimate_flow": (lambda cfg, a, b: engine.estimate_flow(a[0], b[0], cfg, device="cpu"), 1),
    "estimate_flow_padded": (lambda cfg, a, b: engine.estimate_flow_padded(
        torch.as_tensor(a), torch.as_tensor(b), cfg), 2),
    "tiled.estimate_flow_batch": (lambda cfg, a, b: tiled.estimate_flow_batch(
        a, b, cfg, tiled.Mesh((1, 1)), device="cpu"), 2),
    "tiled.estimate_flow_tiled_auto": (lambda cfg, a, b: tiled.estimate_flow_tiled_auto(
        a[0], b[0], cfg, tiled.Mesh((1, 2)), device="cpu"), 1),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_nested_entries_count_once(name):
    """Every public entry point counts its outermost call once, whatever
    entry points it calls, with the fields it returns."""
    call, fields = ENTRIES[name]
    cfg = tiny_config(rival_radius=2)
    a, b = _frames(2, 64, 48, seed=3)
    c0 = profiling.counters()
    t0 = time.perf_counter_ns()
    call(cfg, a, b)
    wall = time.perf_counter_ns() - t0
    got = _diff(c0, profiling.counters())
    assert (got["requests"], got["fields"]) == (1, fields)
    assert 0 < got["host_ns"] <= wall


def test_an_entry_that_raises_counts_no_request():
    c0 = profiling.counters()
    with pytest.raises(ValueError):
        engine.estimate_flow_driver_batched(np.zeros((1, 8, 8), np.float32),
                                            np.zeros((1, 8, 8), np.float32), tiny_config(),
                                            device="cpu")
    got = _diff(c0, profiling.counters())
    assert (got["requests"], got["fields"], got["host_ns"]) == (0, 0, 0)
    # the next call counts again (the nesting guard was reset)
    a, b = _frames(1, 32, 48)
    engine.estimate_flow_driver_batched(a, b, tiny_config(), device="cpu")
    assert _diff(c0, profiling.counters())["requests"] == 1


def _traced_events(cfg, a, b, tmp_path, on: bool) -> list[dict]:
    prev = profiling.spans(on)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            engine.estimate_flow_driver_batched(torch.as_tensor(a), torch.as_tensor(b), cfg)
    finally:
        profiling.spans(prev)
    path = tmp_path / f"trace-{on}.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and str(e.get("name", "")).startswith("mf.")]


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_off_leave_no_event(tmp_path):
    a, b = _frames(1, 16, 24)
    assert _traced_events(MotionConfig(**SMALL), a, b, tmp_path, on=False) == []
    # off: one shared null context, whatever the name and arguments
    assert profiling.span("level", level=1) is profiling.span("round", cur=2)


def test_spans_on_nest_stage_in_driver(tmp_path, cold_tables):
    cfg = MotionConfig(**SMALL)
    a, b = _frames(1, 16, 24)
    ev = _traced_events(cfg, a, b, tmp_path, on=True)
    named = lambda n: sorted((e for e in ev if e["name"] == n), key=lambda e: e["ts"])
    (driver,) = named("mf.driver")
    assert all(_inside(e, driver) for e in ev)
    for stage in ("mf.upscale", "mf.pad", "mf.pyramid", "mf.subsample"):
        assert len(named(stage)) == 1, stage
    levels = named("mf.level")
    assert len(levels) == cfg.num_levels
    # coarse to fine, one after another, after the pyramid
    assert all(x["ts"] + x["dur"] <= y["ts"] for x, y in zip(levels, levels[1:]))
    assert named("mf.pyramid")[0]["ts"] + named("mf.pyramid")[0]["dur"] <= levels[0]["ts"]
    # a level's stages lie inside it: the main and rival gathers, the
    # volumes, the argmin, the rival, a round and a subdivision a block
    # size bs, bs / 2, ..., 2
    rounds = cfg.block_sizes[0].bit_length() - 1
    for level in levels:
        inner = [e["name"] for e in ev if e is not level and _inside(e, level)
                 and not e["name"].startswith("mf.sync.")]
        assert inner.count("mf.gather") == 2 and inner.count("mf.volumes") == 1
        assert inner.count("mf.argmin") == 1 and inner.count("mf.rival") == 1
        assert inner.count("mf.round") == rounds and inner.count("mf.subdivide") == rounds
    assert len(named("mf.transfer")) == cfg.num_levels - 1
    # every counted sync, a table's first copy, lies inside its stage
    stage_of = {"mf.sync.resize": "mf.upscale", "mf.sync.pyramid": "mf.pyramid",
                "mf.sync.argmin": "mf.argmin", "mf.sync.transfer": "mf.transfer",
                "mf.sync.tables": "mf.round"}
    syncs = [e for e in ev if e["name"].startswith("mf.sync.")]
    assert len(syncs) == len(profiling._TABLES) > 0
    for e in syncs:
        assert any(_inside(e, s) for s in named(stage_of[e["name"]])), e["name"]


def test_trace_turns_spans_on_and_restores_them(tmp_path, cold_tables):
    a, b = _frames(1, 16, 24)
    assert profiling.span("driver") is profiling.span("level")  # off by default
    with profiling.trace(str(tmp_path)):
        assert profiling.span("driver") is not profiling.span("level")
        engine.estimate_flow_driver_batched(torch.as_tensor(a), torch.as_tensor(b),
                                            MotionConfig(**SMALL))
    assert profiling.span("driver") is profiling.span("level")
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"mf.driver", "mf.level", "mf.sync.argmin"} <= names
    # an earlier state, on, is kept too
    prev = profiling.spans(True)
    try:
        with profiling.trace(str(tmp_path / "again")):
            pass
        assert profiling.span("driver") is not profiling.span("level")
    finally:
        profiling.spans(prev)


WRAPPERS = [gather.gather_windows, cv_diff.pooled_cvs, cv_diff.deep_pooled_cvs,
            reg_step.color_round_stored, fused_step.color_round_hybrid,
            fused_step.color_round_hybrid_tail, sad_search.sad_spiral_argmin,
            kres.resize_linear_u8, kres.pyrdown_u8]


def test_wrappers_keep_their_launch_counters_with_spans_on():
    """The wrappers' ``.launches`` are the benchmark's launch check: spans
    wrap no wrapper, and the plain versions (CPU tensors) launch nothing."""
    before = [fn.launches for fn in WRAPPERS]
    assert all(isinstance(n, int) for n in before)
    a, b = _frames(1, 16, 24)
    prev = profiling.spans(True)
    try:
        engine.estimate_flow_driver_batched(a, b, MotionConfig(**SMALL), device="cpu")
    finally:
        profiling.spans(prev)
    assert [fn.launches for fn in WRAPPERS] == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,batch", [("default", 8), ("search-centred", 8),
                                        ("host-arrays", 1)])
def test_every_sync_on_the_card_is_counted(cuda, name, batch):
    """A warmed request of each cell's configuration at its size (640x480
    frames upscaled 4x) under PyTorch's sync debug mode: every
    synchronising call it warns of is a sync the counters count, site by
    site as the code says (none in a clip batch, whose tables are on the
    card; the two frames of a host-array pair), and spans change no
    launch."""
    cfg = MotionConfig(window_center="search" if name == "search-centred" else "pred")
    host = name == "host-arrays"
    ta, tb, dev = _inputs(*_frames(batch, 480, 640, seed=7), host, cuda)
    engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)  # the build, the tables
    torch.cuda.synchronize(cuda)
    launches0 = sum(fn.launches for fn in WRAPPERS)
    c0 = profiling.counters()
    warned = []  # (file, the Python stack) of each sync PyTorch warns of

    def keep(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice, once a process, that it is a prototype is
        # no sync
        if "called a synchronizing CUDA operation" in str(message):
            warned.append((filename, "".join(traceback.format_stack(limit=6)[:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    got = _diff(c0, profiling.counters())
    launches = sum(fn.launches for fn in WRAPPERS) - launches0
    want = syncs_from_the_code(cfg, host)
    # every sync PyTorch warns of is made inside the counting helpers
    stray = [stack for f, stack in warned if Path(f) != Path(profiling.__file__)]
    assert not stray, "\n".join(stray)
    assert got["syncs_by_site"] == want
    assert len(warned) == got["syncs"] == sum(want.values())
    tables = tables_from_the_code(cfg, "cuda")
    assert {k: got["table_hits_by_site"].get(k, 0) for k in tables} == tables
    assert "pyramid" not in got["table_hits_by_site"]
    torch.cuda.synchronize(cuda)
    prev = profiling.spans(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            launches1 = sum(fn.launches for fn in WRAPPERS)
            engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
    finally:
        profiling.spans(prev)
    assert sum(fn.launches for fn in WRAPPERS) - launches1 == launches > 0
