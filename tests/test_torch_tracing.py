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


def syncs_from_the_code(cfg: MotionConfig, host_arrays: bool) -> dict:
    """Syncs a request of ``estimate_flow_driver_batched`` makes, site by
    site, read from the code: each copy of a host table to the device
    (``profiling.upload``) waits for the stream."""
    levels = cfg.num_levels
    want = {
        # resize_linear_u8: 4 row and 4 column tables, a frame
        "resize": 2 * 8 if cfg.interp_factor > 1 else 0,
        # pyrdown_u8: a row and a column index, a level below the finest,
        # both frames
        "pyramid": 2 * 2 * (levels - 1),
        # transfer_mvs: a row and a column index, a level below the coarsest
        "transfer": 2 * (levels - 1),
        # spiral_argmin of the fused windowed level: the rank table, dy, dx
        "argmin": 3 * levels if cfg.uses_fused_windowed else 0,
        # _as_frames: both frames, when they come as host arrays
        "frames": 2 if host_arrays else 0,
    }
    return {k: v for k, v in want.items() if v}


def _diff(c0: dict, c1: dict) -> dict:
    out = {k: c1[k] - c0[k] for k in ("requests", "fields", "host_ns", "syncs", "sync_ns")}
    sites = {k: v - c0["syncs_by_site"].get(k, 0) for k, v in c1["syncs_by_site"].items()}
    out["syncs_by_site"] = {k: v for k, v in sites.items() if v}
    return out


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
    engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)  # tables copied once a process
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
    """The counts PERF.md derives: 46 a request of 8 fields in the default
    clip cell, 34 in the search-centred one, 48 a pair in the live cell."""
    per = lambda cfg, host, batch: sum(syncs_from_the_code(cfg, host).values()) / batch
    assert per(MotionConfig(), False, 8) == 5.75
    assert per(MotionConfig(window_center="search"), False, 8) == 4.25
    assert per(MotionConfig(), True, 1) == 48


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


def test_spans_on_nest_stage_in_driver(tmp_path):
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
    # every counted sync lies inside its stage
    stage_of = {"mf.sync.resize": "mf.upscale", "mf.sync.pyramid": "mf.pyramid",
                "mf.sync.argmin": "mf.argmin", "mf.sync.transfer": "mf.transfer"}
    syncs = [e for e in ev if e["name"].startswith("mf.sync.")]
    assert len(syncs) == sum(syncs_from_the_code(cfg, False).values())
    for e in syncs:
        assert any(_inside(e, s) for s in named(stage_of[e["name"]])), e["name"]


def test_trace_turns_spans_on_and_restores_them(tmp_path):
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
            fused_step.color_round_hybrid_tail, sad_search.sad_spiral_argmin]


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
    """One request of each cell's configuration at its size (640x480
    frames upscaled 4x) under PyTorch's sync debug mode: every
    synchronising call it warns of is a sync the counters count, site by
    site as the code says, and spans change no launch."""
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
    torch.cuda.synchronize(cuda)
    prev = profiling.spans(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            launches1 = sum(fn.launches for fn in WRAPPERS)
            engine.estimate_flow_driver_batched(ta, tb, cfg, device=dev)
    finally:
        profiling.spans(prev)
    assert sum(fn.launches for fn in WRAPPERS) - launches1 == launches > 0
