"""The full-HD ``cv_fused=4`` cell: its work models at a geometry worked by
hand, its three readers on hand-made traces and counters, and a run of
the cell at a test's size that never reaches the work model of the other
forms (``work/levels.py``, which refuses the capacity modes)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, tracing
from benchmark.work import cv_diff, fused, fused_step, peaks, sad_search
from benchmark.work import levels as levels_mod

ROOT = Path(__file__).resolve().parents[2]
CELL = "fused4-interp4-1920x1080.clip-b8"
READERS = ("fused_cv_roofline", "fused_round_roofline", "volumes.stored_gb_per_field")
# the benchmark's readers that read any cell, and those whose work model
# refuses the capacity modes
GENERIC = ("device.idle_pct", "engine.launches_per_field", "ops.device_ms_per_field",
           "engine.syncs_per_field")
REFUSING = ("cv_diff_roofline", "fused_step_roofline", "sad_search_roofline")
VOLUME = "void (anonymous namespace)::pooled_cvs_kernel<32, 0>(unsigned char const*, int)"
ROUND = "void (anonymous namespace)::round_kernel<(Form)4, 2, false>(RoundArgs)"


def _fields(**over):
    return dict(harness.motion_fields(harness.load_cell(CELL).config), **over)


# one level of 8 px blocks on a 16x16 frame, 16 px search (S = 4), rival
# radius 2, cv_fused = 4: both windows store cur 8 only, round 8 is D and
# rounds 4 and 2 recompute
SMALL = dict(block_sizes=[8], search_sizes=[16], rival_radius=[2], interp_factor=1)


def test_level_geometry_of_the_cell():
    lv = fused.fused_levels(_fields(), 1080, 1920)
    assert [(x["h"], x["w"]) for x in lv] == [(4352, 7680), (2176, 3840), (1088, 1920),
                                              (544, 960)]
    assert [(x["r"], x["r2"]) for x in lv] == [(16, 12), (16, 16), (16, 8), (16, 8)]
    assert all(x["stored"] == [8, 16, 32] and x["fuse"] == 4 for x in lv)


def test_volume_work_by_hand():
    # main: the frame (256) and 4 windows of 16^2 read, the cur 8 volume
    # 81 deltas x 2 x 2 cells x u16 written; 3 ops x 4 parents x 81 deltas x 64 px
    # rival: 4 windows of 12^2, 25 deltas
    assert fused.volume_calls(_fields(**SMALL), 16, 16, 1) == [
        (256 + 4 * 256 + 81 * 4 * 2, 3 * 4 * 81 * 64),
        (256 + 4 * 144 + 25 * 4 * 2, 3 * 4 * 25 * 64),
    ]


def test_round_work_by_hand():
    # cur 8 (D): 4 cells a sweep, 2 sweeps; grid 2x2 x 8 bytes each way,
    # both windows' centres 4 x 8 x 2, a u16 entry a cell a step; 243 ops a
    # cell a step.  cur 4 and 2 (kernel 12): 32 and 128 cells; the grid
    # both ways, the centres, the frame (256) and both windows
    # 4 x (16^2 + 12^2) once; 27 * cur^2 + 243 ops a cell a step
    windows = 256 + 4 * (256 + 144)
    assert fused.round_calls(_fields(**SMALL), 16, 16, 1) == [
        (2 * 32 + 64 + 8 * 2, 8 * 243),
        (2 * 128 + 64 + windows, 32 * (27 * 16 + 243)),
        (2 * 512 + 64 + windows, 128 * (27 * 4 + 243)),
    ]


def test_bounds_are_sums_of_the_calls():
    f = _fields()
    assert fused.volume_bound_ms(f, 1080, 1920, 8) == pytest.approx(
        sum(peaks.bound_ms(*c) for c in fused.volume_calls(f, 1080, 1920, 8)))
    assert fused.round_bound_ms(f, 1080, 1920, 8) == pytest.approx(
        sum(peaks.bound_ms(*c) for c in fused.round_calls(f, 1080, 1920, 8)))
    # the stored rounds count as the other forms' rounds do
    d = fused.round_calls(f, 1080, 1920, 8)[0]
    assert d == fused_step.round_call(8, 136, 240, 136, 240, 2, True, 4)


@pytest.mark.parametrize("over", [dict(cv_fused=None), dict(cv_compact=64),
                                  dict(window_center="search"), dict(block_sizes=[12, 32])])
def test_the_model_refuses_other_forms(over):
    with pytest.raises(ValueError):
        fused.fused_levels(_fields(**over), 1080, 1920)


def _stretch(events, requests=2, counted=2):
    ctx = {"fields": _fields(), "height": 1080, "width": 1920, "batch": 8}
    return tracing.Stretch(events, requests, requests * 8, {"pooled_cvs_kernel", "round_kernel"},
                           counted, ctx, request=None)


def _x(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_roofline_readers_on_a_hand_made_trace():
    st = _stretch([_x(VOLUME, 0, 150_000), _x(ROUND, 150_000, 20_000), _x(ROUND, 170_000, 5_000)])
    f = _fields()
    cv = harness.load_metric("fused_cv_roofline")(st)
    rd = harness.load_metric("fused_round_roofline")(st)
    assert cv == pytest.approx(100 * 2 * fused.volume_bound_ms(f, 1080, 1920, 8) / 150)
    assert rd == pytest.approx(100 * 2 * fused.round_bound_ms(f, 1080, 1920, 8) / 25)
    assert 0 < cv < 100 and 0 < rd < 100
    # nothing to read without the kernel
    assert harness.load_metric("fused_cv_roofline")(_stretch([_x(ROUND, 0, 10)])) is None
    assert harness.load_metric("fused_round_roofline")(_stretch([_x(VOLUME, 0, 10)])) is None


@pytest.fixture
def counters(monkeypatch):
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    def set_to(value):
        monkeypatch.setattr(profiling, "counters", lambda: value)
    return set_to


def _counts(requests, fields, volume_bytes=None):
    c = {"requests": requests, "fields": fields, "syncs": 0}
    if volume_bytes is not None:
        c["volume_bytes"] = volume_bytes
    return c


def test_volume_reader_divides_the_runs_bytes_by_its_fields(counters):
    read = harness.load_metric("volumes.stored_gb_per_field")
    counters(_counts(20, 160, volume_bytes=160 * 3_398_178_960))
    assert read(_stretch([])) == pytest.approx(3.39817896)
    counters(_counts(20, 150, volume_bytes=10**12))   # another batch than the cell's
    assert read(_stretch([])) is None
    counters(_counts(1, 8, volume_bytes=10**12))      # fewer requests than the stretch
    assert read(_stretch([])) is None
    counters(_counts(20, 160))                        # a program without the counter
    assert read(_stretch([])) is None


def test_volume_reader_reads_nothing_without_counters(monkeypatch):
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert harness.load_metric("volumes.stored_gb_per_field")(_stretch([])) is None


def test_the_cells_readers_never_reach_the_other_forms_work_model(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("work/levels.levels reached")
    for mod in (levels_mod, cv_diff, fused_step, sad_search):
        monkeypatch.setattr(mod, "levels", refuse)
    cell = harness.load_cell(CELL)
    assert sorted(m["name"] for m in cell.per_layer) == sorted(READERS + GENERIC)
    st = _stretch([_x(VOLUME, 0, 150_000), _x(ROUND, 150_000, 20_000)])
    for m in cell.per_layer:
        harness.load_metric(m["name"])(st)
    assert {m["name"] for m in cell.end_to_end} == {"fields_per_s", "peak_mem_gb", "setup_s"}


def test_the_cell_is_in_no_metric_it_cannot_read():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {m["name"] for m in spec["per_layer"]} == set(READERS + GENERIC + REFUSING)
    for m in spec["per_layer"]:
        assert (CELL in m["workloads"]) == (m["name"] not in REFUSING), m["name"]


def test_a_traced_run_of_the_cell_reports_the_volume_bytes():
    """A whole traced run of the cell at the tests' size on the CPU, in a
    process of its own (the counters are the process's): correct, and the
    volume metric is the counted bytes over the fields, the fused form's
    alone; no kernel ran, so the device's readers read nothing."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})
from benchmark import harness
from conftest import tiny
cell = tiny(harness.load_cell({CELL!r}), check_fields=1)
res = harness.run(cell, 2**34 + 9, 0.2, True, "cpu", time.perf_counter())[0]
from blockbasedmotionestimation_tpu_torch.utils import profiling
print(json.dumps([res, profiling.counters()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res, counted = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["checks"]["mismatched_px"]["value"] == 0
    # no kernel ran, no device was traced: the program's counters alone read
    assert set(res["metrics"]) == {"volumes.stored_gb_per_field", "engine.syncs_per_field"}
    assert res["metrics"]["volumes.stored_gb_per_field"]["value"] == \
        counted["volume_bytes"] / counted["fields"] / 1e9
    assert set(counted["volume_bytes_by_form"]) == {"fused"}
    # two levels of 8 px blocks: round 8 stored, rounds 4 and 2 fused, a level
    assert counted["rounds_by_form"] == {"stored": 2 * counted["requests"],
                                         "fused": 4 * counted["requests"]}
