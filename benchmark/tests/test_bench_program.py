"""The entry layer's metric that reads the program's own counters, on the
CPU."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, tracing

ROOT = Path(__file__).resolve().parents[2]
SYNCS = "engine.syncs_per_field"


def _stretch(requests=8, batch=8):
    return tracing.Stretch([], requests, requests * batch, set(), 0, {"batch": batch},
                           request=None)


def _counts(requests, fields, syncs=46 * 20, host_ms=400.0, sync_ms=100.0):
    return {"requests": requests, "fields": fields, "host_ns": int(host_ms * 1e6),
            "syncs": syncs, "sync_ns": int(sync_ms * 1e6), "syncs_by_site": {}}


@pytest.fixture
def counters(monkeypatch):
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    def set_to(value):
        monkeypatch.setattr(profiling, "counters", lambda: value)
    return set_to


def test_reader_divides_the_runs_syncs_by_its_fields(counters):
    counters(_counts(20, 160))
    assert harness.load_metric(SYNCS)(_stretch()) == pytest.approx(46 * 20 / 160)
    counters(_counts(20, 160, syncs=0, sync_ms=0.0))
    assert harness.load_metric(SYNCS)(_stretch()) == 0.0


@pytest.mark.parametrize("requests,fields", [
    (20, 150),   # a request returned another batch than the cell's
    (5, 40),     # fewer requests than the traced stretch holds
    (0, 0),      # nothing counted
])
def test_reader_reads_nothing_where_the_counts_do_not_fit_the_cell(counters, requests, fields):
    counters(_counts(requests, fields))
    assert harness.load_metric(SYNCS)(_stretch()) is None


def test_reader_reads_nothing_from_a_program_without_counters(monkeypatch):
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert harness.load_metric(SYNCS)(_stretch()) is None


def test_per_layer_sources_are_the_benchmarks_own():
    """Every per-layer metric names where its number comes from, as the
    benchmark's format has it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    known = {"device_trace", "program_span", "program_counter", "host_clock"}
    assert {m["source"] for m in spec["per_layer"]} <= known
    assert {m["name"]: m["source"] for m in spec["per_layer"]}[SYNCS] == "program_counter"


def test_a_traced_run_reports_the_counted_syncs():
    """A whole traced run of the default clip cell at the tests' size, in
    a process of its own (the counters are the process's): 2 levels and
    the x4 upscale make 16 + 4 + 2 + 6 = 28 syncs a request of 2 fields,
    besides the tables copied once a process."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})
from benchmark import harness
from conftest import tiny
cell = tiny(harness.load_cell("default-interp4-640x480.clip-b8"), check_fields=1)
res = harness.run(cell, 2**33 + 7, 0.2, True, "cpu", time.perf_counter())[0]
from blockbasedmotionestimation_tpu_torch.utils import profiling
print(json.dumps([res["metrics"], profiling.counters()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics, counted = json.loads(out.stdout.strip().splitlines()[-1])
    by_site = counted["syncs_by_site"]
    assert by_site.pop("tables") == 3  # the plain rounds' rank and slot tables
    assert by_site == {"resize": 16 * counted["requests"], "pyramid": 4 * counted["requests"],
                       "transfer": 2 * counted["requests"], "argmin": 6 * counted["requests"]}
    assert counted["fields"] == 2 * counted["requests"]
    assert metrics[SYNCS]["value"] == counted["syncs"] / counted["fields"]
