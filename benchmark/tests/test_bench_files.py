"""BENCHMARK.json and the files it names: present, loadable, within the
contract's limits of names, units and sizes."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_allowed_keys_and_names(kind, keys):
    names = [e["name"] for e in SPEC[kind]]
    assert len(set(names)) == len(names)
    for e in SPEC[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_name_existing_configs_traffic_and_metrics():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(data["motion_config"])
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


def test_check_fits_the_time_budget_with_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_names_an_entry_a_mesh_and_a_reference_that_resolve():
    """The configuration's optional keys, as every cell has them: the entry
    resolves under the program's package, a mesh only where ``chips`` is
    above 1 and then of that size, the reference a module of
    ``benchmark/reference/`` with ``estimate`` and ``mismatched_pixels``."""
    import math

    from benchmark import harness

    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert callable(harness.resolve_entry(cell.entry))
        if cell.mesh is None:
            assert cell.chips == 1
        else:
            assert cell.chips > 1 and math.prod(cell.mesh["shape"]) == cell.chips
        ref = harness.reference_module(cell.reference)
        assert callable(ref.estimate) and callable(ref.mismatched_pixels)


MESH4 = {"shape": [2, 2], "axes": ["ty", "tx"]}


@pytest.mark.parametrize("chips,keys,refused", [
    (1, {"mesh": {"shape": [1], "axes": ["batch"]}}, "a mesh on a one-chip cell"),
    (4, {}, "4 chips and no mesh"),
    (4, {"mesh": {"shape": [2], "axes": ["ty"]}}, "a mesh of 2 for 4 chips"),
    (4, {"mesh": {"shape": [2, 2], "axes": ["ty"]}}, "is not"),
    (4, {"mesh": MESH4, "entry": "parallel.tiled.no_such_entry"}, "does not resolve"),
    (4, {"mesh": MESH4, "entry": "no_such_module.entry"}, "does not resolve"),
    (1, {"entry": "benchmark.tests.no_such_module.entry"}, "does not resolve"),
    (1, {"entry_kwargs": ["axis", "ty"]}, "entry_kwargs"),
    (1, {"reference": "no_such_reference"}, "no reference"),
    (1, {"reference": "../flow"}, "not a module name"),
    (1, {"reference": "__init__"}, "has no ['estimate', 'mismatched_pixels']"),
])
def test_a_cell_the_harness_cannot_run_is_refused_before_any_work(chips, keys, refused):
    from benchmark import harness

    cell = harness.load_cell("default-interp4-640x480.clip-b8")
    cell.chips = chips
    cell.config = dict(cell.config, **keys)
    with pytest.raises(ValueError, match=re.escape(refused)):
        harness.check_cell(cell)
    harness.check_cell(harness.load_cell("default-interp4-640x480.clip-b8"))


def test_the_tiled_entries_resolve_with_a_mesh_of_the_cells_chips():
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    from benchmark import harness

    cell = harness.load_cell("default-interp4-640x480.clip-b8")
    cell.chips = 4
    cell.config = dict(cell.config, mesh=MESH4, entry="parallel.tiled.estimate_flow_padded_tiled",
                       entry_kwargs={"axis": "ty", "axis_x": "tx"})
    harness.check_cell(cell)
    assert harness.resolve_entry(cell.entry) is tiled.estimate_flow_padded_tiled


def test_a_one_chip_cell_without_the_new_keys_runs_in_this_process_as_before(
        tiny_cell, monkeypatch):
    """``run.py`` starts no process for a one-chip cell and runs it here;
    the run calls ``engine.estimate_flow_driver_batched`` a request and
    holds its sample to ``benchmark.reference.flow``."""
    import subprocess
    import time

    import torch
    from blockbasedmotionestimation_tpu_torch.models import engine

    from benchmark import harness, ranks, run
    from benchmark.reference import flow

    def no_process(*args, **kw):
        raise AssertionError("a one-chip cell started a process")
    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(ranks, "launch", no_process)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    runs = []

    def recorded(cell, seed, seconds, trace, device, t_start, ranks=None):
        runs.append((cell.name, cell.chips, device, ranks))
        return {"correct": True}, []
    monkeypatch.setattr(harness, "run", recorded)
    monkeypatch.setattr(harness, "foreign_modules", lambda: [])  # this process's other tests
    assert run.main(["--workload", "default-interp4-640x480.clip-b8", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert runs == [("default-interp4-640x480.clip-b8", 1, "cuda", None)]
    monkeypatch.undo()

    calls = {"driver": 0, "reference": 0}
    driver, estimate = engine.estimate_flow_driver_batched, flow.estimate

    def counted_driver(*args, **kw):
        calls["driver"] += 1
        return driver(*args, **kw)

    def counted_reference(*args, **kw):
        calls["reference"] += 1
        return estimate(*args, **kw)
    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(engine, "estimate_flow_driver_batched", counted_driver)
    monkeypatch.setattr(flow, "estimate", counted_reference)
    cell = tiny_cell(check_fields=2)
    res = harness.run(cell, 2**33 + 17, 0.3, False, "cpu", time.perf_counter())[0]
    assert res["correct"] is True and res["device"]["count"] == 1
    assert calls["driver"] == res["attempted"] + cell.traffic["warmup_requests"]
    assert calls["reference"] == 2
