"""A cell on several ranks, on the CPU over gloo: the launcher starts one
worker a rank, rank 0 alone reports, the check sees a fault on another
rank, and a rank that raises or hangs ends the run with no result.

Each test writes a benchmark of one cell to a temporary directory: the
default configuration cut to 72x96 frames (two levels of 8 px blocks, 16 px
search), ``clip-b8``'s generator at batch 4, and the configuration's
``entry`` and ``mesh``."""

from __future__ import annotations

import io
import json
import time
from pathlib import Path

import pytest

from benchmark import harness, ranks

ROOT = Path(__file__).resolve().parents[2]
CELL = "ranks.b4"
SEED = 2**33 + 41


def write_cell(tmp_path: Path, chips: int, frame=(72, 96), **config) -> Path:
    """A benchmark of the one cell ``ranks.b4`` in ``tmp_path``; returns the
    path of its ``BENCHMARK.json``."""
    cfg = json.loads((ROOT / "benchmark/configs/default-interp4-640x480.json").read_text())
    motion = dict(cfg["motion_config"], block_sizes=[8, 8], search_sizes=[16, 16],
                  rival_radius=[2, None], **config.pop("motion_config", {}))
    cfg.update(name="ranks", frame={"height": frame[0], "width": frame[1]},
               motion_config=motion, **config)
    traffic = json.loads((ROOT / "benchmark/traffic/clip-b8.json").read_text())
    traffic.update(batch=4, pool_requests=2, object_px=[12, 40], pan_px=2, object_motion_px=3,
                   check_fields=4, trace_requests=2)
    for sub, name, data in (("configs", "ranks", cfg), ("traffic", "b4", traffic)):
        (tmp_path / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
        (tmp_path / "benchmark" / sub / f"{name}.json").write_text(json.dumps(data))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = dict(
        real,
        configs=[{"name": "ranks", "source": cfg["source"], "file": "benchmark/configs/ranks.json",
                  "reduced": [], "why": "the rank tests' cell"}],
        workloads=[{"name": CELL, "config": "ranks", "traffic": "b4", "chips": chips,
                    "why": "the rank tests' cell"}],
        end_to_end=[{k: v for k, v in m.items() if k != "workloads"} for m in real["end_to_end"]],
        per_layer=[m for m in real["per_layer"] if "workloads" not in m])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json"


def batch_cell(tmp_path: Path, entry="parallel.tiled.estimate_flow_batch") -> Path:
    return write_cell(tmp_path, 4, entry=entry, mesh={"shape": [4], "axes": ["batch"]})


def launch(spec: Path, chips: int, trace=0, seconds=1.0, **kw):
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    code = ranks.launch(CELL, SEED, seconds, trace, chips, "cpu", t, spec=spec, out=out,
                        err=err, **kw)
    return code, out.getvalue(), err.getvalue(), time.perf_counter() - t


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_serve_the_cell_and_rank_0_alone_reports(tmp_path, trace):
    spec = batch_cell(tmp_path)
    cell = harness.load_cell(CELL, spec)
    code, out, err, _ = launch(spec, 4, trace)
    assert code == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["count"] == 4 and res["device"]["platform"] == "cpu"
    assert res["checks"]["mismatched_px"]["value"] == 0
    if trace:  # on the CPU the trace holds no device operation to read
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "window_s" in res["device"] and "breakdown" in res
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    # rank 0's check lines end standard error; every field of the window counted
    tail = err.strip().splitlines()[-3:]
    assert tail[0].startswith("check mismatched_px: 0") and "correct=true" in tail[2]
    assert f"fields of {res['attempted'] * 4} compared" in tail[2]
    assert not any("check" in ln for ln in err.splitlines() if ln.startswith("[rank "))


def test_a_rank_that_breaks_the_launch_rule_withholds_the_per_layer_metrics(tmp_path):
    """Rank 1's pyrDown wrapper counts a launch a request that its trace
    does not hold: rank 1 is named in the trace lines, and rank 0, whose
    stretch keeps the rule, reports no per-layer metric."""
    code, out, err, _ = launch(batch_cell(tmp_path, "benchmark.tests.rank_faults."
                                                    "miscounted_on_rank_1"), 4, trace=1)
    assert code == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"] == {}
    named = [ln for ln in err.splitlines() if ln.startswith("trace: rank 1: device-alone")]
    assert len(named) == 3 and all("pyrdown_u8" in ln for ln in named)
    assert "trace: ranks [1] broke the launch rule" in err
    assert "trace: rank 2" not in err and "trace: rank 3" not in err


def test_a_fault_on_rank_2_is_not_correct(tmp_path):
    """One MV moved in rank 2's chunk, where it is produced: the gathered
    flow rank 0 holds carries it, and the sample holds every batch slot."""
    code, out, err, _ = launch(batch_cell(tmp_path, "benchmark.tests.rank_faults."
                                                    "one_mv_moved_on_rank_2"), 4)
    assert code == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False and res["checks"]["mismatched_px"]["value"] > 0


def test_a_rank_that_raises_ends_the_run_without_a_result(tmp_path):
    code, out, err, seconds = launch(batch_cell(tmp_path, "benchmark.tests.rank_faults."
                                                          "raises_on_rank_1"), 4)
    assert code != 0 and out == ""
    assert seconds < ranks.RUN_TIMEOUT_S
    assert "a fault planted on rank 1" in err and "ranks: rank 1 ended with 1" in err


def test_a_rank_that_hangs_ends_the_run_without_a_result_at_the_timeout(tmp_path):
    code, out, err, seconds = launch(batch_cell(tmp_path, "benchmark.tests.rank_faults."
                                                          "hangs_on_rank_1"), 4, timeout_s=40)
    assert code != 0 and out == ""
    assert 40 <= seconds < 60
    assert "had not ended 40 s after the workers started" in err


@pytest.mark.parametrize("entry,correct", [
    ("parallel.tiled.estimate_flow_padded_batch_tiled", True),
    ("benchmark.tests.rank_faults.padded_tiled_without_exchange", False),
])
def test_two_row_tiles_through_the_padded_tiled_entry(tmp_path, entry, correct):
    """Two ranks, one row strip each, with the halo, ghost-row and rival
    exchanges: ``estimate_flow_padded_batch_tiled`` on frames that need no
    padding (160x192, no upscale: the driver's flow is then the padded
    engine's), held to the same reference; with the exchanges left out,
    not correct."""
    from blockbasedmotionestimation_tpu_torch.config import MotionConfig
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    spec = write_cell(tmp_path, 2, frame=(160, 192), entry=entry,
                      mesh={"shape": [2], "axes": ["ty"]},
                      entry_kwargs={"batch_axis": None, "axis": "ty"},
                      motion_config={"interp_factor": 1})
    cell = harness.load_cell(CELL, spec)
    cfg = MotionConfig.from_fields(harness.motion_fields(cell.config))
    assert all(lv["rows_ok"] for lv in tiled.plan_tiling(cfg, 160, 192, 2))
    code, out, err, _ = launch(spec, 2)
    assert code == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is correct and res["device"]["count"] == 2
    assert (res["checks"]["mismatched_px"]["value"] == 0) is correct
