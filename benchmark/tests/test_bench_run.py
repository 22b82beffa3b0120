"""The run's contract, on the CPU: no card, no result; no JAX loaded; and
the harness's check sees the timed path's faults."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
RUN = ["benchmark/run.py", "--workload", "default-interp4-640x480.clip-b8", "--seed", "3",
       "--seconds", "1", "--trace", "0"]


def _run(cell, seed=2**33 + 5, seconds=0.6, trace=False):
    return harness.run(cell, seed, seconds, trace, "cpu", time.perf_counter())[0]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, *RUN], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_has_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *RUN], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_whole_run_loads_no_jax():
    """The harness's imports, the program's, the reference's and a run on
    the CPU leave no module of JAX or the JAX package (by whole top-level
    name; the program's name begins with the JAX package's)."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})
import benchmark.run
from benchmark import harness, control
from conftest import tiny
cell = tiny(harness.load_cell("default-interp4-640x480.clip-b8"), check_fields=1)
harness.run(cell, 5, 0.2, True, "cpu", time.perf_counter())
print(harness.foreign_modules())
assert "blockbasedmotionestimation_tpu_torch.models.engine" in sys.modules
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["default-interp4-640x480.clip-b8", "search-centred-interp4-640x480.clip-b8",
                                  "default-interp4-640x480.live-b1"])
def test_sound_run_is_correct_and_reports_the_cells_metrics(tiny_cell, name):
    cell = tiny_cell(name)
    res = _run(cell)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks" and res["checks"]["mismatched_px"]["value"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["metrics"]["fields_per_s"]["value"] > 0
    json.dumps(res)


def _no_round(grid, *args, **kw):
    """A round that returns the grid unchanged."""


_no_round.per_round = True


CLIPS = ["default-interp4-640x480.clip-b8", "search-centred-interp4-640x480.clip-b8"]


@pytest.mark.parametrize("name,fault", [
    *[(c, f) for c in [*CLIPS, "default-interp4-640x480.live-b1"] for f in ("state_unchanged",
                                                                   "answer_altered")],
    *[(c, "half_batch") for c in CLIPS],  # live-b1's batch is one pair
])
def test_check_catches_the_faults(tiny_cell, monkeypatch, name, fault):
    """The timed path broken underneath: a round that returns its grid
    unchanged, half of the batch left out (its flow repeated), one flow
    value altered where it is produced.  One chip: no exchange to leave
    out."""
    from blockbasedmotionestimation_tpu_torch.models import engine
    from blockbasedmotionestimation_tpu_torch.ops import windowed

    cell = tiny_cell(name, check_fields=4)
    entry = engine.estimate_flow_driver_batched
    if fault == "state_unchanged":
        for name in ("color_round_stored", "color_round_hybrid", "color_round_hybrid_tail"):
            monkeypatch.setattr(windowed, name, _no_round)
    elif fault == "half_batch":
        def half(im1, im2, cfg, device=None):
            n = (im1.shape[0] + 1) // 2
            flow = entry(im1[:n], im2[:n], cfg, device)
            return torch.cat([flow, flow])[:im1.shape[0]]
        monkeypatch.setattr(engine, "estimate_flow_driver_batched", half)
    else:
        def altered(im1, im2, cfg, device=None):
            flow = entry(im1, im2, cfg, device)
            flow[:, 10, 20, 0] += 0.25
            return flow
        monkeypatch.setattr(engine, "estimate_flow_driver_batched", altered)
    res = _run(cell)
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] > 0


def test_the_control_in_the_programs_place_is_not_correct(tiny_cell, monkeypatch):
    """The harness's own decision with the control in the program's place:
    the plain reference, its energy in bfloat16, serving the window."""
    from blockbasedmotionestimation_tpu_torch.models import engine

    from benchmark.reference import flow as reference

    cell = tiny_cell("default-interp4-640x480.clip-b8", check_fields=4)
    cell.config["motion_config"].update(block_sizes=[16, 16], search_sizes=[32, 32])
    cell.config["frame"] = {"height": 32, "width": 48}
    fields = harness.motion_fields(cell.config)

    def lowered(im1, im2, cfg, device=None):
        return reference.estimate(torch.as_tensor(im1), torch.as_tensor(im2), fields,
                                  energy_dtype=torch.bfloat16)
    monkeypatch.setattr(engine, "estimate_flow_driver_batched", lowered)
    res = _run(cell, seed=2**33 + 31)
    assert res["correct"] is False
    assert res["checks"]["mismatched_px"]["value"] > 0


@pytest.mark.parametrize("k,batch,want", [(8, 8, [1] * 8), (3, 1, [3]), (5, 2, [3, 2])])
def test_the_sample_spreads_over_the_batch_slots(k, batch, want):
    s = harness.Sample(k, batch, 2**35 + 1)
    for i in range(40):
        s.offer(i, torch.arange(batch * 2.0).reshape(batch, 2) + 100 * i)
    assert [sum(1 for _, j, _ in s.kept if j == slot) for slot in range(batch)] == want
    assert len({(i, j) for i, j, _ in s.kept}) == k
    assert all(torch.equal(f, torch.tensor([2.0 * j, 2.0 * j + 1]) + 100 * i)
               for i, j, f in s.kept)
    # drawn from the whole window, not its start
    assert max(i for i, _, _ in s.kept) >= 10


@pytest.mark.requires_cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_the_card(trace):
    """One short run of the first cell on the card: the result line holds
    the cell's metrics of its kind, and is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("default-interp4-640x480.clip-b8")
    argv = [sys.executable, "benchmark/run.py", "--workload", cell.name, "--seed", "11",
            "--seconds", "3", "--trace", str(trace)]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    want = cell.per_layer if trace else cell.end_to_end
    assert res["correct"] is True and set(res["metrics"]) == {m["name"] for m in want}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
