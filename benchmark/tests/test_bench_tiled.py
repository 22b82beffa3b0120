"""The 4-card tiled 4K cell (``tiled2x2-fused4-interp4-3840x2160.clip-b8``):
its files load through the harness's checks; its reference in bands of
parent rows (``reference/flow_bands.py``) equals ``reference/flow.py`` bit
for bit over several devices, and its bfloat16 control differs; its five
readers on hand-made stretches; and the cell's form, cut to a CPU's size,
served by four gloo ranks through the harness."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import gen, harness, tracing
from benchmark.reference import flow, flow_bands
from benchmark.tests.test_bench_ranks import launch, write_cell
from benchmark.work import fused

ROOT = Path(__file__).resolve().parents[2]
NAME = "tiled2x2-fused4-interp4-3840x2160.clip-b8"
NEW = ("tiled.exchange_ms_per_field", "tiled.exchange_mb_per_field", "tiled.fused_cv_roofline",
       "tiled.fused_round_roofline", "tiled.ops_device_ms_per_field")
CPUS = [torch.device("cpu")] * 3


def test_the_cell_names_the_tiled_driver_its_mesh_and_the_banded_reference():
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    cell = harness.load_cell(NAME)
    assert cell.chips == 4 and cell.mesh == {"shape": [2, 2], "axes": ["ty", "tx"]}
    assert harness.resolve_entry(cell.entry) is tiled.estimate_flow_driver_tiled
    assert cell.entry_kwargs == {"axis": "ty", "axis_x": "tx"}
    assert harness.reference_module(cell.reference) is flow_bands
    assert cell.config["reduced"] == [] and cell.traffic["check_fields"] == 8
    fused4 = harness.load_cell("fused4-interp4-1920x1080.clip-b8")
    assert cell.config["motion_config"] == fused4.config["motion_config"]
    assert cell.traffic == fused4.traffic
    assert {m["name"] for m in cell.end_to_end} == {"fields_per_s", "peak_mem_gb", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names
    assert {"device.idle_pct", "engine.launches_per_field", "engine.syncs_per_field",
            "volumes.stored_gb_per_field"} <= names
    # the whole-batch readers would count four ranks' work against one, and
    # the generic plain-ops reader would count NCCL's kernels as plain ops
    assert not {"cv_diff_roofline", "fused_step_roofline", "fused_cv_roofline",
                "fused_round_roofline", "ops.device_ms_per_field"} & names


@pytest.mark.parametrize("npy,n,want", [
    (8, 3, [(0, 3), (3, 6), (6, 8)]),
    (272, 4, [(0, 68), (68, 136), (136, 204), (204, 272)]),
    (2, 4, [(0, 1), (1, 2)]),
    (5, 1, [(0, 5)]),
])
def test_band_rows_cover_the_parents_in_order(npy, n, want):
    assert flow_bands.band_rows(npy, n) == want


def _frames(h, w, seed, b=2):
    tr = harness.load_cell("default-interp4-640x480.clip-b8").traffic
    tr = dict(tr, batch=b, pool_requests=1, object_px=[h // 6, 2 * h // 5],
              pan_px=max(1, h // 30), object_motion_px=max(2, h // 14))
    f = gen.pool(tr, h, w, seed, "cpu")
    return f[:b], f[1:b + 1]


BASE = harness.motion_fields(harness.load_cell(NAME).config)


@pytest.mark.parametrize("over,frame,chunk", [
    # the cell's form, cv_fused=4's fields, at 8 px blocks (13 parent rows
    # at level 0: bands of 5, 4 and 4)
    (dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None)), (25, 37), None),
    (dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None)), (25, 37), 1 << 14),
    (dict(block_sizes=(8, 8), search_sizes=(16, 24), window_center="search", interp_factor=3),
     (28, 42), None),
    (dict(block_sizes=(16, 16, 16), search_sizes=(32, 32, 32), rival_radius=(4, None, 4),
          interp_factor=1), (100, 150), None),
    (dict(block_sizes=(8, 16), search_sizes=(24, 40), cost="ssd", window_center="search",
          reg_radius=3, interp_factor=1), (100, 150), 1 << 16),
    (dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_window=False, mv_cap=8,
          interp_factor=1), (100, 150), None),
])
def test_bands_equal_the_whole_field_reference(over, frame, chunk, monkeypatch):
    """Over three devices, the bands cutting the parent rows unevenly, and
    a few parent rows a call of ``flow.volumes`` (``chunk``: one or two
    rows), the banded reference gives ``flow.py``'s flow bit for bit."""
    if chunk is not None:
        monkeypatch.setattr(flow_bands, "CHUNK_BYTES", chunk)
    fields = dict(BASE, **over)
    im1, im2 = _frames(*frame, 5)
    want = flow.estimate(im1, im2, fields)
    got = flow_bands.estimate(im1, im2, fields, devices=CPUS)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert flow_bands.mismatched_pixels(got, want) == 0 and torch.equal(got, want)
    assert torch.equal(flow_bands.estimate(im1, im2, fields), want)  # one band
    assert torch.unique(want[..., 0]).numel() > 3  # the motion is not trivial


@pytest.mark.parametrize("seed", [31, 2**33 + 7])
def test_the_bfloat16_control_differs(seed):
    fields = dict(BASE, block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None))
    im1, im2 = _frames(25, 37, seed)
    want = flow_bands.estimate(im1, im2, fields, devices=CPUS)
    low = flow_bands.estimate(im1, im2, fields, energy_dtype=torch.bfloat16, devices=CPUS)
    assert flow_bands.mismatched_pixels(low, want) > 0


def test_the_banded_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.flow_bands; "
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'blockbasedmotionestimation_tpu', 'blockbasedmotionestimation_tpu_torch'));"
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


NCCL_P2P = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
NCCL_GATHER = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
VOLUME = "void (anonymous namespace)::pooled_cvs_kernel<32, 2>(unsigned char const*, int)"
ROUND = "void (anonymous namespace)::round_kernel<(anonymous namespace)::Form>(int)"


def _stretch(events, ranks=4, requests=2, batch=8):
    ctx = {"fields": BASE, "height": 2160, "width": 3840, "batch": batch, "ranks": ranks}
    return tracing.Stretch(events, requests, requests * batch,
                           {"pooled_cvs_kernel", "round_kernel"}, 0, ctx, request=None)


def test_the_exchange_reader_times_the_collective_kernels_alone():
    x = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    st = _stretch([x(VOLUME, 0, 500), x(NCCL_P2P, 600, 40), x(NCCL_GATHER, 700, 160),
                   x("void at::native::cat_kernel<int>(int*)", 900, 10)])
    read = harness.load_metric("tiled.exchange_ms_per_field")
    assert read(st) == pytest.approx(200 / 1e3 / 16)
    assert read(_stretch([x(VOLUME, 0, 500)])) is None


def test_the_tiled_roofline_counts_a_ranks_share_of_the_volumes():
    x = {"ph": "X", "cat": "kernel", "name": VOLUME, "ts": 0, "dur": 40_000}
    read = harness.load_metric("tiled.fused_cv_roofline")
    whole = fused.volume_bound_ms(BASE, 2160, 3840, 8) * 2
    assert read(_stretch([x])) == pytest.approx(100 * whole / 4 / 40)
    assert read(_stretch([x], ranks=1)) == pytest.approx(100 * whole / 40)
    assert read(_stretch([])) is None


def test_the_tiled_round_roofline_counts_a_ranks_share_of_the_rounds():
    x = {"ph": "X", "cat": "kernel", "name": ROUND, "ts": 0, "dur": 20_000}
    v = {"ph": "X", "cat": "kernel", "name": VOLUME, "ts": 30_000, "dur": 40_000}
    read = harness.load_metric("tiled.fused_round_roofline")
    whole = fused.round_bound_ms(BASE, 2160, 3840, 8) * 2
    assert read(_stretch([x, v])) == pytest.approx(100 * whole / 4 / 20)
    assert read(_stretch([x], ranks=1)) == pytest.approx(100 * whole / 20)
    assert read(_stretch([v])) is None


def test_the_tiled_plain_ops_reader_leaves_out_the_port_and_the_collectives():
    x = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    plain = [x("void at::native::cat_kernel<int>(int*)", 900, 10),
             x("void at::native::elementwise_kernel<128, 2>(int)", 950, 30)]
    st = _stretch([x(VOLUME, 0, 500), x(ROUND, 520, 50), x(NCCL_P2P, 600, 40),
                   x(NCCL_GATHER, 700, 160)] + plain)
    read = harness.load_metric("tiled.ops_device_ms_per_field")
    assert read(st) == pytest.approx(40 / 1e3 / 16)
    # the generic reader counts the collectives as plain ops
    assert harness.load_metric("ops.device_ms_per_field")(st) == pytest.approx(240 / 1e3 / 16)
    assert read(_stretch([x(VOLUME, 0, 500), x(NCCL_P2P, 600, 40)])) is None


def test_the_exchange_bytes_reader_reads_the_programs_counter(monkeypatch):
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    read = harness.load_metric("tiled.exchange_mb_per_field")
    counted = dict(profiling.counters(), requests=5, fields=40, exchange_bytes=8_000_000_000)
    monkeypatch.setattr(profiling, "counters", lambda: counted)
    assert read(_stretch([])) == pytest.approx(200.0)
    counted["fields"] = 39  # a request of another batch
    assert read(_stretch([])) is None
    del counted["exchange_bytes"]  # a program without the counter
    counted["fields"] = 40
    assert read(_stretch([])) is None


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_serve_the_tiled_cell(tmp_path, trace):
    """The cell's entry, mesh, entry arguments and reference on the
    default's two levels of 8 px blocks with ``cv_fused=4`` at 72x96 frames
    (288x384 once upscaled, both levels on 2 x 2 tiles), four gloo ranks:
    correct, and traced, the exchange bytes read from rank 0's counters."""
    real = harness.load_cell(NAME).config
    spec = write_cell(tmp_path, 4, **{k: real[k] for k in ("entry", "mesh", "entry_kwargs",
                                                            "reference")},
                      motion_config={"cv_fused": 4})
    data = json.loads(spec.read_text())
    data["per_layer"] += [{k: v for k, v in m.items() if k != "workloads"}
                          for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                          if m["name"] in NEW]
    spec.write_text(json.dumps(data))
    code, out, err, _ = launch(spec, 4, trace)
    assert code == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["count"] == 4
    assert res["checks"]["mismatched_px"]["value"] == 0
    assert res["checks"]["fields_checked"]["value"] == 4
    if trace:  # on the CPU the trace holds no device operation to read
        assert res["metrics"]["tiled.exchange_mb_per_field"]["value"] > 0
        assert "tiled.exchange_ms_per_field" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"fields_per_s", "latency_ms_p95", "peak_mem_gb",
                                       "setup_s"}
