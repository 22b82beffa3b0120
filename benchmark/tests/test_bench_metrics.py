"""The metric arithmetic on a hand-made trace, and the work models held to
the kernel times the bring-up measured."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import harness, tracing
from benchmark.work import cv_diff, fused_step, peaks, sad_search

ROOT = Path(__file__).resolve().parents[2]
PORT_KERNELS = {"pooled_cvs_kernel", "round_kernel", "sad_spiral_argmin_kernel",
                "gather_windows_kernel"}
VOLUME = "void (anonymous namespace)::pooled_cvs_kernel<32, 0>(unsigned char const*, int)"
ROUND = "void (anonymous namespace)::round_kernel<(Form)0, 32, false>(RoundArgs)"
TORCH_ROUND = "void at::native::round_kernel_cuda<float>(float*)"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    return [
        _x("user_annotation", "bench.request", 0, 100),
        _x("user_annotation", "bench.engine._run_level", 5, 80),
        _x("user_annotation", "bench.kernels.pooled_cvs", 8, 10),
        _x("user_annotation", "bench.request", 150, 100),
        _x("user_annotation", "ProfilerStep#3", 0, 300),
        _x("kernel", VOLUME, 10, 30),
        _x("kernel", ROUND, 30, 30),          # overlaps the volume kernel
        _x("kernel", TORCH_ROUND, 170, 30),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200, 20),
        _x("gpu_memset", "Memset (Device)", 400, 10),  # after the stretch
        _x("gpu_user_annotation", "bench.request", 0, 100),
    ]


def _stretch(counted=2):
    ctx = {"fields": harness.motion_fields(
        json.loads((ROOT / "benchmark/configs/default-interp4-640x480.json").read_text())),
        "height": 480, "width": 640, "batch": 8}
    return tracing.Stretch(_events(), 2, 16, PORT_KERNELS, counted, ctx)


def test_union_and_stretch():
    assert tracing._union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    st = _stretch()
    assert (st.t0, st.t1, st.window_us) == (0, 250, 250)
    assert len(st.device) == 4 and st.busy() == [(10, 60), (170, 220)]
    assert st.busy_us == 100
    assert st.port_launches == 2 and st.launches_agree() and not _stretch(3).launches_agree()
    assert st.kernel_us(st.kernel_named("round_kernel")) == 30
    assert not st.is_port(TORCH_ROUND) and st.is_port(VOLUME)


def test_a_trace_of_the_device_alone_is_a_stretch_from_its_operations():
    ctx = _stretch().context
    device = [e for e in _events() if e["cat"] in tracing.DEVICE_CATS]
    st = tracing.Stretch(device, 2, 16, PORT_KERNELS, 2, ctx, request=None)
    assert (st.t0, st.t1) == (10, 410) and len(st.device) == 5
    assert st.busy_us == 110 and st.launches_agree()
    empty = tracing.Stretch([], 2, 16, PORT_KERNELS, 0, ctx, request=None)
    assert empty.window_us == 0 and empty.busy_us == 0
    assert harness.load_metric("device.idle_pct")(empty) is None
    with pytest.raises(ValueError):
        tracing.Stretch(device, 2, 16, PORT_KERNELS, 2, ctx)  # no request span


def test_short_names():
    assert tracing._short(VOLUME) == "(anonymous namespace)::pooled_cvs_kernel<32, 0>"
    assert tracing._short(ROUND) == "(anonymous namespace)::round_kernel<(Form)0, 32, false>"
    assert tracing._short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_breakdown_names_the_hosts_innermost_span():
    b = _stretch().breakdown()
    assert b["device_ops"][0][0] == "(anonymous namespace)::pooled_cvs_kernel<32, 0>"
    assert b["device_ops"][0][1] == pytest.approx(30e-6) and len(b["device_ops"]) == 4
    gaps = dict(b["idle_gaps"])
    # a gap goes to the span open on the host where it starts: 0-10 and
    # 220-250 to the requests, 60-170 to the level span
    assert gaps == pytest.approx({"bench.request": 40e-6, "bench.engine._run_level": 110e-6})


def test_metric_readers_on_the_hand_made_trace():
    st = _stretch()
    read = {m: harness.load_metric(m)(st) for m in (
        "device.idle_pct", "engine.launches_per_field", "ops.device_ms_per_field",
        "cv_diff_roofline", "fused_step_roofline", "sad_search_roofline")}
    assert read["device.idle_pct"] == pytest.approx(60.0)
    assert read["engine.launches_per_field"] == pytest.approx(4 / 16)
    assert read["ops.device_ms_per_field"] == pytest.approx(0.030 / 16)
    bound = cv_diff.batch_bound_ms(st.context["fields"], 480, 640, 8) * 2
    assert read["cv_diff_roofline"] == pytest.approx(100 * bound / 0.030)
    assert read["sad_search_roofline"] is None  # no kernel 7 in the trace


def test_p95_over_all_requests():
    assert harness.p95([float(v) for v in range(1, 101)]) == pytest.approx(95.05)
    assert harness.p95([7.0]) == 7.0


# (kernel ms, per call) of the bring-up's table (PERF.md, section 6) at the
# 1080p level-0 shapes, B=8: each work model must not ask for more
B, H, W, BS, S = 8, 1280, 2048, 32, 16
ALL = [2, 4, 8, 16, 32]


@pytest.mark.parametrize("work,rate,kernel_ms", [
    (cv_diff.volume_call(B, H, W, BS, S, "sad", ALL, store_r=4), None, 4.9257),   # B, band
    (cv_diff.volume_call(B, H, W, BS, S, "sad", ALL), None, 11.2586),             # B, dense
    (cv_diff.volume_call(B, H, W, BS, 12, "sad", [32]), None, 1.6967),            # C, rival
    (fused_step.round_call(B, 40, 64, 40, 64, 2, True, 4), None, 0.0468),         # D round
    (fused_step.round_call(B, 640, 1024, 40, 64, 2, True, 2), None, 0.8948),      # D' round
    (fused_step.round_call(B, 320, 512, 40, 64, 2, True, 2), None, 0.4284),       # E round
    (fused_step.round_call(B, 640, 1024, 40, 64, 2, True, 2), None, 1.8467),      # F round
    (sad_search.search_call(B, H, W, BS, S, "sad"), peaks.INSTR_PER_S, 0.8976),  # 7
])
def test_work_stays_under_the_measured_kernel_time(work, rate, kernel_ms):
    bound = peaks.bound_ms(*work) if rate is None else peaks.bound_ms(*work, rate=rate)
    assert 0 < bound <= kernel_ms


def test_volume_work_is_chip_smokes_count():
    # chip_smoke.py's B row (band): 7 055 196 160 bytes, 68 513 955 840 ops
    assert cv_diff.volume_call(B, H, W, BS, S, "sad", ALL, store_r=4) == \
        (7_055_196_160, 68_513_955_840)
    # its C row (rival r=12, cur 32): 136 396 800 bytes, 39 321 600 000 ops
    assert cv_diff.volume_call(B, H, W, BS, 12, "sad", [32]) == (136_396_800, 39_321_600_000)
