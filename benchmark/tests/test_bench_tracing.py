"""The traced run's launch rule, on the CPU: the program's kernels found in
any declaration form, a stretch that breaks the rule traced again, and
what a run that never keeps it says and withholds."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, tracing

ROOT = Path(__file__).resolve().parents[2]
PORT = ROOT / "blockbasedmotionestimation_tpu_torch"
SEVEN = {"compact_tables_kernel", "gather_windows_kernel", "pooled_cvs_kernel", "pyrdown_kernel",
         "resize_linear_kernel", "round_kernel", "sad_spiral_argmin_kernel"}
PLANTED = """
// __global__ void in_a_comment(int)
template<int BS> static __global__ void __launch_bounds__(f(BS), (BS > 64 ? 1 : 2)) k1(int a) {}
extern "C" __global__ void k2(int* p);
inline __global__
void __launch_bounds__(128)
k3(float x) {}
/* __global__ void in_a_block_comment(int) */
namespace bbme {
__global__ void k4(const Args a) {}
}
"""
# each planted kernel as the profiler names an instance of it
TRACED = {"k1": "void k1<32>(int)", "k2": "k2", "k3": "void (anonymous namespace)::k3(float)",
          "k4": "void bbme::k4(Args)"}


def _stretch(events, names=frozenset(SEVEN), counted=0, counted_by=None):
    return tracing.Stretch(events, 1, 8, set(names), counted, {"batch": 8}, request=None,
                           counted_by=counted_by)


def test_todays_sources_declare_the_seven_kernels():
    assert tracing.port_kernel_names(PORT) == SEVEN


def test_every_declaration_form_is_found_and_recognised(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "planted.cu").write_text(PLANTED)
    names = tracing.port_kernel_names(tmp_path)
    assert names == {"k1", "k2", "k3", "k4"}
    st = _stretch([], names)
    for name, traced in TRACED.items():
        assert st.port_name(traced) == name and st.kernel_named(name)(traced)
    assert not st.is_port("void at::native::k1_cuda<float>(float*)")


@pytest.mark.parametrize("traced,port", [
    ("void (anonymous namespace)::pooled_cvs_kernel<32, 0>(unsigned char const*, int)",
     "pooled_cvs_kernel"),
    ("void bbme::detail::round_kernel<(Form)0, 32, false>(RoundArgs)", "round_kernel"),
    ("void bbme::(anonymous namespace)::pyrdown_kernel<true>(unsigned char const*)",
     "pyrdown_kernel"),
    ("void at::native::round_kernel_cuda<float>(float*)", None),
    ("_ZN12_GLOBAL__N_117pooled_cvs_kernelILi32ELi0EEEvPKhi", None),
])
def test_a_kernel_is_the_programs_under_any_namespace(traced, port):
    assert _stretch([]).port_name(traced) == port


def _kernel(name, ts, dur=1.0):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_the_disagreement_names_kernels_wrappers_and_the_unrecognised():
    mangled = "_ZN12_GLOBAL__N_117pooled_cvs_kernelILi32ELi0EEEvPKhi"
    events = [_kernel(mangled, 0), _kernel(TRACED["k1"].replace("k1", "pooled_cvs_kernel"), 2),
              _kernel("void at::native::round_kernel_cuda<float>(float*)", 4),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 6,
               "dur": 1}]
    st = _stretch(events, counted=2,
                  counted_by={"pkg.kernels.cv_diff.pooled_cvs": 2, "pkg.kernels.rounds.idle": 0})
    assert not st.launches_agree()
    line = st.disagreement()
    assert line.startswith("1 of the program's kernels in the trace, 2 launches counted")
    assert '{"pooled_cvs_kernel": 1}' in line and '{"pkg.kernels.cv_diff.pooled_cvs": 2}' in line
    assert "rounds.idle" not in line and "Memcpy DtoD (Device -> Device)" in line
    # the mangled name is named in the sources; torch's round kernel is not
    assert f'not recognised {{"{mangled}": 1}}' in line


class _Profiler:
    """Stands in for ``torch.profiler.profile`` under the Tracer's schedule:
    at its last step it writes the trace of the requests it recorded, each
    with two launches of k1 and one torch kernel, less the first ``lose``
    program kernels of the stretch."""

    def __init__(self, tracer, path: Path, lose: int, spanned: bool, t0: float):
        self.tracer, self.path, self.lose, self.spanned, self.t0 = tracer, path, lose, spanned, t0
        self.steps = 0

    def step(self):
        self.steps += 1
        tr = self.tracer
        if self.steps < tr.WARMUP + tr.active:
            return
        events = []
        for r in range(tr.active):
            t = self.t0 + 100.0 * r
            if self.spanned:
                events.append({"ph": "X", "cat": "user_annotation", "name": tr.REQUEST, "ts": t,
                               "dur": 90.0})
            events += [_kernel(TRACED["k1"], t + 10), _kernel(TRACED["k1"], t + 20),
                       _kernel("void at::native::vectorized_elementwise_kernel<4>(int)", t + 30)]
        dropped = [e for e in events if e["name"] == TRACED["k1"]][:self.lose]
        events = [e for e in events if not any(e is d for d in dropped)]
        self.path.write_text(json.dumps({"traceEvents": events}))


def _drive(monkeypatch, tmp_path, losses, active=3):
    """A traced window over fake requests, each launching k1 twice through a
    wrapper that counts its launches; the device-alone stretches lose the
    first ``losses[i]`` of their kernels."""
    def launch_k1():
        launch_k1.launches += 2
    launch_k1.launches = 0
    launch_k1.__module__ = "blockbasedmotionestimation_tpu_torch.kernels.planted"
    monkeypatch.setattr(tracing, "kernel_wrappers", lambda: [launch_k1])
    monkeypatch.setattr(tracing.Tracer, "PAUSE_S", 0.0)
    queue = list(losses)
    sessions = []

    def profile(self, activities, path):
        spanned = path.name == "spanned.json"
        sessions.append(path.name)
        return _Profiler(self, path, 0 if spanned else queue.pop(0), spanned,
                         1000.0 * len(sessions))
    monkeypatch.setattr(tracing.Tracer, "_profile", profile)

    def stretch(events, counted, request):
        return tracing.Stretch(events, active, active * 8, {"k1"}, sum(counted.values()),
                               {"batch": 8}, request=request, counted_by=counted)
    tracer = tracing.Tracer(active, tmp_path, stretch)
    tracer.start()
    while not tracer.done:
        with tracer.span():
            launch_k1()
        tracer.step()
    return tracer


@pytest.mark.parametrize("lost", [1, 4])
def test_a_stretch_that_lost_its_first_kernels_is_traced_again(monkeypatch, tmp_path, lost):
    tracer = _drive(monkeypatch, tmp_path, [lost, 0, 0])
    assert tracer.attempts == 2 and len(tracer.disagreements) == 1
    assert f"stretch 1 of at most 3: {6 - lost} of the program's kernels in the trace, 6 " \
        in tracer.disagreements[0]
    st = tracer.device
    assert st.launches_agree() and st.port_launches == 6 and st.t0 == 2000.0 + 10
    assert tracer.spanned.t0 == 3000.0 and tracer.done


def test_three_stretches_that_disagree_withhold_the_metrics(monkeypatch, tmp_path):
    tracer = _drive(monkeypatch, tmp_path, [2, 1, 3])
    assert tracer.attempts == 3 and len(tracer.disagreements) == 3
    assert not tracer.device.launches_agree() and tracer.spanned is not None
    for line in tracer.disagreements:
        assert '"k1": ' in line
        assert '{"blockbasedmotionestimation_tpu_torch.kernels.planted.launch_k1": 6}' in line


def test_a_run_whose_wrapper_counts_a_launch_too_many_reports_no_per_layer_metric(
        tiny_cell, monkeypatch, capsys):
    """A whole traced run on the CPU with a planted wrapper that counts a
    launch each request that no kernel in the trace matches: three
    device-alone stretches, each named in a line, and no per-layer metric."""
    from blockbasedmotionestimation_tpu_torch.models import engine

    def launch_planted():
        pass
    launch_planted.launches = 0
    launch_planted.__module__ = "blockbasedmotionestimation_tpu_torch.kernels.planted"
    wrappers = tracing.kernel_wrappers
    monkeypatch.setattr(tracing, "kernel_wrappers", lambda: [*wrappers(), launch_planted])
    entry = engine.estimate_flow_driver_batched

    def counted_twice(*args, **kw):
        launch_planted.launches += 1
        return entry(*args, **kw)
    monkeypatch.setattr(engine, "estimate_flow_driver_batched", counted_twice)
    cell = tiny_cell(check_fields=1, trace_requests=2)
    res = harness.run(cell, 2**33 + 9, 0.1, True, "cpu", time.perf_counter())[0]
    err = capsys.readouterr().err
    assert res["correct"] is True and res["metrics"] == {}
    lines = [ln for ln in err.splitlines() if ln.startswith("trace: device-alone stretch")]
    assert len(lines) == 3
    assert all('"blockbasedmotionestimation_tpu_torch.kernels.planted.launch_planted": 2' in ln
               for ln in lines)
    assert "none of 3 device-alone stretches" in err


def test_the_untraced_result_is_the_one_it_was(tiny_cell):
    """The untraced branch's result object: its keys in order, the cell's
    end-to-end metrics, the device, and the check's numbers last."""
    cell = tiny_cell(check_fields=2)
    res = harness.run(cell, 2**33 + 11, 0.3, False, "cpu", time.perf_counter())[0]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert {k: v["unit"] for k, v in res["metrics"].items()} == \
        {m["name"]: m["unit"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for k, v in res["metrics"].items() if k != "peak_mem_gb")
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert res["checks"] == {
        "mismatched_px": {"value": 0, "limit": 0, "rule": "<="},
        "fields_checked": {"value": 2, "limit": 1, "rule": ">="}}


@pytest.mark.requires_cuda
def test_a_wrapper_that_misses_a_launch_on_the_card_withholds_the_metrics(monkeypatch, capsys):
    """The default cell on the card, for a short window, with the pyrDown
    wrapper's count short by one launch each request: three device-alone
    stretches disagree, each line names that wrapper, no per-layer metric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from blockbasedmotionestimation_tpu_torch.kernels import resample
    from blockbasedmotionestimation_tpu_torch.models import engine

    entry = engine.estimate_flow_driver_batched

    def one_uncounted(*args, **kw):
        flow = entry(*args, **kw)
        resample.pyrdown_u8.launches -= 1
        return flow
    monkeypatch.setattr(engine, "estimate_flow_driver_batched", one_uncounted)
    cell = harness.load_cell("default-interp4-640x480.clip-b8")
    cell.traffic = dict(cell.traffic, check_fields=1)
    res = harness.run(cell, 2**33 + 13, 2.0, True, "cuda", time.perf_counter())[0]
    err = capsys.readouterr().err
    print(err[-6000:])
    active = cell.traffic["trace_requests"]
    lines = [ln for ln in err.splitlines() if ln.startswith("trace: device-alone stretch")]
    assert res["correct"] is True and res["metrics"] == {} and len(lines) == 3
    for ln in lines:
        counted = json.loads(ln.split("; counted ")[1].split("; first operations")[0])
        traced = json.loads(ln.split("; in the trace ")[1].split("; counted ")[0])
        wrapper = f"{resample.__name__}.pyrdown_u8"
        assert traced["pyrdown_kernel"] - counted[wrapper] == active
