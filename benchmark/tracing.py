"""The traced run's spans and the reading of its profiler trace.

Spans are the benchmark's own, and only in the second of the two traced
stretches: the harness wraps each request in one, and ``Spans`` wraps the
calls into each layer of the program in ``torch.profiler.record_function``
(names start with ``bench.``).  ``Stretch`` reads the
exported Chrome trace: the device's kernels, copies and sets between the
first request's start and the last one's end (in a trace of the device
alone, between its first operation's start and its last one's end), and
the host's spans.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import sys
from pathlib import Path

PREFIX = "bench."
PACKAGE = "blockbasedmotionestimation_tpu_torch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the layers' entry points, as the engine calls them: (module, attribute)
LAYER_CALLS = (
    ("models.engine", "_run_level"),
    ("ops.resample", "build_pyramid"),
    ("models.engine", "windowed_level"),
    ("models.engine", "block_search_level"),
    ("models.engine", "windowed_schedule"),
)


def port_kernel_names(package_dir: Path) -> set[str]:
    """Names of the ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


def kernel_wrappers() -> list:
    """The program's kernel wrappers: functions of its ``kernels`` modules
    that count their own launches (an int ``launches``)."""
    out = []
    for name, mod in sorted(sys.modules.items()):
        if not name.startswith(f"{PACKAGE}.kernels.") or mod is None:
            continue
        for fn in vars(mod).values():
            if (callable(fn) and getattr(fn, "__module__", None) == name
                    and isinstance(getattr(fn, "launches", None), int)):
                out.append(fn)
    return out


def launches(wrappers) -> int:
    return sum(fn.launches for fn in wrappers)


def _spanned(fn, label: str):
    import torch

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return call


class Spans:
    """Within the block, the layer calls and every kernel wrapper, as the
    program's other modules reach them, run inside a span of their own.  A
    name the program no longer has is reported in ``missing``."""

    def __init__(self):
        self.missing: list[str] = []
        self._saved: list[tuple[object, str, object]] = []

    def _patch(self, mod, attr: str, label: str) -> None:
        self._saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _spanned(getattr(mod, attr), label))

    def __enter__(self):
        for mod_name, attr in LAYER_CALLS:
            mod = sys.modules.get(f"{PACKAGE}.{mod_name}")
            if mod is None or not hasattr(mod, attr):
                self.missing.append(f"{mod_name}.{attr}")
                continue
            self._patch(mod, attr, f"{PREFIX}{mod_name.split('.')[-1]}.{attr}")
        wrappers = {id(fn): fn for fn in kernel_wrappers()}
        # callers outside kernels/ only: the wrappers count their launches
        # on themselves, through their own modules' names
        for name, mod in sorted(sys.modules.items()):
            if (not name.startswith(PACKAGE + ".") or name.startswith(f"{PACKAGE}.kernels.")
                    or mod is None):
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in wrappers:
                    self._patch(mod, attr, f"{PREFIX}kernels.{val.__name__}")
        return self

    def __exit__(self, *exc):
        for mod, attr, val in reversed(self._saved):
            setattr(mod, attr, val)
        self._saved.clear()
        return False


class Tracer:
    """Two profiler sessions over the window, each of ``active`` requests
    after ``WARMUP`` profiled and discarded (the profiler's own start-up).

    The first records the device alone (CUDA activity, no host events, no
    span): the per-layer metrics, the idle share and the launch count are
    read from it, so that neither the host's op records nor the
    benchmark's spans add host time to what they read.  The second records
    host and device with every request in ``bench.request`` and the layer
    and wrapper spans on: the breakdown's idle gaps are told apart by the
    host's span there.  Chrome traces go to ``device_path`` and
    ``spanned_path``."""

    WARMUP = 2
    REQUEST = PREFIX + "request"

    def __init__(self, active: int, device_path: Path, spanned_path: Path):
        self.active, self.device_path, self.spanned_path = active, device_path, spanned_path
        self.started = self.done = False
        self.steps = 0
        self.launches_counted = 0
        self.spans = None

    @property
    def open(self) -> bool:
        return self.started and not self.done

    @property
    def spanned(self) -> bool:
        return self.steps >= self.WARMUP + self.active

    def _profile(self, activities, path: Path):
        import torch

        prof = torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=self.WARMUP, active=self.active,
                                             repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        prof.start()
        return prof

    def start(self) -> None:
        import torch

        self.wrappers = kernel_wrappers()
        # without a card (the CPU tests) the host's activity stands in
        device = torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available() \
            else torch.profiler.ProfilerActivity.CPU
        self.prof = self._profile([device], self.device_path)
        self.started = True

    def span(self):
        import torch

        return torch.profiler.record_function(self.REQUEST) if self.spanned \
            else contextlib.nullcontext()

    def step(self) -> None:
        """After each request under the profiler."""
        import torch

        self.prof.step()
        self.steps += 1
        if self.steps == self.WARMUP:
            self._launches0 = launches(self.wrappers)
        elif self.steps == self.WARMUP + self.active:
            self.launches_counted = launches(self.wrappers) - self._launches0
            self.prof.stop()
            self.spans = Spans().__enter__()
            self.prof = self._profile([torch.profiler.ProfilerActivity.CPU,
                                       torch.profiler.ProfilerActivity.CUDA], self.spanned_path)
        elif self.steps == 2 * (self.WARMUP + self.active):
            self.prof.stop()
            self.spans.__exit__(None, None, None)
            self.done = True
            del self.prof


def _short(name: str) -> str:
    """A kernel's name without its argument list and return type; copies
    and sets keep their whole name."""
    if not name.startswith("void "):
        return name
    name = name[5:]
    depth, i = 0, 0
    while i < len(name):
        if name.startswith("(anonymous namespace)", i):
            i += len("(anonymous namespace)")
            continue
        ch = name[i]
        if ch in "<{":
            depth += 1
        elif ch in ">}":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
        i += 1
    return name


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Stretch:
    """One traced stretch of the window, read from a Chrome trace's events
    (``ph == "X"``, times in microseconds): from the first start to the
    last end of the spans named ``request``, or with ``request=None`` of the
    device's operations (the stretch then leaves out the host's time
    before the first request's first operation).

    requests / fields: what the stretch completed; port_kernels: the
    program's ``__global__`` names; launches_counted: the launches its
    wrappers counted over the stretch; context: the cell's configuration
    fields, frame size and batch, for the work models."""

    def __init__(self, events: list[dict], requests: int, fields: int, port_kernels: set[str],
                 launches_counted: int, context: dict, request: str | None = PREFIX + "request"):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        bounds = [e for e in spans if e["name"] == request] if request is not None else \
            [e for e in events if e.get("cat") in DEVICE_CATS]
        if request is not None and not bounds:
            raise ValueError(f"the trace holds no {request} span")
        self.t0 = min((e["ts"] for e in bounds), default=0.0)
        self.t1 = max((e["ts"] + e["dur"] for e in bounds), default=0.0)
        self.spans = spans
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.t0 <= e["ts"] <= self.t1]
        self.requests = requests
        self.fields = fields
        self.context = context
        pat = re.compile(r"^(?:\(anonymous namespace\)::)?(?:"
                         + "|".join(sorted(map(re.escape, port_kernels))) + r")\b") \
            if port_kernels else None
        self._port = pat
        self.port_launches = sum(1 for e in self.device if e["cat"] == "kernel"
                                 and self.is_port(e["name"]))
        self.launches_counted = launches_counted

    def is_port(self, name: str) -> bool:
        return bool(self._port and self._port.search(_short(name)))

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals, clipped to the stretch."""
        return _union([(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                       for e in self.device])

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_us(self, keep) -> float:
        """Summed device time of the kernels whose name ``keep`` accepts."""
        return sum(e["dur"] for e in self.device if e["cat"] == "kernel" and keep(e["name"]))

    def kernel_named(self, name: str):
        pat = re.compile(r"^(?:\(anonymous namespace\)::)?" + re.escape(name) + r"\b")
        return lambda full: bool(pat.search(_short(full)))

    def launches_agree(self) -> bool:
        return self.port_launches == self.launches_counted

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span open on the host at time t."""
        best = None
        for e in self.spans:
            if e["ts"] <= t < e["ts"] + e["dur"] and (best is None or e["ts"] >= best["ts"]):
                best = e
        return best["name"] if best else "(outside every span)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the host's innermost span at the start of each gap, seconds each."""
        ops: dict[str, float] = {}
        for e in self.device:
            key = _short(e["name"])
            ops[key] = ops.get(key, 0.0) + e["dur"] * 1e-6
        gaps: dict[str, float] = {}
        prev = self.t0
        for a, b in self.busy() + [(self.t1, self.t1)]:
            if a > prev:
                key = self._host_at(prev)
                gaps[key] = gaps.get(key, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def read_trace(path: Path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]
