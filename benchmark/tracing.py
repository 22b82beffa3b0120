"""The traced run's spans and the reading of its profiler trace.

Spans are the benchmark's own, and only in the last traced stretch, the
spanned one: the harness wraps each request in one, and ``Spans`` wraps the
calls into each layer of the program in ``torch.profiler.record_function``
(names start with ``bench.``).  ``Stretch`` reads the
exported Chrome trace: the device's kernels, copies and sets between the
first request's start and the last one's end (in a trace of the device
alone, between its first operation's start and its last one's end), and
the host's spans.

The launch rule: a stretch of the device alone is read only where the
program's kernels in its trace (the ``__global__`` functions of its
``csrc/*.cu``, under any namespace) are as many as its kernel wrappers
counted over the stretch.  So a wrapper adds one to its ``.launches`` for
every kernel it launches, not for every call.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import sys
import time
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

_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_GLOBAL = re.compile(r"\b__global__\b")
_WORD = re.compile(r"\s*([A-Za-z_]\w*)")
_SPACE = re.compile(r"\s*")
# a qualified name's scopes, as the profiler demangles them
_SCOPES = r"^(?:(?:\(anonymous namespace\)|[A-Za-z_]\w*)::)*"


def _is_attribute(word: str) -> bool:
    """``__launch_bounds__``, ``__attribute__``, ``__cluster_dims__`` and
    the like (names of the form ``__x__`` are the implementation's), or
    ``alignas``: what may stand before a kernel's name with parentheses."""
    return word == "alignas" or (len(word) > 4 and word.startswith("__") and word.endswith("__"))


def _skip_group(text: str, i: int) -> int:
    """The index after the bracketed group that opens at ``text[i]``, ``(``
    or ``<`` (inside ``<...>``, angle brackets count outside parentheses
    only)."""
    close = ")" if text[i] == "(" else ">"
    parens = angles = 0
    for j in range(i, len(text)):
        ch = text[j]
        if ch == "(":
            parens += 1
        elif ch == ")":
            parens -= 1
        elif close == ">" and parens == 0 and ch in "<>":
            angles += 1 if ch == "<" else -1
        if ch == close and parens == 0 and angles == 0:
            return j + 1
    return len(text)


def _declared_name(text: str, i: int) -> str | None:
    """The function name of the declaration whose ``__global__`` ends at
    ``i``: the first identifier followed by its parameter list (after any
    template arguments) that is not an attribute."""
    while i < len(text):
        m = _WORD.match(text, i)
        if m is None:
            i = _SPACE.match(text, i).end()
            if i >= len(text) or text[i] in ";{}=":
                return None
            i += 1
            continue
        word, i = m.group(1), m.end()
        j = _SPACE.match(text, i).end()
        if j < len(text) and text[j] == "(" and _is_attribute(word):
            i = _skip_group(text, j)
            continue
        if j < len(text) and text[j] == "<":
            j = _SPACE.match(text, _skip_group(text, j)).end()
        if j < len(text) and text[j] == "(":
            return word
    return None


def global_functions(source: str) -> set[str]:
    """Names of the ``__global__`` functions a CUDA source declares, in any
    declaration form: after ``template<...>``, ``static``, ``extern "C"`` or
    ``inline``, behind ``__launch_bounds__`` with any arguments, over several
    lines, in any namespace."""
    text = _COMMENTS.sub(" ", source)
    return {name for m in _GLOBAL.finditer(text)
            if (name := _declared_name(text, m.end())) is not None}


def port_kernel_names(package_dir: Path) -> set[str]:
    """Names of the ``__global__`` functions of the program's CUDA sources."""
    names: set[str] = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names |= global_functions(src.read_text())
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
    """Profiler sessions over the window, each of ``active`` requests after
    ``WARMUP`` profiled and discarded (the profiler's own start-up).

    First, sessions of the device alone (CUDA activity, no host events, no
    span): the per-layer metrics, the idle share and the launch count are
    read from the first of them that keeps the launch rule, so that neither
    the host's op records nor the benchmark's spans add host time to what
    they read.  A stretch that breaks the rule is traced again, up to
    ``ATTEMPTS`` stretches in all, and ``disagreements`` keeps a line for
    each that broke it: what the trace held and what the wrappers counted,
    by name.  Then one session of host and device with every request in
    ``bench.request`` and the layer and wrapper spans on: the breakdown's
    idle gaps are told apart by the host's span there.

    Each session's recording starts and ends on an idle device: synchronised
    before the profiler starts to record, and ``PAUSE_S`` seconds without
    work after it starts and before it stops.  The profiler keeps only the
    device operations whose times, put on the host's clock, fall inside its
    recording window, and in some sessions that conversion runs early by
    up to a few milliseconds: without the pause, the first operations of
    the first recorded request then fell before the window and were lost.
    The counted launches are those of the ``active`` requests the session
    records.

    ``stretch(events, counted_by_wrapper, request)`` makes a ``Stretch`` of
    a trace's events; ``device`` is the device-alone stretch read (the last
    one where none kept the rule), ``spanned`` the spanned one.  Chrome
    traces are written into ``directory``."""

    WARMUP = 2
    ATTEMPTS = 3
    PAUSE_S = 0.05
    REQUEST = PREFIX + "request"

    def __init__(self, active: int, directory: Path, stretch):
        self.active, self.directory, self._stretch = active, Path(directory), stretch
        self.started = self.done = False
        self.attempts = 0
        self.device = self.spanned = None
        self.disagreements: list[str] = []
        self.spans = None

    @property
    def open(self) -> bool:
        return self.started and not self.done

    def _profile(self, activities, path: Path):
        import torch

        prof = torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=self.WARMUP, active=self.active,
                                             repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        prof.start()
        return prof

    def _session(self, spanned: bool) -> None:
        import torch

        if spanned:
            self.spans = Spans().__enter__()
            activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        else:
            # without a card (the CPU tests) the host's activity stands in
            activities = [torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
                          else torch.profiler.ProfilerActivity.CPU]
        self._spanned = spanned
        self._path = self.directory / ("spanned.json" if spanned else "device.json")
        self.steps = 0
        self.prof = self._profile(activities, self._path)

    def start(self) -> None:
        self.wrappers = kernel_wrappers()
        self.started = True
        self._session(spanned=False)

    def span(self):
        import torch

        return torch.profiler.record_function(self.REQUEST) if self._spanned \
            else contextlib.nullcontext()

    def _idle(self, pause: bool) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if pause:
            time.sleep(self.PAUSE_S)

    def _counts(self) -> dict[str, int]:
        return {f"{fn.__module__}.{fn.__name__}": fn.launches for fn in self.wrappers}

    def step(self) -> None:
        """After each request under the profiler."""
        last = self.WARMUP + self.active
        if self.steps + 1 in (self.WARMUP, last):
            self._idle(pause=self.steps + 1 == last)
        self.prof.step()
        self.steps += 1
        if self.steps == self.WARMUP:  # recording from here on
            self._idle(pause=True)
            self._counts0 = self._counts()
        elif self.steps == last:  # stopped, and the trace written
            counted = {k: v - self._counts0[k] for k, v in self._counts().items()}
            del self.prof
            if self._spanned:
                self.spans.__exit__(None, None, None)
                self.spanned = self._stretch(read_trace(self._path), counted, self.REQUEST)
                self.done = True
                return
            self.attempts += 1
            self.device = self._stretch(read_trace(self._path), counted, None)
            agree = self.device.launches_agree()
            if not agree:
                self.disagreements.append(
                    f"trace: device-alone stretch {self.attempts} of at most {self.ATTEMPTS}: "
                    + self.device.disagreement())
            self._session(spanned=agree or self.attempts == self.ATTEMPTS)


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
    wrappers counted over the stretch, and counted_by the same by wrapper
    (``module.name``); context: the cell's configuration fields, frame size
    and batch, for the work models."""

    def __init__(self, events: list[dict], requests: int, fields: int, port_kernels: set[str],
                 launches_counted: int, context: dict, request: str | None = PREFIX + "request",
                 counted_by: dict[str, int] | None = None):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        bounds = [e for e in spans if e["name"] == request] if request is not None else \
            [e for e in events if e.get("cat") in DEVICE_CATS]
        if request is not None and not bounds:
            raise ValueError(f"the trace holds no {request} span")
        self.t0 = min((e["ts"] for e in bounds), default=0.0)
        self.t1 = max((e["ts"] + e["dur"] for e in bounds), default=0.0)
        self.spans = spans
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                              and self.t0 <= e["ts"] <= self.t1), key=lambda e: e["ts"])
        self.requests = requests
        self.fields = fields
        self.context = context
        self._names = sorted(port_kernels)
        alternatives = "|".join(map(re.escape, self._names))
        self._port = re.compile(_SCOPES + rf"({alternatives})\b") if self._names else None
        self.port_launches = sum(1 for e in self.device if e["cat"] == "kernel"
                                 and self.is_port(e["name"]))
        self.launches_counted = launches_counted
        self.counted_by = counted_by or {}

    def port_name(self, name: str) -> str | None:
        """The program's kernel a trace name is an instance of, or None."""
        m = self._port.search(_short(name)) if self._port else None
        return m.group(1) if m else None

    def is_port(self, name: str) -> bool:
        return self.port_name(name) is not None

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
        pat = re.compile(_SCOPES + re.escape(name) + r"\b")
        return lambda full: bool(pat.search(_short(full)))

    def launches_agree(self) -> bool:
        return self.port_launches == self.launches_counted

    def disagreement(self) -> str:
        """What the launch rule compared, by name: the program's kernels in
        the trace, the launches counted by wrapper, the stretch's first five
        device operations, and the kernels that name a kernel of the sources
        but were not taken for one."""
        # a name of the sources anywhere in a kernel's name, demangled or
        # mangled (where its length stands before it)
        alternatives = "|".join(map(re.escape, self._names))
        named = re.compile("|".join([rf"(?<!\w)(?:{alternatives})(?!\w)"]
                                    + [f"{len(n)}{re.escape(n)}" for n in self._names])) \
            if self._names else None
        kernels: dict[str, int] = {}
        unrecognised: dict[str, int] = {}
        for e in self.device:
            if e["cat"] != "kernel":
                continue
            name = self.port_name(e["name"])
            if name is not None:
                kernels[name] = kernels.get(name, 0) + 1
            elif named and named.search(_short(e["name"])):
                unrecognised[_short(e["name"])] = unrecognised.get(_short(e["name"]), 0) + 1
        counted = {k: v for k, v in sorted(self.counted_by.items()) if v}
        return (f"{self.port_launches} of the program's kernels in the trace, "
                f"{self.launches_counted} launches counted; in the trace "
                f"{json.dumps(dict(sorted(kernels.items())))}; counted "
                f"{json.dumps(counted)}; first operations "
                f"{json.dumps([_short(e['name']) for e in self.device[:5]])}; "
                f"named in csrc but not recognised {json.dumps(unrecognised)}")

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
