"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is data found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic file under
``traffic/`` (read by the one generator, ``gen.py``) and one reader a
per-layer metric under ``metrics/<name>.py``.

A configuration may name, besides its sizes, what a request calls and
what holds it to account (each optional; without them a cell runs as every
cell ran before them):

  * ``entry``: the dotted path of the function a request calls, under the
    program's package, or under the benchmark's own for a module whose path
    starts with ``benchmark.`` (test-only entries); by default
    ``models.engine.estimate_flow_driver_batched``.  It is called as
    ``entry(im1s, im2s, cfg, device=..., **entry_kwargs)``, with ``mesh=``;
  * ``mesh``: ``{"shape": [...], "axes": [...]}``, a ``parallel.tiled.Mesh``
    over the cell's ranks, passed as ``mesh=``; only on a cell of more than
    one chip, and there always, its size the cell's ``chips``;
  * ``entry_kwargs``: further keyword arguments of the entry, as given;
  * ``reference``: a module under ``reference/`` with ``estimate`` and
    ``mismatched_pixels``; by default ``flow``.  ``estimate`` is also
    given ``devices``, the cell's cards, on which it may place its work.

A cell of more than one chip runs one process a card (``ranks.py``);
``ranks`` is then this process's place among them, None on one chip.

A run:
  1. loads the program and its kernel library (the first run of a checkout
     builds it into ``build/kernels/`` there);
  2. makes the request pool on the device from the seed (and, where the
     traffic hands frames from the host, downloads it once);
  3. warms up on the pool's first requests;
  4. serves requests in a closed loop for ``seconds``: one request is one
     call of the reference driver's entry on one batch of pairs, timed from
     issue until its flow is synchronised (or downloaded);
  5. with ``trace``, from a quarter of the window on, profiles
     ``trace_requests`` requests on the device alone and reads the
     per-layer metrics from them (where the trace holds another number of
     the program's kernels than its wrappers counted, from the next such
     stretch, up to three in all), then as many on host and device with
     the layer calls in spans, for the breakdown's idle gaps;
  6. frees the program's state and holds a sample of the fields that the
     window produced, drawn from the seed, to the plain reference.

On several ranks every rank runs the same requests; rank 0 decides when
the window ends and when tracing starts, and shares that once a request in
the small host-side collective that ends it; rank 0 alone keeps the
sample, runs the check and builds the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FOREIGN = ("jax", "jaxlib", "flax", "blockbasedmotionestimation_tpu")
PACKAGE = "blockbasedmotionestimation_tpu_torch"
LIST_FIELDS = ("block_sizes", "search_sizes", "rival_radius")
DEFAULT_ENTRY = "models.engine.estimate_flow_driver_batched"
DEFAULT_REFERENCE = "flow"
_MODULE_NAME = re.compile(r"[A-Za-z_]\w*")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int = 1

    @property
    def entry(self) -> str:
        return self.config.get("entry", DEFAULT_ENTRY)

    @property
    def mesh(self) -> dict | None:
        return self.config.get("mesh")

    @property
    def entry_kwargs(self) -> dict:
        return dict(self.config.get("entry_kwargs", {}))

    @property
    def reference(self) -> str:
        return self.config.get("reference", DEFAULT_REFERENCE)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark ``spec_path``, its configuration
    and traffic files read from beside it; refused (``ValueError``) where
    ``check_cell`` refuses it."""
    spec_path = Path(spec_path)
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    base = spec_path.parent
    cell = Cell(
        name=name,
        config=json.loads((base / cfg["file"]).read_text()),
        traffic=json.loads((base / BENCH.name / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=_for_cell(spec["end_to_end"], name),
        per_layer=_for_cell(spec["per_layer"], name),
        chips=int(w["chips"]),
    )
    check_cell(cell)
    return cell


def resolve_entry(path: str):
    """The function a request calls: ``path`` (``module.function``) under
    the program's package, or under the benchmark's own where it starts
    with ``benchmark.``."""
    module, _, attr = str(path).rpartition(".")
    full = module if module.split(".")[0] == BENCH.name else f"{PACKAGE}.{module}"
    try:
        fn = getattr(importlib.import_module(full), attr)
    except (ImportError, AttributeError, ValueError) as e:
        raise ValueError(f"the entry {path!r} does not resolve: {e}") from e
    if not callable(fn):
        raise ValueError(f"the entry {path!r} is not a function")
    return fn


def reference_module(name: str):
    """The plain reference ``reference/<name>.py``: a module with
    ``estimate`` and ``mismatched_pixels``."""
    if not isinstance(name, str) or not _MODULE_NAME.fullmatch(name):
        raise ValueError(f"the reference {name!r} is not a module name")
    try:
        mod = importlib.import_module(f"{BENCH.name}.reference.{name}")
    except ImportError as e:
        raise ValueError(f"no reference {name!r}: {e}") from e
    missing = [f for f in ("estimate", "mismatched_pixels") if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"the reference {name!r} has no {missing}")
    return mod


def check_cell(cell: Cell) -> None:
    """Refuse, before any work, a cell the harness cannot run as it says:
    a mesh on one chip, none on several (every rank would then serve the
    whole batch, and the rate count it once), a mesh whose size is not the
    cell's ``chips``, an entry or a reference that does not resolve."""
    mesh = cell.mesh
    if mesh is None and cell.chips > 1:
        raise ValueError(f"{cell.name}: {cell.chips} chips and no mesh in its configuration")
    if mesh is not None:
        if cell.chips == 1:
            raise ValueError(f"{cell.name}: a mesh on a one-chip cell")
        shape, axes = mesh.get("shape"), mesh.get("axes")
        if (set(mesh) != {"shape", "axes"} or not isinstance(shape, list)
                or not isinstance(axes, list) or len(shape) != len(axes)
                or not all(isinstance(n, int) and n >= 1 for n in shape)
                or not all(isinstance(a, str) for a in axes)):
            raise ValueError(f"{cell.name}: the mesh {mesh} is not "
                             f'{{"shape": [sizes], "axes": [names]}}')
        if math.prod(shape) != cell.chips:
            raise ValueError(f"{cell.name}: a mesh of {math.prod(shape)} for {cell.chips} chips")
    if not isinstance(cell.config.get("entry_kwargs", {}), dict):
        raise ValueError(f"{cell.name}: entry_kwargs is not an object")
    resolve_entry(cell.entry)
    reference_module(cell.reference)


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FOREIGN)


def motion_fields(config: dict) -> dict:
    """The configuration's MotionConfig fields, lists as tuples."""
    return {k: tuple(v) if k in LIST_FIELDS and isinstance(v, list) else v
            for k, v in config["motion_config"].items()}


def p95(values: list[float]) -> float:
    """95th percentile of all values (inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def report(result: dict, lines: list[str]) -> None:
    """The check lines, last on standard error, then the result line, last
    on standard output."""
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def load_metric(name: str):
    """The reader of one per-layer metric: ``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Sample:
    """A sample of ``k`` fields of all the fields the window completes,
    drawn from the seed, spread over the batch slots: slot j keeps
    ``k // batch`` fields, one more for the first ``k % batch`` slots, each
    drawn from all that slot's fields (reservoir sampling).  A fault in
    one slot of every batch is then always in the sample.  Each field is
    kept with the pool request and batch slot that produced it; a field on
    the card is kept as a copy, so that the rest of its batch's flow can be
    freed."""

    def __init__(self, k: int, batch: int, seed: int):
        self.quota = [k // batch + (j < k % batch) for j in range(batch)]
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.seen = [0] * batch
        self.slots: list[list[tuple[int, int, object]]] = [[] for _ in range(batch)]

    @property
    def kept(self) -> list[tuple[int, int, object]]:
        return [f for slot in self.slots for f in slot]

    def offer(self, pool_index: int, flow) -> None:
        for j in range(flow.shape[0]):
            kept, k = self.slots[j], self.quota[j]
            at = len(kept) if len(kept) < k else int(self.rng.integers(0, self.seen[j] + 1))
            if at < k:
                field = (pool_index, j, flow[j].clone() if flow.is_cuda else flow[j])
                if at == len(kept):
                    kept.append(field)
                else:
                    kept[at] = field
            self.seen[j] += 1


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, ranks=None) -> tuple[dict, list[str]] | None:
    """One run; returns the result line's object and the check lines (on
    rank 0; None on the other ranks)."""
    import torch

    from blockbasedmotionestimation_tpu_torch.config import MotionConfig

    from benchmark import gen, tracing

    entry = resolve_entry(cell.entry)
    reference = reference_module(cell.reference)
    kwargs = cell.entry_kwargs
    if cell.mesh is not None:
        from blockbasedmotionestimation_tpu_torch.parallel.tiled import Mesh

        shape = cell.mesh["shape"]
        kwargs["mesh"] = Mesh(shape, cell.mesh["axes"],
                              ranks=np.arange(math.prod(shape)).reshape(shape))
    lead = ranks is None or ranks.rank == 0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    fields_cfg = motion_fields(cell.config)
    cfg = MotionConfig.from_fields(fields_cfg)
    tr = cell.traffic
    height, width = cell.config["frame"]["height"], cell.config["frame"]["width"]
    batch, n_pool = int(tr["batch"]), int(tr["pool_requests"])
    host_inputs = tr["inputs"] == "host"
    download = bool(tr["download"])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        from blockbasedmotionestimation_tpu_torch.kernels import _build

        _build.library()
    frames = gen.pool(tr, height, width, seed, dev)
    if ranks is not None:  # every rank serves the frames rank 0 checks
        ranks.broadcast(frames)
    host = frames.cpu().numpy() if host_inputs else None
    pool_bytes = 0 if host_inputs else frames.numel() * frames.element_size()
    if host_inputs:
        del frames
        frames = None
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def inputs(k: int):
        src = host if host_inputs else frames
        return src[k * batch:(k + 1) * batch], src[k * batch + 1:(k + 1) * batch + 1]

    def request(k: int):
        im1, im2 = inputs(k)
        # host frames go to the card inside the entry, as a decoder's would
        flow = entry(im1, im2, cfg, device=None if cuda or not host_inputs else dev, **kwargs)
        if download:
            return flow.cpu()
        sync()
        return flow

    for k in range(min(int(tr["warmup_requests"]), n_pool)):
        request(k)
    sample = Sample(int(tr["check_fields"]), batch, seed)
    latencies: list[float] = []
    tracer = None
    if trace:
        import blockbasedmotionestimation_tpu_torch as port

        active = int(tr["trace_requests"])
        names = tracing.port_kernel_names(Path(port.__file__).parent)
        context = {"fields": fields_cfg, "height": height, "width": width, "batch": batch,
                   "ranks": 1 if ranks is None else ranks.world}

        def stretch(events, counted, request):
            return tracing.Stretch(events, active, active * batch, names, sum(counted.values()),
                                   context, request=request, counted_by=counted)
        tmp = tempfile.TemporaryDirectory(prefix="bench-trace-")
        tracer = tracing.Tracer(active, Path(tmp.name), stretch)
    if ranks is not None:  # the window opens once every rank is warm
        ranks.barrier()
    start = time.perf_counter()
    setup_s = start - t_start
    deadline = start + seconds
    done = start
    i = 0
    stop = start_trace = False

    def trace_due(t: float) -> bool:
        return bool(tracer) and not tracer.started and (t - start >= 0.25 * seconds
                                                        or t >= deadline)
    while True:
        t0 = time.perf_counter()
        if ranks is None:
            if t0 >= deadline and not (tracer and not tracer.done):
                break
            start_trace = trace_due(t0)
        if start_trace:
            tracer.start()
            t0 = time.perf_counter()
        k = i % n_pool
        if tracer and tracer.open:
            with tracer.span():
                out = request(k)
        else:
            out = request(k)
        if ranks is not None:  # every rank's flow is synchronised
            now = time.perf_counter()
            stop, start_trace = ranks.decide(now >= deadline, trace_due(now),
                                             bool(tracer) and not tracer.done)
        done = time.perf_counter()
        latencies.append(done - t0)
        if lead:
            sample.offer(k, out)
        del out
        i += 1
        if tracer and tracer.open:
            tracer.step()
        if stop:
            break
    window_s = done - start
    n_fields = i * batch
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    held = sum(math.ceil(f.numel() * f.element_size() / 512) * 512
               for _, _, f in sample.kept if f.is_cuda)
    mem = (peak, pool_bytes, held)
    st = None
    if tracer:
        st, spanned = tracer.device, tracer.spanned
        tmp.cleanup()
    if ranks is not None:
        # the largest rank's peak, less its own pool and sample; the launch
        # rule on every rank
        states = ranks.gather((mem, st.launches_agree() if st else None,
                               tracer.attempts if tracer else 0,
                               tracer.disagreements if tracer else []))
        mem = max((s[0] for s in states), key=lambda m: m[0])
        if not lead:
            del frames, host, sample
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            ranks.barrier()  # the program's state freed on every rank
            return None
    peak = mem[0]

    result_metrics: dict = {}
    breakdown = None
    busy = None
    if not trace:
        values = {"fields_per_s": n_fields / window_s, "latency_ms_p95": p95(latencies) * 1e3,
                  "peak_mem_gb": (mem[0] - mem[1] - mem[2]) / 1e9, "setup_s": setup_s}
        for m in cell.end_to_end:
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:  # the loop ran until the traced requests were done
        breakdown = {"device_ops": st.breakdown()["device_ops"],
                     "idle_gaps": spanned.breakdown()["idle_gaps"]}
        busy = (st.busy_us * 1e-6, st.window_us * 1e-6)
        idle = [100 * (1 - s.busy_us / s.window_us) if s.window_us > 0 else float("nan")
                for s in (st, spanned)]
        print(f"trace: device idle {idle[0]:.2f}% over {tracer.active} requests traced on the "
              f"device alone (stretch {tracer.attempts} of at most {tracer.ATTEMPTS}), "
              f"{idle[1]:.2f}% over the next {tracer.active} traced on host and device with the "
              f"layer and wrapper spans", file=sys.stderr)
        if tracer.spans.missing:
            print(f"spans: the program has no {tracer.spans.missing}", file=sys.stderr)
        for line in tracer.disagreements:
            print(line, file=sys.stderr)
        broke = [] if st.launches_agree() else [0]
        for r, (_, agree, attempts, lines) in enumerate(states[1:] if ranks else [], 1):
            for line in lines:
                print(f"trace: rank {r}: {line.removeprefix('trace: ')}", file=sys.stderr)
            if not agree:
                broke.append(r)
                print(f"trace: rank {r}: none of {attempts} device-alone stretches held as many "
                      f"of the program's kernels as its wrappers counted", file=sys.stderr)
        if broke == [0] and ranks is None:
            print(f"trace: none of {tracer.attempts} device-alone stretches held as many of the "
                  f"program's kernels as its wrappers counted: per-layer metrics not measured",
                  file=sys.stderr)
        elif broke:
            print(f"trace: ranks {broke} broke the launch rule in every device-alone stretch: "
                  f"per-layer metrics not measured", file=sys.stderr)
        else:
            for m in cell.per_layer:
                value = load_metric(m["name"])(st)
                if value is not None:
                    result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, after the window and the peak: the program's state freed,
    # on every rank
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None:
        ranks.barrier()
    devices = ranks.devices if ranks is not None else [dev]
    mismatched = checked = 0
    t_check = time.perf_counter()
    for k, j, flow in sorted(sample.kept, key=lambda s: (s[0], s[1])):
        im1, im2 = inputs(k)
        a = torch.as_tensor(im1[j:j + 1]).to(dev)
        b = torch.as_tensor(im2[j:j + 1]).to(dev)
        want = reference.estimate(a, b, fields_cfg, devices=devices)
        mismatched += reference.mismatched_pixels(flow[None].to(dev), want)
        checked += 1
        del want
    check_s = time.perf_counter() - t_check
    checks = {
        "mismatched_px": {"value": mismatched, "limit": 0, "rule": "<="},
        "fields_checked": {"value": checked, "limit": 1, "rule": ">="},
    }
    correct = mismatched == 0 and checked >= 1
    lines = [f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})"
             for name, c in checks.items()]
    lines.append(f"check: {checked} fields of {n_fields} compared with the plain reference in "
                 f"{check_s:.3f} s; correct={str(correct).lower()}")

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1 if ranks is None else ranks.world,
        "memory_peak_bytes": peak,
    }
    if cuda:
        device_info["power_limit"] = _power_limit()
    if busy is not None:
        device_info["busy_s"], device_info["window_s"] = busy
    result = {"correct": correct, "attempted": i, "failed": 0, "metrics": result_metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines
