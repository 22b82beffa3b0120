"""Tracing and performance accounting.

The port's counterpart of the JAX package's ``utils/profiling.py``, plus
the program's own spans and counters:

  * ``counters`` - always on and cheap (plain ints and ``perf_counter_ns``
    pairs): the outermost calls of the public entry points (``entry``:
    requests, fields returned, host nanoseconds from entry to return) and
    every call by which the program makes the host wait for the device
    (``upload`` of a host value, ``host_read`` of a device value: syncs,
    their nanoseconds, and syncs by site).  A host-to-device copy from
    pageable memory and a device-to-host read synchronise the stream, so
    the host cannot run ahead of the card there.  Also the bytes of every
    cost volume a level stores, by the level's form (``volumes``, called
    by ``ops.windowed`` where it decides the form: from shapes and dtypes,
    no sync), and every round of the rounds loop by its wrapper's form
    (``round_done``), and every call of the upscale and of each pyrDown by
    the route its wrapper took (``resample_route``: ``kernel`` or
    ``plain``).
    Counted on every device, CPU included;
  * ``table`` - constant host tables (indices, ranks, coefficients that
    depend on shapes and the configuration alone) kept on the device: the
    first call of a (site, key, device) uploads the table, a counted sync,
    and every later call returns the same tensor, counted as a hit of its
    site (``table_hits``), with no copy and no wait;
  * ``span`` - the program's stages as ``torch.profiler.record_function``
    ranges named ``mf.<name>``, on the profiler's clock beside the
    device's kernels and copies.  Off by default (``spans``), when a span
    costs one flag test; ``mf.sync.<site>`` around every counted sync;
  * ``trace`` - ``torch.profiler`` around a block with the spans on, a
    Chrome trace written into a directory (view in perfetto or
    chrome://tracing);
  * ``speed_of_light`` - the block search's useful operations against a
    measured time;
  * ``windowed_pipeline_roofline`` / ``windowed_pipeline_floor`` - the JAX
    package's work models of its fused windowed pipeline, the same counts
    term by term, at the H100's rates.

The card's peaks (``HBM_BYTES_PER_S``, ``CORE_OPS_PER_S``, ``INSTR_PER_S``)
live here; ``chip_smoke.py`` computes its kernels' bounds from them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CORE_OPS_PER_S = 67e12     # H100 SXM CUDA-core peak, used for integer operations
# the most thread-instructions an H100 SXM issues a second: 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz, half of the float32 rate above (an FMA
# counts two); kernel 7's packed VABSDIFF4 and dp4a are counted against it
INSTR_PER_S = CORE_OPS_PER_S / 2


class _Counts:
    """The process's counters (``counters`` reads a snapshot)."""

    def __init__(self):
        self.requests = self.fields = self.host_ns = 0
        self.syncs = self.sync_ns = 0
        self.by_site: dict[str, int] = {}
        self.table_hits = 0
        self.hits_by_site: dict[str, int] = {}
        self.volume_bytes = 0
        self.volume_bytes_by_form: dict[str, int] = {}
        self.rounds_by_form: dict[str, int] = {}
        self.resample_by_route: dict[str, int] = {}


_COUNTS = _Counts()
TABLES_KEPT = 256  # the device tables ``table`` keeps, least recently used dropped first
_TABLES: collections.OrderedDict = collections.OrderedDict()  # (site, key, device) -> tensor
_TABLES_LOCK = threading.Lock()
_ENTRY = threading.local()  # .inside: an entry point's call is open on this thread
_NULL = contextlib.nullcontext()
_spans_on = False


def counters() -> dict:
    """A snapshot: ``requests``, ``fields`` and ``host_ns`` of the
    outermost entry calls, ``syncs``, ``sync_ns`` and ``syncs_by_site``
    (site name -> syncs), ``table_hits`` and ``table_hits_by_site`` (site
    name -> tables ``table`` found on the device; its misses are the
    site's syncs), ``volume_bytes`` and ``volume_bytes_by_form`` (form ->
    bytes of the cost volumes allocated), ``rounds_by_form`` (form ->
    rounds run), ``resample_by_route`` (route -> calls of the upscale and
    of each pyrDown).  Counts only grow; a reader takes differences."""
    c = _COUNTS
    return {"requests": c.requests, "fields": c.fields, "host_ns": c.host_ns,
            "syncs": c.syncs, "sync_ns": c.sync_ns, "syncs_by_site": dict(c.by_site),
            "table_hits": c.table_hits, "table_hits_by_site": dict(c.hits_by_site),
            "volume_bytes": c.volume_bytes, "volume_bytes_by_form": dict(c.volume_bytes_by_form),
            "rounds_by_form": dict(c.rounds_by_form),
            "resample_by_route": dict(c.resample_by_route)}


def spans(on: bool) -> bool:
    """Turn the program's spans on or off; returns the previous state."""
    global _spans_on
    prev, _spans_on = _spans_on, bool(on)
    return prev


def span(name: str, **args):
    """The range ``mf.<name>`` while spans are on, ``args`` its ``k=v``
    argument string (kept where the profiler records a range's inputs; a
    Chrome trace shows the name, and the ranges' order tells the level or
    round); otherwise one shared null context, no string formatted."""
    if not _spans_on:
        return _NULL
    return torch.profiler.record_function(
        "mf." + name, ", ".join(f"{k}={v}" for k, v in args.items()) or None)


def _sync_span(site: str):
    return torch.profiler.record_function("mf.sync." + site) if _spans_on else _NULL


def _counted(site: str, t0: int) -> None:
    c = _COUNTS
    c.sync_ns += time.perf_counter_ns() - t0
    c.syncs += 1
    c.by_site[site] = c.by_site.get(site, 0) + 1


def upload(data, device, site: str, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)`` of a host value
    (a numpy array, a Python number or list), counted as one sync of
    ``site``: a blocking copy from pageable memory waits for the stream."""
    t0 = time.perf_counter_ns()
    with _sync_span(site):
        out = torch.as_tensor(data, dtype=dtype, device=device)
    _counted(site, t0)
    return out


def table(site: str, key, build, device) -> torch.Tensor:
    """The constant table ``build()`` (a host value as ``upload`` takes it,
    made from the arguments in ``key`` alone) on ``device`` (a tensor's
    ``.device``), copied once: the first call of a (``site``, ``key``,
    device) uploads it, one counted sync of ``site``; later calls return
    the same tensor, one hit of ``site``, without a copy.  The tensor is
    shared, so callers only read it.  Of more than ``TABLES_KEPT`` tables
    the least recently used is dropped (a later call copies it again)."""
    k = (site, key, device)
    with _TABLES_LOCK:
        out = _TABLES.get(k)
        if out is not None:
            _TABLES.move_to_end(k)
            c = _COUNTS
            c.table_hits += 1
            c.hits_by_site[site] = c.hits_by_site.get(site, 0) + 1
            return out
    out = upload(build(), device, site)
    with _TABLES_LOCK:
        _TABLES[k] = out
        if len(_TABLES) > TABLES_KEPT:
            _TABLES.popitem(last=False)
    return out


def volumes(form: str, out: dict) -> dict:
    """Count the bytes of the cost volumes ``out`` (size -> tensor, as a
    volume wrapper of ``kernels.cv_diff`` or its plain version returns
    them) under the level form that stores them:
    ``dense`` (every size of a window), ``band`` (the hybrid form's main
    window, its cur=2 volume a band), ``hybrid_rival`` (the hybrid form's
    rival window), ``fused`` (both windows of ``cv_fused``) or ``compact``
    (``cv_compact``'s search volume and slot tables).  Returns ``out``.
    Shapes and dtypes only: no sync, no device read."""
    n = 0
    for t in out.values():
        n += t.nbytes
    c = _COUNTS
    c.volume_bytes += n
    c.volume_bytes_by_form[form] = c.volume_bytes_by_form.get(form, 0) + n
    return out


def round_done(form: str) -> None:
    """Count one round of a round wrapper of ``form``: ``stored`` (D, D',
    8, 9), ``hybrid`` (E), ``tail`` (F), ``fused`` (11, 12) or ``compact``
    (10)."""
    by = _COUNTS.rounds_by_form
    by[form] = by.get(form, 0) + 1


def resample_route(route: str) -> None:
    """Count one call of a resample wrapper (``kernels.resample``) by the
    route it took: ``kernel`` (a CUDA tensor) or ``plain`` (a CPU tensor)."""
    by = _COUNTS.resample_by_route
    by[route] = by.get(route, 0) + 1


def host_read(tensor: torch.Tensor, site: str) -> torch.Tensor:
    """``tensor.cpu()``, counted as one sync of ``site``; the host reads
    the copy (``bool``, ``.numpy()``, ``.tolist()``) without waiting again."""
    t0 = time.perf_counter_ns()
    with _sync_span(site):
        out = tensor.cpu()
    _counted(site, t0)
    return out


def entry(fn):
    """A public entry point (frames first): its outermost call on a thread
    counts a request, the fields it returns (the leading dim of a 4-d flow,
    else 1; of the first element of a tuple) and its host nanoseconds, in
    the span ``mf.driver``.  Calls it makes into other entry points count
    nothing more."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if getattr(_ENTRY, "inside", False):
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        _ENTRY.inside = True
        try:
            with span("driver", call=_COUNTS.requests + 1, batch=_batch(args)):
                out = fn(*args, **kwargs)
        finally:
            _ENTRY.inside = False
        flow = out[0] if isinstance(out, tuple) else out
        c = _COUNTS
        c.requests += 1
        c.fields += flow.shape[0] if flow.dim() == 4 else 1
        c.host_ns += time.perf_counter_ns() - t0
        return out

    return call


def _batch(args: tuple) -> int:
    """The batch of an entry's frames, its first argument: 1 for a pair."""
    return args[0].shape[0] if args and getattr(args[0], "ndim", 2) == 3 else 1


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around a block with the program's spans on (the
    previous state restored after): the CPU activity, and the CUDA
    activity when a card is present; a Chrome trace
    (``<worker>.<ms>.pt.trace.json``) is written into ``logdir`` when the
    block ends.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    )
    prev = spans(True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        spans(prev)


def search_sad_ops(h: int, w: int, bs: int, ss: int) -> int:
    """Useful absdiff ops of one level's full spiral search."""
    ext = spiral_extent(ss - bs)
    nblk = (h // bs) * (w // bs)
    return nblk * (2 * ext + 1) ** 2 * bs * bs


def speed_of_light(
    h: int, w: int, bs: int, ss: int, seconds: float,
    ops_per_sec: float = CORE_OPS_PER_S,
) -> dict:
    """One search level's useful operations, their rate in ``seconds`` and
    that rate's fraction of ``ops_per_sec``."""
    ops = search_sad_ops(h, w, bs, ss)
    achieved = ops / max(seconds, 1e-12)
    return {
        "useful_ops": ops,
        "achieved_ops_per_sec": achieved,
        "fraction_of_nominal": achieved / ops_per_sec,
    }


def windowed_pipeline_roofline(
    cfg,
    padded_h: int,
    padded_w: int,
    ops_per_sec: float = CORE_OPS_PER_S,
    hbm_bytes_per_sec: float = HBM_BYTES_PER_S,
) -> dict:
    """The JAX package's per-component work model of its fused windowed
    pipeline, per field: the same operations and bytes term by term, the
    time of each at the given rates (the H100's by default).

    These terms count the TPU design's traffic: the 8 row-shifted staging
    copies and the bf16 column extract of its gather, the window slabs its
    hybrid step streams to every colour step, every sub-size volume
    streamed once a sweep.  The port's kernels do not move most of that, so
    the terms are NOT lower bounds of the port's kernels; ``chip_smoke.py``
    phase 10 prints each beside the port's measured stage and marks those
    that exceed it.

    Components (all per field; each term is max(ops, bytes) of its own):

      pyramid       pyrDown levels: 2 separable 5-tap passes per output px.
      gather        per-level window fetch: u8 window bytes written + the
                    row-shifted staging copies + bf16 column extract;
                    rival adds its second gather.
      cv_build      the pooled diff pass: ~4 int ops per (pixel, delta)
                    (sub, |.|, acc, amortized pooling) + every volume
                    written once.
      search        lexicographic (cost, spiral-rank) argmin over the
                    cur == bs volume: 2 read passes + 2 ops/entry.
      cv_stream     colour steps reading the dense volumes: each sweep's 4
                    colours together stream each round's volume once.
      step_operands colour-step traffic besides the volumes: candidate MVs
                    (9 x 2 i32), present/rank masks, parent MVs, winner
                    write-back, and the candidate-slab build (~9 grid reads
                    + slab write per cell per step).
      step_compute  9-candidate energy: smoothness (9x2 L1 terms), energy
                    add, masked lexicographic winner ~ 60 ops/cell.
      rival         rival pick + second window slab streamed per fused
                    colour step (patches + rival slab per step; recompute
                    loops are data-dependent, floor 0).
      rival_build   the rival window's pooled diff pass, the 4-op model.
      mv_bookkeeping subdivide/transfer: each round's grid written x2.

    Returns {"components": {name: {ops_s, hbm_s, floor_s, int_ops,
    hbm_bytes}}, "total_floor_s": sum of the floors}.
    """
    comp = {}

    def add(name, int_ops=0.0, hbm_bytes=0.0):
        c = comp.setdefault(name, {"int_ops": 0.0, "hbm_bytes": 0.0})
        c["int_ops"] += int_ops
        c["hbm_bytes"] += hbm_bytes

    sweeps = cfg.sweeps_per_round
    for level in range(cfg.num_levels):
        h = padded_h >> level
        w = padded_w >> level
        bs = cfg.block_sizes[level]
        ext = spiral_extent(cfg.search_sizes[level] - bs)
        side = 2 * ext + 1
        side2 = side * side
        nblk = (h // bs) * (w // bs)
        win = bs + 2 * ext

        if level + 1 < cfg.num_levels:
            add("pyramid", int_ops=20 * (h * w) // 4,
                hbm_bytes=h * w + (h * w) // 4)

        # window gather: staging copies (8 row-shifted u8 images written
        # once) amortize over the level; per window: superwindow write (u8)
        # + bf16 extract read+write
        add(
            "gather",
            hbm_bytes=16 * h * w + nblk * win * win * (1 + 2 + 2),
        )

        # CV build: diff+pool ops + all volumes written once
        add("cv_build", int_ops=4 * side2 * h * w)
        store = getattr(cfg, "cv_store_radius", None)
        cur = bs
        while cur >= 2:
            peak = (255 * 255 if cfg.cost == "ssd" else 255) * cur * cur
            nbytes = 2 if peak < (1 << 16) else 4
            entries = side2 * (h // cur) * (w // cur)
            if cur == 2 and store is not None and store < ext:
                # r_store: the cur=2 volume keeps a dx band only
                entries = entries * (2 * store + 1) // side
            add("cv_build", hbm_bytes=entries * nbytes)
            if cur < bs:
                # each sweep's 4 colours stream the round's volume once
                add("cv_stream", hbm_bytes=entries * nbytes * sweeps)
            cur >>= 1

        # search argmin over the cur == bs volume (i32): min + rank-min
        add("search", int_ops=2 * side2 * nblk,
            hbm_bytes=2 * side2 * nblk * 4)

        # per-round colour-step operands + compute (+ rival slabs)
        rr_lvl = cfg.rival_radius_at(level)
        rr = ext if rr_lvl is None else min(rr_lvl, ext)
        rwin = bs + 2 * rr
        if cfg.rival_window:
            add("rival", hbm_bytes=nblk * rwin * rwin * (1 + 2 + 2))
            # rival CV build: pixel-level diffs over all (2*rr+1)^2 rival
            # deltas, the same 4-op model as the main build
            add("rival_build", int_ops=4 * (2 * rr + 1) ** 2 * h * w)
        cur = bs
        while cur > 1:
            cells = (h // cur) * (w // cur)  # per colour step: cells/4
            steps = 4 * sweeps
            add("step_operands",
                hbm_bytes=steps * (cells // 4) * (136 + 80))
            add("step_compute", int_ops=steps * (cells // 4) * 60)
            if cfg.rival_window:
                # the hybrid step streams patches + rival slab every step
                add("rival",
                    hbm_bytes=steps * nblk * (bs * bs + rwin * rwin) * 2)
            if cur == 2 and store is not None and store < ext:
                # r_store: the cur=2 steps also stream the MAIN window
                # slab for the tail recompute
                add("rival", hbm_bytes=steps * nblk * win * win * 2)
            cur >>= 1
            add("mv_bookkeeping", hbm_bytes=2 * cells * 8)

    out = {}
    total = 0.0
    for name, c in comp.items():
        ops_s = c["int_ops"] / ops_per_sec
        hbm_s = c["hbm_bytes"] / hbm_bytes_per_sec
        floor_s = max(ops_s, hbm_s)
        out[name] = {
            "ops_s": ops_s, "hbm_s": hbm_s, "floor_s": floor_s,
            "int_ops": c["int_ops"], "hbm_bytes": c["hbm_bytes"],
        }
        total += floor_s
    return {"components": out, "total_floor_s": total}


def windowed_pipeline_floor(
    cfg,
    padded_h: int,
    padded_w: int,
    ops_per_sec: float = CORE_OPS_PER_S,
    hbm_bytes_per_sec: float = HBM_BYTES_PER_S,
) -> dict:
    """The JAX package's per-field "floor" of its fused windowed pipeline
    (seconds), the same counts, at the given rates (the H100's by default).

    Two bounds, summed over the pyramid levels:

    * int ops: the pooled cost-volume diff pass evaluates every pixel of
      the level against every delta in the (2R+1)^2 square, ~4 int ops per
      (pixel, delta): subtract, |.|, accumulate into the cur=2 cell, plus
      amortized deeper pooling;
    * memory traffic: each round's cost volume (entries = (2R+1)^2 blocks at
      that granularity, u16 below the i32 overflow size) written once by
      the build and read once per regularization sweep.

    floor = max(ops, bytes).  The byte count is the TPU design's (every
    cur-2 volume written and read ``1 + sweeps`` times): the port's default
    never writes most of those volumes (the band and the tail recompute),
    so this is NOT a lower bound of the port's batch; ``chip_smoke.py``
    phase 10 prints it beside the batch's device time.
    """
    int_ops = 0
    hbm_bytes = 0
    for level in range(cfg.num_levels):
        h = padded_h >> level
        w = padded_w >> level
        bs = cfg.block_sizes[level]
        r = spiral_extent(cfg.search_sizes[level] - bs)
        side2 = (2 * r + 1) ** 2
        int_ops += 4 * side2 * h * w
        cur = bs
        while cur >= 2:
            peak = (255 * 255 if cfg.cost == "ssd" else 255) * cur * cur
            nbytes = 2 if peak < (1 << 16) else 4
            entries = side2 * (h // cur) * (w // cur)
            hbm_bytes += entries * nbytes * (1 + cfg.sweeps_per_round)
            cur >>= 1
    ops_s = int_ops / ops_per_sec
    hbm_s = hbm_bytes / hbm_bytes_per_sec
    return {
        "int_ops": int_ops,
        "hbm_bytes": hbm_bytes,
        "ops_s": ops_s,
        "hbm_s": hbm_s,
        "floor_s": max(ops_s, hbm_s),
    }
