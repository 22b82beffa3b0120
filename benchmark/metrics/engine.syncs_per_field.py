"""Host-blocking syncs the program counted (each host value copied to the
device, each device value read on the host) per flow field, from the
program's own counters (``utils.profiling.counters`` of the port); 0.0
where it counted none.

The harness hands a reader the traced stretch alone, so this reads the
counters where the reader runs, after the run's last request: totals over
every request of the run, warm-up and both traced stretches included.  A
count does not change under tracing, so the totals read as the stretch
would, but for the tables each process copies once.  None where the
program has no counters, or unless every request it counted returned the
cell's batch."""

from __future__ import annotations

import importlib


def read(st):
    try:
        mod = importlib.import_module("blockbasedmotionestimation_tpu_torch.utils.profiling")
    except ImportError:
        return None
    counters = getattr(mod, "counters", None)
    if counters is None:
        return None
    c = counters()
    batch = st.context.get("batch")
    if not c["requests"] or c["requests"] < st.requests or c["fields"] != c["requests"] * batch:
        return None
    return c["syncs"] / c["fields"]
