"""Share of its roofline of ``pooled_cvs_kernel`` in the fused capacity form
on 2-D tiles, one tile of each frame a rank: the least time the card could
take for this rank's share of the form's volume calls of the traced
batches (``benchmark/work/fused.py``'s bound for the whole frame, over the
cell's ranks: where every level runs on 2-D tiles, each rank computes the
volumes of exactly its tile's parents, a quarter on a 2 x 2 mesh), over the
device time of that kernel's instances on rank 0, in percent.  Nothing to
read where the kernel did not run."""

from benchmark.work import fused as work


def read(st):
    us = st.kernel_us(st.kernel_named("pooled_cvs_kernel"))
    if us <= 0:
        return None
    c = st.context
    bound = work.volume_bound_ms(c["fields"], c["height"], c["width"], c["batch"]) * st.requests
    return 100.0 * bound / c.get("ranks", 1) / (us / 1e3)
