"""Share of its roofline of ``round_kernel`` in the fused capacity form
(``cv_fused``): the least time the card could take for every round of the
traced batches, D on the stored sizes and the recomputing rounds below
them (``benchmark/work/fused.py``, a floor: from the configuration and the
frame size, at the published peaks), over the device time of all that
kernel's instances, in percent.  Nothing to read where the kernel did not
run."""

from benchmark.work import fused as work


def read(st):
    us = st.kernel_us(st.kernel_named("round_kernel"))
    if us <= 0:
        return None
    c = st.context
    bound = work.round_bound_ms(c["fields"], c["height"], c["width"], c["batch"]) * st.requests
    return 100.0 * bound / (us / 1e3)
