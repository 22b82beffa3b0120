"""Share of its roofline of ``round_kernel`` (the rounds of
``kernels/rounds.py``): the least time the card could take for the stage's
work of the traced batches (``benchmark/work/fused_step.py``, from the
configuration and the frame size, at the published peaks) over the device
time of that kernel's instances, in percent.  Nothing to read where the
kernel did not run."""

from benchmark.work import fused_step as work


def read(st):
    us = st.kernel_us(st.kernel_named("round_kernel"))
    if us <= 0:
        return None
    c = st.context
    bound = work.batch_bound_ms(c["fields"], c["height"], c["width"], c["batch"]) * st.requests
    return 100.0 * bound / (us / 1e3)
