"""Share of its roofline of ``pooled_cvs_kernel`` in the fused capacity form
(``cv_fused``): the least time the card could take for the form's volume
calls of the traced batches, both windows of every level stored at the
sizes above fuse_eff and at bs (``benchmark/work/fused.py``, from the
configuration and the frame size, at the published peaks), over the device
time of that kernel's instances, in percent.  Nothing to read where the
kernel did not run."""

from benchmark.work import fused as work


def read(st):
    us = st.kernel_us(st.kernel_named("pooled_cvs_kernel"))
    if us <= 0:
        return None
    c = st.context
    bound = work.volume_bound_ms(c["fields"], c["height"], c["width"], c["batch"]) * st.requests
    return 100.0 * bound / (us / 1e3)
