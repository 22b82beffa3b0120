"""Device time of every kernel that is not from the program's own CUDA
library (the plain torch operations: pyramid, padding, argmin and rival
pick, subdivide, transfer, crop), ms per flow field."""


def read(st):
    if not st.fields:
        return None
    us = st.kernel_us(lambda name: not st.is_port(name))
    return us / 1e3 / st.fields if us > 0 else None
