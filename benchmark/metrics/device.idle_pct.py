"""Share of the traced stretch in which no kernel, copy or set ran on the
device (the union of the device's intervals), in percent."""


def read(st):
    if st.window_us <= 0:
        return None
    return 100.0 * (1.0 - st.busy_us / st.window_us)
