"""Device operations (kernels, copies and sets, the program's and
PyTorch's) in the traced stretch, per flow field: a count that repeats
exactly."""


def read(st):
    if not st.fields or not st.device:
        return None
    return len(st.device) / st.fields
