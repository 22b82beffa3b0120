"""Device time of every kernel that is neither from the program's own CUDA
library nor from the collective library (the plain torch operations:
pyramid, padding, argmin and rival pick, subdivide, transfer, crop, and the
copies and concatenations around the tiles' exchanges), ms per flow field,
in rank 0's device-alone stretch.  NCCL's kernels, which hold the card
while they wait for the slowest rank, are left to
``tiled.exchange_ms_per_field``."""

from __future__ import annotations

import re

_NCCL = re.compile(r"^(?:void )?nccl")


def read(st):
    if not st.fields:
        return None
    us = st.kernel_us(lambda name: not st.is_port(name) and not _NCCL.match(name))
    return us / 1e3 / st.fields if us > 0 else None
