"""Device time of the collective library's kernels (NCCL's point-to-point
swaps and all-gathers: the tiles' frame-2 halos, ghost cells, winners'
rings and joins) in rank 0's device-alone stretch, ms per flow field.

Such a kernel holds the card from its launch until its partners' data has
arrived, so the time includes every wait for the slowest rank, not the
transfers alone.  Nothing to read where no such kernel ran."""

from __future__ import annotations

import re

_NCCL = re.compile(r"^(?:void )?nccl")


def read(st):
    if not st.fields:
        return None
    us = st.kernel_us(lambda name: bool(_NCCL.match(name)))
    return us / 1e3 / st.fields if us > 0 else None
