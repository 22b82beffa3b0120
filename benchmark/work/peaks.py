"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit), frozen here as the benchmark's yardstick.

Integer work runs on the CUDA cores at the card's non-tensor rate; the
spiral search's packed instructions (a VABSDIFF4 scores four pixel-deltas)
issue at half that rate, since the float32 rate counts an FMA as two.
"""

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
INSTR_PER_S = CORE_OPS_PER_S / 2


def bound_ms(nbytes: float, ops: float, rate: float = CORE_OPS_PER_S) -> float:
    """Least time (ms) the card could take: the larger of the bytes over the
    memory bandwidth and the operations over ``rate``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3
