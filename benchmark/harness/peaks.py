"""The card's peak rates for a kernel's bound (NVIDIA H100 SXM, dense):
HBM3 at 3.35 TB/s (NVIDIA's H100 data sheet); int32 ALU operations at
132 SMs x 64 INT32 lanes x 1.98 GHz boost (the Hopper white paper);
popcounts, which run on a pipe of their own, at 16 a clock per SM
(CUDA C Programming Guide, arithmetic instructions, compute capability
9.0). A copy of chip_smoke.py's table. The rates assume the card's full
700 W; the run prints the card's power limit beside the shares."""
HBM_BPS = 3.35e12
INT_OPS = 132 * 64 * 1.98e9
POPC_OPS = 132 * 16 * 1.98e9


def bound_s(nbytes: float, ops: float, popc: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BPS, ops / INT_OPS, popc / POPC_OPS)
