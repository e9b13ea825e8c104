"""K1's roofline (``csrc/banded_nw.cu``, the banded NW forward for bands up
to 32), frozen from ``chip_smoke.py::nw_bound``: the least time one H100
SXM could take for a call of B jobs, read length L and band W.  Reads,
lengths and refs are read once; scores, end cells, end states and the
[B, L + 1, W] pointer bytes written once; 10 float32 operations a cell (the
three states: 5 adds, 5 max/selects) against 67 TFLOP/s, bytes against
3.35 TB/s (NVIDIA's data sheet)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLOPS_PER_CELL = 10


def bound_s(B: int, L: int, W: int) -> float:
    n_bytes = B * L + 4 * B + B * (L + W) + 12 * B + B * (L + 1) * W
    return max(n_bytes / HBM_BYTES_PER_S,
               FLOPS_PER_CELL * B * L * W / FP32_FLOPS)
