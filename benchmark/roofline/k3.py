"""K3's roofline (``csrc/pair_ll.cu``, the pair-likelihood difference
term), frozen from ``chip_smoke.py::pair_bound``: the least time one H100
SXM could take for the C (C + 1) / 2 cluster pairs of a C x R matrix.  L is
read and the [C, C] result written once (bytes against 3.35 TB/s); each
pair and read costs 5 float32 operations (against 67 TFLOP/s) and two
special-function results, one exp and one log, against 16 results per
clock per SM at the card's top SM clock, which bounds it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16
FLOPS_PER_CELL = 5
SFU_PER_CELL = 2


def bound_s(C: int, R: int, sms: int, max_mhz: float) -> float:
    cells = C * (C + 1) // 2 * R
    by_bytes = 4 * (C * R + C * C) / HBM_BYTES_PER_S
    by_flops = FLOPS_PER_CELL * cells / FP32_FLOPS
    by_sfu = SFU_PER_CELL * cells / (SFU_PER_CLOCK_PER_SM * sms
                                     * max_mhz * 1e6)
    return max(by_bytes, by_flops, by_sfu)
