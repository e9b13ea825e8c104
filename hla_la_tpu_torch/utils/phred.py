"""Phred-score and log-space helpers.

Semantics match the reference implementation (Utilities.cpp:178-205, 357-380 in
DiltheyLab/HLA-LA): quality characters are ASCII phred+33; a quality byte of 0
maps to pCorrect = -1 (sentinel meaning "no quality available").

Vectorised variants return lookup tables indexed by the raw quality byte so
that batched TPU code can convert whole [B, L] uint8 arrays with one gather.
"""

from __future__ import annotations

import numpy as np

LOG_HALF = float(np.log(0.5))


def phred_char_to_p_correct(q: int) -> float:
    """ASCII quality byte -> probability the base call is correct.

    Reference: Utilities::PhredToPCorrect (Utilities.cpp:357-380).
    """
    if q == 0:
        return -1.0
    illumina_phred = int(q) - 33
    if illumina_phred < 0:
        raise ValueError(f"quality byte {q} below 33")
    p_wrong = 10.0 ** (illumina_phred / -10.0)
    return 1.0 - p_wrong


def p_correct_to_phred_char(p_correct: float) -> int:
    """Probability correct -> ASCII quality byte (phred+33, capped at 255).

    Reference: Utilities::PCorrectToPhred (Utilities.cpp:178-205).
    """
    if not (0.0 <= p_correct <= 1.0):
        raise ValueError(f"p_correct out of range: {p_correct}")
    p_wrong = 1.0 - p_correct
    if p_wrong == 0:
        p_wrong = 1e-100
    phred = -10.0 * np.log10(p_wrong)
    if phred + 33 > 255:
        phred = 255 - 33
    return int(round(phred + 33))


_TABLE_CACHE: dict[tuple[float, float], np.ndarray] = {}


def phred_to_p_correct_table(conservative_cap: float | None = 0.999,
                             floor: float | None = 1e-5) -> np.ndarray:
    """[256] float32 lookup table: raw quality byte -> pCorrect.

    `conservative_cap` mirrors the reference's conservativeReadQualities cap of
    0.999 (extensionAligner.cpp:129-133); `floor` mirrors the pCorrect==0 ->
    1e-5 floor (extensionAligner.cpp:134-137).  Quality byte 0 gets the floor
    value rather than the reference's -1 sentinel (batched code masks those
    positions out before scoring).
    """
    key = (conservative_cap if conservative_cap is not None else -1.0,
           floor if floor is not None else -1.0)
    cached = _TABLE_CACHE.get(key)
    if cached is not None:
        return cached
    t = np.zeros(256, dtype=np.float32)
    for q in range(256):
        p = phred_char_to_p_correct(q) if q >= 33 else 0.0
        if conservative_cap is not None and p > conservative_cap:
            p = conservative_cap
        if floor is not None and p <= 0:
            p = floor
        t[q] = p
    _TABLE_CACHE[key] = t
    return t


def log_avg(a: float, b: float) -> float:
    """log((exp(a) + exp(b)) / 2), numerically stable.

    Reference: Utilities::logAvg.
    """
    hi, lo = (a, b) if a > b else (b, a)
    return LOG_HALF + hi + np.log1p(np.exp(lo - hi))


def normalize_log(v: np.ndarray) -> np.ndarray:
    """Log-vector -> normalised probabilities (softmax).

    Reference: Utilities::normalize_log_vector.
    """
    v = np.asarray(v, dtype=np.float64)
    m = np.max(v)
    p = np.exp(v - m)
    s = p.sum()
    if s == 0:
        return np.full_like(p, 1.0 / len(p))
    return p / s
