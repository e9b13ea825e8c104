"""k1.roofline_pct: K1's roofline (benchmark/roofline/k1.py) summed over
every K1 launch of the traced window, over the launches' device seconds
(the wrapper's own CUDA events), in percent."""

from hlabench.spec import roofline


def read(record):
    k1 = roofline("k1")
    runs = record["launches"].get("K1", [])
    spent = sum(t for *_, t in runs)
    if not runs or spent <= 0:
        return None
    return 100.0 * sum(k1.bound_s(B, L, W) for B, L, W, _ in runs) / spent
