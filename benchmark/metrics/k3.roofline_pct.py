"""k3.roofline_pct: K3's roofline (benchmark/roofline/k3.py, at the card's
top SM clock) summed over every whole-matrix K3 launch of the traced
window, over the launches' device seconds (the wrapper's own CUDA events),
in percent."""

from hlabench.spec import roofline


def read(record):
    k3 = roofline("k3")
    runs = [r for r in record["launches"].get("K3", []) if r[2] is None]
    spent = sum(r[3] for r in runs)
    if not runs or spent <= 0 or not record.get("max_sm_mhz"):
        return None
    bound = sum(k3.bound_s(C, R, record["sm_count"], record["max_sm_mhz"])
                for C, R, _, _ in runs)
    return 100.0 * bound / spent
