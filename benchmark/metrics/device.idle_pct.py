"""device.idle_pct: 100 x (1 - the seconds in which a device event ran
(torch.profiler, kernels, copies and memsets) over the traced window's
wall seconds)."""


def read(record):
    if not record.get("busy_s") or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
