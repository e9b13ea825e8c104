"""typer.gemm_s: per sample, the seconds of the typer.gemm spans: every
cluster x read product call (cluster_read_ll) with its host <-> device
copies, in the typing process (a worker's waits on the device server
included).  Summed over every process: with typing workers the sum can
pass typer.type_s.  Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.gemm",))
