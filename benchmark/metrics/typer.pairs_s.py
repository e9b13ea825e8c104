"""typer.pairs_s: per sample, the seconds of the typer.pairs spans: the
pair reduction (K3), the pair assembly, the posterior and the sort of the
pair dump.  Summed over every process: with typing workers the sum can
pass typer.type_s.  Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.pairs",))
