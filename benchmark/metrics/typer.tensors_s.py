"""typer.tensors_s: per sample, the seconds of the typer.tensors spans:
the host build of each locus's [R, J, 6] contribution and mismatch
tensors, every chunk.  Summed over every process: with typing workers the
sum can pass typer.type_s.  Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.tensors",))
