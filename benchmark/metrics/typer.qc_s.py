"""typer.qc_s: per sample, the seconds of the typer.qc spans: each locus's
column QC with its k-mer presence (typer.kmers).  Summed over every
process: with typing workers the sum can pass typer.type_s.  Mean over
the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.qc",))
