"""typer.pileup_s: per sample, the seconds of the typer.pileup spans: each
locus's observations, both allele filters, the final pileup, the
histogram and read-ID lines.  Summed over every process: with typing
workers (up to --maxThreads loci at once) the sum can pass typer.type_s.
Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.pileup",))
