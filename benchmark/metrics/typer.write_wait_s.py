"""typer.write_wait_s: per sample, the seconds of the typer.write_wait
spans: the typing thread blocked on the output threads (pileup and pair
dump writers), in a full queue or at the final flush.  Summed over every
process.  Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("typer.write_wait",))
