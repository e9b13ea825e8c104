"""pool.ready_s: per sample, from the span pool.start's start (the
ParallelAligner made) to the end of the last worker.init span of that
sample: the worker pool's start until its last worker is ready (imports,
connection to the device server, package and aligner).  Only the workers
that received a task send their start back.  Mean over the window's
samples."""

from hlabench import spans


def read(record):
    return spans.pool_ready(record)
