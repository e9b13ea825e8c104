"""aligner.host_s: per sample, the seconds of the aligner's host work
outside the NW calls: the spans align.seed (seeding) and align.select
(backtrace, projection, graph fallback, pair selection), summed over
every process (the parent and the workers, whose spans run at once) and
over the insert-size estimate's alignments too.  Mean over the window's
samples."""

from hlabench import spans


def read(record):
    return spans.mean_seconds(record, ("align.seed", "align.select"))
