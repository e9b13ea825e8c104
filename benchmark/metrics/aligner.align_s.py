"""aligner.align_s: the port's "aligned ... in X s" line (the align Timer
of models/pipeline.py: the worker pool or the one-process aligner, and the
device server's K1 calls), mean over the window's samples."""


def read(record):
    v = [s["align_s"] for s in record["samples"]
         if s["ok"] and s["align_s"] is not None]
    return sum(v) / len(v) if v else None
