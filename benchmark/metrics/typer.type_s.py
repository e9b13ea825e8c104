"""typer.type_s: the port's "typed N loci in Y s" line (the type Timer of
models/pipeline.py: every locus, serial or fanned out, and the output
files), mean over the window's samples."""


def read(record):
    v = [s["type_s"] for s in record["samples"]
         if s["ok"] and s["type_s"] is not None]
    return sum(v) / len(v) if v else None
