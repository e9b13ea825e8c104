"""pipeline.rest_s: per sample, the harness's clock around run_hla_typing
less the port's align and type Timer lines: aligner construction, the
insert-size estimate, the worker pool's start and its close.  Mean over
the window's samples."""


def read(record):
    rest = [s["wall_s"] - s["align_s"] - s["type_s"]
            for s in record["samples"]
            if s["ok"] and s["align_s"] is not None
            and s["type_s"] is not None]
    return sum(rest) / len(rest) if rest else None
