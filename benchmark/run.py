"""The benchmark of hla_la_tpu_torch, the PyTorch/CUDA port, on one H100.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout.  Runs one cell of ``BENCHMARK.json`` (see
``hlabench/harness.py``) and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.
Exits 3 with no result when the cell's cards are not there, 4 when JAX or
the JAX package was loaded, 5 when a process it started had to be ended,
6 when the window used up the samples that set-up drew.

Nothing here imports torch at module level: the port's worker processes
re-import this file as their main module and stay host-only.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from hlabench import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), ROOT, device=device)
    except harness.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    except harness.OutOfSamples as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 6
    finally:
        left = harness.reap()
    loaded = harness.jax_loaded()
    if loaded:
        print(f"no result: this process holds {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    if left:
        print(f"no result: processes {left} had to be ended",
              file=sys.stderr)
        return 5
    with open("/proc/self/io") as fh:
        io = dict(line.split(": ") for line in fh.read().splitlines())
    print(f"bytes this process wrote to storage: {io['write_bytes']}",
          file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
