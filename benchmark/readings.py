"""The readings that a cell's comparison limits are set from.

  python3 benchmark/readings.py --workload <cell> --seeds a,b,... \
      [--control-seeds c,d,e] [--out file.jsonl]

from the root of a checkout, on the card.  Sets the cell up once, then for
each seed types the sample that a run with that seed compares (the
window's first) with its launches captured, and prints one JSON line: the
port's numbers (the lower readings) and, for the control seeds, the
numbers of the control, the plain reference put in the port's place on the
same captured inputs one precision step below it (the upper readings),
with the verdict of the cell's own limits on each.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read(workload, seeds, control_seeds, checkout, device="cuda",
         bench_dir=None, out=None):
    from hlabench import check, harness, probes
    cell = harness.Cell(workload, checkout, device, bench_dir)
    rows = []
    try:
        cell.type_sample(cell.sample(seeds[0], 0))      # warm-up
        for seed in seeds:
            sample = cell.sample(seed, 1)
            cap = probes.Capture(seed)
            cell.probes.set_capture(cap)
            try:
                res = cell.type_sample(sample)
            finally:
                cell.probes.set_capture(None)
            cell.sync()
            calls = [harness.calls_of(sample, res)]
            row = {"seed": seed, "k2_launches": cap.k2_launches,
                   "program": check.numbers(cap.k1, cap.k3, calls,
                                            device=device, ll=cap.ll,
                                            k2=cap.k2)}
            row["program_correct"] = check.judge(row["program"],
                                                 cell.limits)[0]
            if seed in control_seeds:
                row["control"] = check.control(cap.k1, cap.k3, calls,
                                               device, ll=cap.ll, k2=cap.k2)
                row["control_correct"] = check.judge(row["control"],
                                                     cell.limits)[0]
            rows.append(row)
            if out is not None:
                print(json.dumps(row), file=out, flush=True)
    finally:
        cell.close()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hlabench import harness
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else sys.stdout
    try:
        rows = read(args.workload, seeds, ctl, ROOT, out=sink)
    finally:
        left = harness.reap()
        if args.out:
            sink.close()
    from hlabench import check
    lower = {k: max(r["program"][k] for r in rows) for k in check.NUMBERS}
    # the control does not decode: calls_wrong is the port's own
    upper = {k: min(r["control"][k] for r in rows if "control" in r)
             for k in check.NUMBERS if k != "calls_wrong"
             and any("control" in r for r in rows)}
    verdicts = {"program_correct": [r["program_correct"] for r in rows],
                "control_correct": [r["control_correct"] for r in rows
                                    if "control" in r]}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "lower": lower, "upper": upper, **verdicts,
                      "left": left}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
