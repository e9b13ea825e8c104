"""A cell small enough for the CPU: the harness's own files with a tiny
configuration and traffic, laid out as a checkout in a directory of the
test's own."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_CONFIG = {
    "source": "a tiny panel for tests", "panel_seed": 4242,
    "n_levels": 1500, "n_haplotypes": 8, "snp_rate": 0.01,
    "del_rate": 0.002, "ins_rate": 0.002, "mean_indel_len": 2.0,
    "allele_snp_rate": 0.02, "ins_rate_reads": 0.0005,
    "del_rate_reads": 0.0005,
    "genes": {"A": [0.1, 0.4], "B": [0.55, 0.85]},
    "alleles_per_locus": 12, "read_length": 100, "fragment_mean": 300,
    "fragment_sd": 25, "coverage": 60.0, "reduced": [], "assumed": {}}
# the tiny cell is judged by a real cell's limits
LIMITS_OF = "imgt2-wgs30x-pool7"


def cell_limits(cell: str) -> dict:
    with open(os.path.join(BENCH, "limits", f"{cell}.json")) as fh:
        return json.load(fh)


def cells() -> list[str]:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


def tiny_checkout(root: str, max_threads: int = 1,
                  limits_of: str = LIMITS_OF) -> str:
    """A checkout under `root`: BENCHMARK.json with one cell "tiny" and
    its files, judged by the limits of the cell `limits_of`; returns the
    benchmark directory to pass as bench_dir."""
    bench = os.path.join(root, "bench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as fh:
        json.dump(TINY_CONFIG, fh)
    with open(os.path.join(bench, "traffic", "tiny.json"), "w") as fh:
        json.dump({"windows": "genes", "flank": 300,
                   "max_threads": max_threads}, fh)
    with open(os.path.join(bench, "limits", "tiny.json"), "w") as fh:
        json.dump(cell_limits(limits_of), fh)
    with open(os.path.join(BENCH, "..", "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    manifest["configs"] = [{"name": "tiny", "source": "tests",
                            "file": os.path.join(bench, "configs",
                                                 "tiny.json"),
                            "reduced": [], "why": "tests"}]
    manifest["workloads"] = [{"name": "tiny", "config": "tiny",
                              "traffic": "tiny", "chips": 1, "why": "tests"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh)
    return bench
