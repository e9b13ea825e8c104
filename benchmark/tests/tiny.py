"""A cell small enough for the CPU: the harness's own files with a tiny
configuration and traffic, laid out as a checkout in a directory of the
test's own."""

import contextlib
import json
import os
import shutil

import pytest

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
# long reads on a panel of four times the width; most reads are over the
# typer's 1,000-base least alignment for unpaired reads (HLATyper.cpp:1034)
TINY_LONG_CONFIG = {
    **TINY_CONFIG, "n_levels": 6000, "coverage": 4.0, "long_reads": "ont2d",
    "ins_rate_reads": 0.005, "del_rate_reads": 0.005,
    "read_length_median": 1800, "read_length_sigma": 0.7,
    "read_length_min": 1100, "read_length_max": 2400,
    "extra_long_reads": 1, "extra_long_min": 2600, "extra_long_max": 3200}
# the tiny cell cuts long reads into pieces of this many bases in place of
# the CLI's 50,000, so that its extra long reads are cut
TINY_SPLIT = 2000
# the harness's calls of the CLI's cut, while `tiny_split` is on
SPLIT_CALLS: list[tuple] = []


@contextlib.contextmanager
def tiny_split():
    """The port's ``cli._split_long_reads`` cutting at TINY_SPLIT; each
    call's arguments beyond the reads go to SPLIT_CALLS."""
    from hla_la_tpu_torch import cli
    real = cli._split_long_reads

    def cut(reads, *a, **k):
        SPLIT_CALLS.append((a, k))
        return real(reads, TINY_SPLIT)

    SPLIT_CALLS.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "_split_long_reads", cut)
        yield
# the tiny cell is judged by a real cell's limits
LIMITS_OF = "imgt2-wgs30x-pool7"


def long_limits(limits: dict) -> dict:
    """A short-read cell's limits for long reads: every NW job runs on
    K2, none on K1."""
    out = {k: v for k, v in limits.items() if k != "k1_jobs_differ"}
    return {"k2_jobs_differ": limits["k1_jobs_differ"], **out}


def cell_limits(cell: str) -> dict:
    with open(os.path.join(BENCH, "limits", f"{cell}.json")) as fh:
        return json.load(fh)


def cells() -> list[str]:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


def tiny_checkout(root: str, max_threads: int = 1,
                  limits_of: str = LIMITS_OF, long_reads: bool = False,
                  limits: dict | None = None) -> str:
    """A checkout under `root`: BENCHMARK.json with one cell "tiny" and
    its files, judged by the limits of the cell `limits_of` (on long reads
    with k2_jobs_differ in place of k1_jobs_differ), or by `limits`;
    returns the benchmark directory to pass as bench_dir."""
    bench = os.path.join(root, "bench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as fh:
        json.dump(TINY_LONG_CONFIG if long_reads else TINY_CONFIG, fh)
    with open(os.path.join(bench, "traffic", "tiny.json"), "w") as fh:
        json.dump({"windows": "whole", "max_threads": max_threads}
                  if long_reads else {"windows": "genes", "flank": 300,
                                      "max_threads": max_threads}, fh)
    if limits is None:
        limits = cell_limits(limits_of)
        if long_reads:
            limits = long_limits(limits)
    with open(os.path.join(bench, "limits", "tiny.json"), "w") as fh:
        json.dump(limits, fh)
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
