"""stress_long.py's twin (``stress_long_torch.py``) on the CPU, in a process
of its own with jax and hla_la_tpu blocked in ``sys.modules``.  Size: the
bench panel at 2,000,000 levels, whose 5% windows (100,000 bases) are the
shortest that hold the recipe's 60-90 kb reads (splitting must engage on at
least 4 reads over 50 kb), and the reads at 0.3x per window and haplotype
(18 reads, 0.7 Mb; 26 chunks after the split).  Its checks pass (the
planted alleles called at A and B, truth accuracy over 0.9, every NW job on
the CPU) and its JSON line holds every key.  ~5 min alone: 94 s to draw the
panel (once; its package is written beside the reads) and the reads, and
214 s for run_hla_typing, the 26 chunks aligned by the plain NW in 4
workers, then typed; peak memory ~5.3 GB."""

from test_torch_real_scale import run_twin


def test_stress_long_torch_on_the_cpu(tmp_path):
    lines, rec = run_twin(
        "stress_long_torch",
        {"CACHE": repr(str(tmp_path)), "N_LEVELS": 2_000_000,
         "COVERAGE": 0.3},
        ["--device", "cpu"], timeout=1200)
    assert lines[-2] == "STRESS_LONG OK"
    assert {"n_levels", "coverage", "wall_s", "peak_rss_gb", "reads",
            "reads_over_split", "chunks", "mb", "truth_accuracy",
            "align_workers", "launches_workers", "launches_parent",
            "longest_nw_job_L", "n_chain_extensions", "nw_jobs_on_cpu",
            "calls", "loci", "device", "card"} <= set(rec)
    assert rec["reads_over_split"] >= 4
    assert rec["chunks"] > rec["reads"]
    assert rec["longest_nw_job_L"] == 50_000
    assert rec["truth_accuracy"] > 0.9
    assert rec["nw_jobs_on_cpu"] == rec["n_chain_extensions"] > 0
    # where four align workers ran, they were host-only and served by the
    # parent: their reports after their last task
    assert len(rec["workers_torch_imported"]) == \
        (4 if rec["align_workers"] else 0)
    assert not any(rec["workers_torch_imported"] +
                   rec["workers_cuda_initialized"])
    assert rec["served"] is None if not rec["align_workers"] else \
        0 < rec["served"]["nw_jobs"] <= rec["n_chain_extensions"]
    for locus in ("A", "B"):
        got = {a for aid in rec["calls"][locus] for a in aid.split(";")}
        assert {f"{locus}*02:01", f"{locus}*03:01"} <= got
