"""The port's ``validation.py`` against the reference's on the CPU: the
cohort, discordant-pileup, corrupted-pileup and sample-sheet cases of
tests/test_validation.py through both packages, with the same reports and
byte-equal report, calibration, allele-stats and pileup-analysis files;
and the sample sheet's rows split over two hosts."""

import os

import numpy as np
import pytest
import torch

from hla_la_tpu import validation as ref_validation
from hla_la_tpu.graph.package import GraphPackage as RefPackage
from hla_la_tpu.io.bam import (BamRecord, BamWriter, FLAG_PAIRED, FLAG_READ1,
                               FLAG_READ2, FLAG_REVERSE)
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp
from hla_la_tpu_torch import validation as port_validation
from hla_la_tpu_torch.graph.package import GraphPackage as PortPackage
from test_torch_host_layers import _read

torch.set_num_threads(1)
REPORTS = ("validation_report", "validation_calibration",
           "validation_allele_stats")


def _world(tmp_path, seed, backbone, samples):
    """A package and, per sample ID, a BAM of paired reads from haplotypes
    1 and 2 at 12x (the recipe of tests/test_validation.py)."""
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=4)
    pkg_dir = sim.write_package(str(tmp_path / "pkg")).dir
    rs = ReadSimulator(rng, read_length=90, fragment_mean=280, fragment_sd=25)
    sheet = []
    for sample in samples:
        bam_path = str(tmp_path / f"{sample}.bam")
        w = BamWriter(bam_path, [("chr6", 100000)])
        for h in (1, 2):
            seq, levels = sim.linearized(h)
            for p in rs.simulate_pairs_from_string(seq, levels, 12.0,
                                                   name_prefix=f"h{h}"):
                for mate_flag, r in ((FLAG_READ1, p.r1), (FLAG_READ2, p.r2)):
                    seq_o, qual = r.seq, r.qual
                    flag = FLAG_PAIRED | mate_flag
                    if r.reverse:
                        seq_o, qual = revcomp(seq_o), qual[::-1]
                        flag |= FLAG_REVERSE
                    w.write(BamRecord(name=r.name, flag=flag, ref_id=0,
                                      pos=max(r.start_pos, 0), mapq=60,
                                      cigar=[(len(seq_o), 0)], seq=seq_o,
                                      qual=qual))
        w.close()
        sheet.append(f"{sample} {bam_path}\n")
    (tmp_path / "validationBAMs.txt").write_text("".join(sheet))
    return pkg_dir


def _validate(tmp_path, pkg_dir, truth_rows, **kw):
    """validate_cohort of both packages on the same sheet and truth table;
    returns {tag: (report, out_dir)}."""
    truth = tmp_path / "truth.txt"
    truth.write_text("IndividualID\tA\tA\tB\tB\n" + truth_rows)
    out = {}
    for tag, mod, pkg_cls, extra in (
            ("port", port_validation, PortPackage, {"device": "cpu"}),
            ("ref", ref_validation, RefPackage, {})):
        samples = mod.read_sample_sheet(str(tmp_path / "validationBAMs.txt"))
        out_dir = str(tmp_path / f"valout_{tag}")
        report = mod.validate_cohort(pkg_cls(pkg_dir), samples, str(truth),
                                     out_dir, **extra, **kw)
        out[tag] = (report, out_dir)
    return out


def _same_reports(out, suffix=""):
    """The two reports agree field by field and every report and pileup
    analysis file is byte-equal; returns the port's report."""
    (got, got_dir), (want, want_dir) = out["port"], out["ref"]
    assert vars(got).keys() == vars(want).keys()
    for key, value in vars(want).items():
        mine = getattr(got, key)
        if key == "per_locus":
            assert {lc: vars(s) for lc, s in mine.items()} == \
                {lc: vars(s) for lc, s in value.items()}
        else:
            assert mine == value, key
    names = sorted(f for f in os.listdir(want_dir)
                   if f.startswith(("validation_", "pileup_analysis_")))
    assert names == sorted(f for f in os.listdir(got_dir)
                           if f.startswith(("validation_",
                                            "pileup_analysis_")))
    assert {f"{r}{suffix}.txt" for r in REPORTS} <= set(names)
    for name in names:
        assert _read(os.path.join(got_dir, name)) == \
            _read(os.path.join(want_dir, name)), name
    return got


def test_cohort_validation_end_to_end(tmp_path):
    pkg_dir = _world(tmp_path, 555, 1600, ["S1"])
    report = _same_reports(_validate(
        tmp_path, pkg_dir, "S1\tA*02:01\tA*03:01\tB*02:01\tB*03:01\n"))
    assert report.n_samples == 1 and not report.discordant
    assert all(report.accuracy(r) == 1.0 for r in ("2digit", "4digit", "G"))


def test_cohort_validation_discordant_pileup_analysis(tmp_path):
    pkg_dir = _world(tmp_path, 21, 1800, ["S2"])
    report = _same_reports(_validate(
        tmp_path, pkg_dir, "S2\tA*02:01\tA*07:01\tB*02:01\tB*03:01\n"))
    assert [d[:2] for d in report.discordant] == [("S2", "A")]
    assert report.truth_stats[("A", "A*07:01")]["incorrect"] == 1
    pa = tmp_path / "valout_port" / "pileup_analysis_S2_A.txt"
    assert len(pa.read_text().splitlines()) > 2


@pytest.mark.parametrize("host", [0, 1])
def test_cohort_rows_split_over_two_hosts(tmp_path, host):
    """n_hosts=2: host I types rows I, I + 2, ... of the sheet and writes
    report files of its own (suffix _host<I>)."""
    pkg_dir = _world(tmp_path, 77, 1500, ["S1", "S2", "S3"])
    truth = "".join(f"{s}\tA*02:01\tA*03:01\tB*02:01\tB*{c}:01\n"
                    for s, c in (("S1", "03"), ("S2", "07"), ("S3", "03")))
    report = _same_reports(_validate(tmp_path, pkg_dir, truth, n_hosts=2,
                                     host_idx=host), f"_host{host}")
    mine = ["S1", "S3"] if host == 0 else ["S2"]
    assert report.n_samples == len(mine)
    assert sorted(d for d in os.listdir(tmp_path / "valout_port")
                  if not d.endswith(".txt")) == mine
    assert [d[:2] for d in report.discordant] == \
        ([] if host == 0 else [("S2", "B")])


def test_pileup_analysis_corrupted_pileup_raises(tmp_path):
    rng = np.random.default_rng(33)
    sim = simulate_prg_package(rng, backbone_length=1200, n_haplotypes=4)
    pkg_dir = sim.write_package(str(tmp_path / "g")).dir
    sample_out = tmp_path / "S1"
    (sample_out / "hla").mkdir(parents=True)
    (sample_out / "hla" / "R1_pileup_A.txt").write_text(
        "0\tnot_an_int\t5\tgarbage\n")
    messages = []
    for mod, pkg, extra in ((port_validation, PortPackage(pkg_dir),
                             {"device": "cpu"}),
                            (ref_validation, RefPackage(pkg_dir), {})):
        with pytest.raises(ValueError) as exc:
            mod.pileup_error_analysis(pkg, str(sample_out), "A",
                                      ("A*01:01", "A*02:01"),
                                      ("A*03:01", "A*04:01"),
                                      str(tmp_path / "out.txt"), **extra)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_sample_sheet_formats(tmp_path):
    p = tmp_path / "sheet.txt"
    p.write_text("NA12878\t/data/NA12878.bam\n"
                 "S2 /x/merged.bam\n"
                 "1000G\t/d/HG1.bam\t\t\t\n"
                 "# a comment\n"
                 "\tPlatinum1\t/p/one.cram\n"
                 "cohortX\t/y/SRR7/merged.bam\t\n"
                 "S3\t/data/my run/x.bam\nmy sample\t/x.bam\n")
    rows = port_validation.read_sample_sheet(str(p))
    assert rows == ref_validation.read_sample_sheet(str(p))
    assert rows[:3] == [("NA12878", "/data/NA12878.bam"),
                        ("S2", "/x/merged.bam"), ("1000G_HG1", "/d/HG1.bam")]
    assert ("cohortX_SRR7", "/y/SRR7/merged.bam") in rows
