"""The port's ``tools.py`` against the reference's: every case of
tests/test_tools.py, run through both packages' functions on the same
inputs, with equal results and equal files (BAMs as decoded records, every
other file byte for byte), ``remap_and_reduce`` from a BAM and from a CRAM
with ``device="cpu"``.  The port's downsampler in a fresh process is in the
blocked-import script of tests/test_torch_guards.py."""

import json
import os

import numpy as np
import pytest
import torch

from hla_la_tpu import tools as ref_tools
from hla_la_tpu.graph.package import GraphPackage as RefPackage
from hla_la_tpu.io import bam as ref_bam
from hla_la_tpu.io.cram_write import write_cram
from hla_la_tpu.models.alignment import GraphAlignment as RefAlignment
from hla_la_tpu.sim.graph_sim import simulate_prg_package
from hla_la_tpu.sim.read_sim import ReadSimulator, revcomp
from hla_la_tpu_torch import tools as port_tools
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.graph.package import GraphPackage as PortPackage
from hla_la_tpu_torch.models.alignment import GraphAlignment as PortAlignment
from test_torch_host_layers import _read, _tree

torch.set_num_threads(1)
PACKAGES = {"port": port_tools, "ref": ref_tools}


def _mk(name, seq, pos=0, flag=0, ref_id=0, qual=None):
    return ref_bam.BamRecord(
        name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=60,
        cigar=[(len(seq), 0)] if seq else [], seq=seq,
        qual=qual if qual is not None else "I" * len(seq))


def _bam(path, records, refs=(("c", 1000),), header=""):
    w = ref_bam.BamWriter(str(path), list(refs), header)
    for r in records:
        w.write(r)
    w.close()
    return str(path)


def _records(path):
    return [vars(r) for r in ref_bam.BamReader(str(path))]


def _both(tmp_path, fn):
    """fn(tools module, directory) for each package, in a directory of its
    own; returns {tag: (result, directory)}."""
    out = {}
    for tag, tools in PACKAGES.items():
        d = tmp_path / tag
        d.mkdir()
        out[tag] = (fn(tools, d), d)
    return out


def _same_files(a, b, min_files=1):
    names = _tree(str(b))
    assert _tree(str(a)) == names and len(names) >= min_files
    for name in names:
        if name.endswith(".bam"):
            assert _records(a / name) == _records(b / name), name
        else:
            assert _read(str(a / name)) == _read(str(b / name)), name


def _same(out, min_files=1):
    assert out["port"][0] == out["ref"][0]
    _same_files(out["port"][1], out["ref"][1], min_files)
    return out["port"][0]


def test_downsample(tmp_path):
    src = _bam(tmp_path / "in.bam", [_mk(f"r{i}", "ACGT") for i in range(500)])
    kept, total = _same(_both(tmp_path, lambda t, d: t.downsample_bam(
        src, str(d / "out.bam"), 0.5, seed=1)))
    assert total == 500 and 150 < kept < 350


def _package(rng, root, **kw):
    """One simulated package, written once per package's writer."""
    sim = simulate_prg_package(rng, **kw)
    return sim, {tag: sim.write_package(str(root / f"pkg_{tag}"),
                                        compile_now=False).dir
                 for tag in PACKAGES}


def _open(tag, pkg_dir):
    return (PortPackage if tag == "port" else RefPackage)(pkg_dir)


def _tools_tag(tools):
    return next(tag for tag, t in PACKAGES.items() if t is tools)


def test_reduce_bam_to_prg(tmp_path, rng):
    _, dirs = _package(rng, tmp_path, backbone_length=600)
    for pkg_dir in dirs.values():
        with open(os.path.join(pkg_dir, "knownReferences", "k.txt"),
                  "w") as fh:
            fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                     "PartialExtraction_Start\tPartialExtraction_Stop\n")
            fh.write("chr6\t5000\t\t1000\t2000\n")
            fh.write("chr7\t5000\t0\t\t\n")
    src = _bam(tmp_path / "in.bam", [
        _mk("in_region", "ACGTACGT", pos=1500),
        _mk("out_region", "ACGTACGT", pos=3000),
        _mk("other_contig", "ACGTACGT", pos=1500, ref_id=1)],
        [("chr6", 5000), ("chr7", 5000)])
    n = _same(_both(tmp_path, lambda t, d: t.reduce_bam_to_prg(
        src, _open(_tools_tag(t), dirs[_tools_tag(t)]), str(d / "r.bam"))))
    assert n == 1
    assert [r["name"] for r in _records(tmp_path / "port" / "r.bam")] == \
        ["in_region"]


def test_amend_secondary(tmp_path):
    src = _bam(tmp_path / "s.bam", [
        _mk("r1", "ACGTACGT", flag=ref_bam.FLAG_PAIRED | ref_bam.FLAG_READ1),
        _mk("r1", "", flag=ref_bam.FLAG_PAIRED | ref_bam.FLAG_READ1
            | ref_bam.FLAG_SECONDARY, qual="")])
    assert _same(_both(tmp_path, lambda t, d:
                       t.amend_secondary_alignment_sequences(
                           src, str(d / "a.bam")))) == 1
    assert _records(tmp_path / "port" / "a.bam")[1]["seq"] == "ACGTACGT"


@pytest.mark.parametrize("rows", [
    ("ACGT_ACGTAC", "ACTT_ACGTAC", "ACGTTACGTAC"),
    ("ACGT_ACGTAC", "ACGTTACGTAC", "ACGTTACGTAC"),
    ("ACG", "A_G", "A_G")], ids=["snp_insertion", "insertion", "deletion"])
def test_truth_to_vcf(tmp_path, rows):
    assert _same(_both(tmp_path, lambda t, d: t.truth_to_vcf(
        *rows, "chr6", str(d / "t.vcf")))) >= 1


def test_coverage_and_read_compare(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir()
    d2.mkdir()
    (d1 / "R1_pileup_A.txt").write_text("0\t0\t5\n0\t1\t7\n0\t2\t0\n")
    (d1 / "R1_readIDs_A.txt").write_text("r1\nr2\n")
    (d2 / "R1_readIDs_A.txt").write_text("r2\nr3\n")
    cov = port_tools.analyse_gene_coverage(str(d1))
    assert cov == ref_tools.analyse_gene_coverage(str(d1))
    assert cov["A"]["n_columns"] == 3 and cov["A"]["zero_columns"] == 1
    rep = port_tools.compare_utilized_reads(str(d1), str(d2))
    assert rep == ref_tools.compare_utilized_reads(str(d1), str(d2))
    assert rep["A"] == dict(only_a=1, only_b=1, shared=1)


def test_extract_kmer_counts():
    exon = {"A_exon2": "ACGTACGTACGTACGTACGTACGTACGTACGTACG",
            "B_exon3": "TTGACCA_GTACCGTAGGCATTACGATCCAGTACGGAT"}
    reads = [exon["A_exon2"][:33], exon["A_exon2"][2:],
             revcomp(exon["B_exon3"].replace("_", ""))]
    got = port_tools.extract_kmer_counts(reads, exon, k=31)
    assert got == ref_tools.extract_kmer_counts(reads, exon, k=31)
    assert any(v > 0 for v in got["A_exon2"].values())
    assert any(v > 0 for v in got["B_exon3"].values())


@pytest.mark.parametrize("mfa", [
    ">h1\nACGTAACGTACGTACGTACGTACGT\n>h2\nACGTTACGTACG-ACGTACGTACGT\n"
    ">h3\nACGTAACGTACGGACG-ACGTACGT\n",
    ">h1\nacgtAACGTACGTACGTACGTACGT\n>h2\nACGT.ACGTACG-ACGTACGTacgt\n"],
    ids=["check", "gap_and_case"])
def test_graph_from_mfa(tmp_path, mfa):
    (tmp_path / "panel.mfa").write_text(mfa)
    out = _both(tmp_path, lambda t, d: t.graph_from_mfa(
        str(tmp_path / "panel.mfa"), str(d / "g")).prg().n_levels)
    _same(out, min_files=5)
    pkg = PortPackage(str(tmp_path / "port" / "g"))
    pkg.prg().check_structure()
    assert pkg.prg_fasta() == RefPackage(str(tmp_path / "ref" / "g")
                                         ).prg_fasta()
    assert all(s.isupper() and "-" not in s
               for s in pkg.prg_fasta().values())
    assert port_main(["--action", "checkKIRgraph", "--graph",
                      str(tmp_path / "port" / "g"), "--device", "cpu"]) == 0


def test_find_gene_reads_in_bam(tmp_path):
    rng = np.random.default_rng(11)
    gene_a = "".join(rng.choice(list("ACGT"), 200))
    gene_b = "".join(rng.choice(list("ACGT"), 200))
    panel = tmp_path / "panel.fa"
    panel.write_text(f">geneA\n{gene_a}\n>geneB\n{gene_b}\n")
    recs = [_mk(f"a{i}", gene_a[i:i + 80], pos=i * 10) for i in range(5)]
    recs.append(_mk("junk", "".join(rng.choice(list("ACGT"), 80))))
    bam = _bam(tmp_path / "in.bam", recs, [("chr1", 10000)])
    hits = port_tools.find_gene_reads_in_bam(bam, str(panel), k=31)
    assert hits == ref_tools.find_gene_reads_in_bam(bam, str(panel), k=31)
    assert hits == {"geneA": 5, "geneB": 0}


@pytest.mark.parametrize("with_header", [False, True])
def test_rename_bam_contigs(tmp_path, with_header):
    header = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:6\tLN:1000\n"
              "@SQ\tSN:7\tLN:1000\n@RG\tID:rg1\tSM:S1\n"
              if with_header else "")
    src = _bam(tmp_path / "a.bam", [_mk("r1", "ACGT", pos=10),
                                    _mk("r2", "GGTT", pos=20, ref_id=1)],
               [("6", 1000), ("7", 1000)], header)
    assert _same(_both(tmp_path, lambda t, d: t.rename_bam_contigs(
        src, str(d / "b.bam"), {"6": "chr6"}))) == 2
    rd = ref_bam.BamReader(str(tmp_path / "port" / "b.bam"))
    assert rd.references == [("chr6", 1000), ("7", 1000)]
    assert ("SN:chr6" in rd.header_text) == with_header


def test_sample_reference_genomes(tmp_path, rng):
    _, dirs = _package(rng, tmp_path, backbone_length=800, n_haplotypes=5)
    paths = {tag: (PortPackage if tag == "port" else RefPackage)(d)
             for tag, d in dirs.items()}
    got = port_tools.sample_reference_genomes(paths["port"], n_samples=4)
    want = ref_tools.sample_reference_genomes(paths["ref"], n_samples=4)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert _read(g) == _read(w)
    lst = "sampledReferenceGenomes.txt"
    assert _read(os.path.join(dirs["port"], lst)).decode().split() == got


def test_compare_tool_calls(tmp_path):
    truth = tmp_path / "truth.txt"
    truth.write_text("IndividualID\tA\tA\tB\tB\n"
                     "S1\tA*02:01\tA*03:01\tB*07:02\tB*08:01\n")
    ours = tmp_path / "ours.txt"
    ours.write_text("IndividualID\tA\tA\tB\tB\n"
                    "S1\tA*02:01:01\tA*03:01\tB*07:02\tB*08:01\n")
    other = tmp_path / "xhla.txt"
    other.write_text("IndividualID\tA\tA\tB\tB\n"
                     "S1\tA*02:01\tA*11:01\tB*07:02\tB*44:02\n")
    bg = tmp_path / "bestguess.txt"
    bg.write_text("Locus\tChromosome\tAllele\tQ1\n"
                  "A\t1\tA*02:01\t1\nA\t2\tA*03:01\t1\n"
                  "B\t1\tB*07:02\t1\nB\t2\tB*08:01\t1\n")

    def run(t, d):
        return (t.compare_tool_calls(str(ours), str(other), str(truth),
                                     str(d / "cmp.txt"), other_name="xHLA"),
                t.compare_tool_calls(str(bg), str(other), str(truth),
                                     str(d / "cmp2.txt")))
    stats, stats2 = _same(_both(tmp_path, run), min_files=2)
    assert stats["ours"]["4digit"] == 1.0 and stats["xHLA"]["4digit"] == 0.5
    assert stats2["ours"]["4digit"] == 1.0


def test_import_xhla(tmp_path):
    report = tmp_path / "report-S1-hla.json"
    report.write_text(json.dumps({
        "sample_id": "S1",
        "hla": {"alleles": ["A*02:01", "A*03:01", "B*07:02"]}}))
    full = tmp_path / "S1.hla.full"
    full.write_text("type\tfull\tother\nA*02:01\tA*02:01:01\tx\n"
                    "A*03:01\tA*03:01:02\tx\nB*07:02\tB*07:02:01\tx\n")
    by_locus = _same(_both(tmp_path, lambda t, d: t.import_xhla(
        str(report), str(d / "x.txt"), str(full), str(d / "x_hr.txt"))), 2)
    assert by_locus == {"A": ["A*02:01", "A*03:01"], "B": ["B*07:02"]}
    bad = tmp_path / "bad.full"
    bad.write_text("type\tfull\nA*02:01\tA*99:99\nA*03:01\tA*03:01:02\n"
                   "B*07:02\tB*07:02:01\n")
    msgs = []
    for tools in PACKAGES.values():
        with pytest.raises(ValueError, match="does not extend") as exc:
            tools.import_xhla(str(report), str(tmp_path / "o.txt"),
                              str(bad), str(tmp_path / "o_hr.txt"))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_downsample_wgs_bams(tmp_path):
    src = _bam(tmp_path / "wgs.bam",
               [_mk(f"r{i}", "A" * 100) for i in range(400)])
    for target, frac in ((20_000 / 1e9, 0.5), (1.0, 1.0)):
        root = tmp_path / str(frac)
        root.mkdir()
        (got_frac, kept, total), = _same(_both(root, lambda t, d: [
            row[2:] for row in t.downsample_wgs_bams(
                [src], str(d / "out"), target_gigabases=target, seed=3)]))
        assert abs(got_frac - frac) < 1e-9 and total == 400
        assert 120 < kept < 280 if frac < 1 else kept == 400


def test_alignment_cigar_branches():
    def mk(cls, levels, seq, graph):
        n = len(levels)
        return cls(levels=np.asarray(levels, dtype=np.int64),
                   graph_c=np.frombuffer(graph.encode(), np.uint8).copy(),
                   seq_c=np.frombuffer(seq.encode(), np.uint8).copy(),
                   seq_qual=np.full(n, 40, dtype=np.uint8), reverse=False)

    cases = [([10, 11, -1, 12, 13, 14], "ACGT_C", "AC_TGC"),
             ([10, 11, 12, 15], "AC_T", "AC_G"),
             ([-1, 10, 11, -1], "GACT", "_AC_"),
             ([-1, -1], "AC", "__")]
    got = [port_tools._alignment_cigar(mk(PortAlignment, *c)) for c in cases]
    assert got == [ref_tools._alignment_cigar(mk(RefAlignment, *c))
                   for c in cases]
    assert got[0] == (0, 0, [(2, 0), (1, 1), (1, 0), (1, 2), (1, 0)])
    assert got[1][2] == [(2, 0), (3, 2), (1, 0)]
    assert got[2] == (1, 1, [(2, 0)]) and got[3] is None


def _remap_world(rng, tmp_path, backbone, read_length, fragment, coverage,
                 haps):
    """A package with a knownReferences spec for chr6, and error-free
    paired reads of `haps` as BAM records (reverse mates stored
    reverse-complemented)."""
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=3)
    pkg_dir = str(tmp_path / "pkg")
    sim.write_package(pkg_dir)
    with open(os.path.join(pkg_dir, "knownReferences", "k.txt"), "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write("chr6\t50000\t1\t\t\n")
    rs = ReadSimulator(rng, read_length=read_length, fragment_mean=fragment,
                       fragment_sd=20, with_error=False)
    records = []
    for h in haps:
        seq, levels = sim.linearized(h)
        for p in rs.simulate_pairs_from_string(seq, levels, coverage,
                                               name_prefix=f"h{h}"):
            for mf, r in ((ref_bam.FLAG_READ1, p.r1),
                          (ref_bam.FLAG_READ2, p.r2)):
                s, q, flag = r.seq, r.qual, ref_bam.FLAG_PAIRED | mf
                if r.reverse:
                    s, q, flag = revcomp(s), q[::-1], flag | \
                        ref_bam.FLAG_REVERSE
                records.append(ref_bam.BamRecord(
                    name=r.name, flag=flag, ref_id=0,
                    pos=max(r.start_pos, 0), mapq=60,
                    cigar=[(len(s), 0)], seq=s, qual=q))
    return pkg_dir, records


@pytest.mark.parametrize("input_kind", ["bam", "cram"])
def test_remap_and_reduce(tmp_path, rng, input_kind):
    """remapAndReduce.pl's workflow with each package's aligner (the
    port's on the CPU): the same coordinate-sorted BAM on the PRG
    pseudo-contig, from a BAM and from a CRAM with its decode reference."""
    pkg_dir, records = _remap_world(rng, tmp_path, 1500, 90, 280, 5.0,
                                    (1, 2))
    if input_kind == "bam":
        src, genome = _bam(tmp_path / "in.bam", records,
                           [("chr6", 50000)]), None
    else:
        genome = {"chr6": "".join(rng.choice(list("ACGT"), 50000))}
        src = str(tmp_path / "in.cram")
        write_cram(src, [("chr6", 50000)], records, genome)

    def run(tools, d):
        kw = {"device": "cpu"} if tools is port_tools else {}
        return tools.remap_and_reduce(
            src, _open(_tools_tag(tools), pkg_dir), str(d / "prg.bam"),
            cram_reference=genome, **kw)
    n_pairs, n_un = _same(_both(tmp_path, run))
    assert n_pairs >= 0.45 * len(records) and n_un == 0
    recs = list(ref_bam.BamReader(str(tmp_path / "port" / "prg.bam")))
    n_levels = PortPackage(pkg_dir).prg().n_levels
    assert len(recs) == 2 * n_pairs
    assert all(a.pos <= b.pos for a, b in zip(recs, recs[1:]))
    assert all(0 <= r.pos < n_levels and sum(
        ln for ln, op in r.cigar if op in (0, 1, 4)) == len(r.seq)
        for r in recs)


def test_remap_and_reduce_takes_no_default_device(tmp_path):
    with pytest.raises(TypeError, match="device"):
        port_tools.remap_and_reduce(str(tmp_path / "x.bam"), None,
                                    str(tmp_path / "y.bam"))
