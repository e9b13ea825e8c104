"""The command lines of the JAX package's own CLI tests
(``tests/test_cli.py``) replayed through both CLIs on the CPU: every
command of a case runs through the reference CLI as written and through
the port's with ``--device cpu`` appended, each side in a working
directory of its own.  The exit codes must be equal (a ``SystemExit`` with
a message counts as 1), and so must every file the case writes: BAMs as
decoded records, ``.npz`` archives array by array (a zip entry carries its
time), the pair-posterior dumps value by value as test_torch_host_layers
holds them, the KIR posterior within 1e-3, the rest byte for byte.

The lists are copied from ``tests/test_cli.py`` with their paths written
as placeholders; the inputs are built here by the same recipes."""

import os
import shutil

import numpy as np
import pytest
import torch

from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.io import bam as ref_bam
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.io.bam import (BamRecord, BamWriter, FLAG_PAIRED,
                                     FLAG_READ1, FLAG_READ2, FLAG_REVERSE)
from hla_la_tpu_torch.io.fastq import FastqRead, write_fastq
from hla_la_tpu_torch.models.parallel_host import spawn_safe
from hla_la_tpu_torch.sim import ReadSimulator, simulate_prg_package
from hla_la_tpu_torch.sim.read_sim import revcomp
from test_torch_host_layers import _pp_table, _read, _tree

torch.set_num_threads(1)
POSTERIOR_TOL = 1e-3
SHARD_CACHES = {"u_fok", "u_wok"}

HLA_BAM = ["--action", "HLA", "--BAM", "{bam}", "--graph", "{g}",
           "--sampleID", "S1", "--workingDir", "{wd}"]
# tests/test_cli.py, test by test: its commands in order
CASES = {
    "test_test_binary": [["--action", "testBinary"]],
    "test_prepare_graph": [["--action", "prepareGraph", "--graph",
                            "{wd}/g"]],
    "test_hla_action_from_bam": [HLA_BAM + ["--outputDirectory",
                                            "{wd}/out"]],
    "test_hla_multi_host_shards_match_single_host": [
        HLA_BAM + ["--outputDirectory", "{wd}/single"],
        ["--action", "HLA", "--BAM", "{bam}", "--graph", "{g}",
         "--sampleID", "S1", "--workingDir", "{wd}", "--outputDirectory",
         "{wd}/h0", "--nHosts", "2", "--hostIdx", "0", "--shardDir",
         "{wd}/shards"],
        ["--action", "HLA", "--BAM", "{bam}", "--graph", "{g}",
         "--sampleID", "S1", "--workingDir", "{wd}", "--outputDirectory",
         "{wd}/h1", "--nHosts", "2", "--hostIdx", "1", "--shardDir",
         "{wd}/shards"],
        ["--action", "HLA", "--graph", "{g}", "--sampleID", "S1",
         "--workingDir", "{wd}", "--outputDirectory", "{wd}/merged",
         "--mergeShards", "{wd}/shards"]],
    "test_hla_sharded_backend_matches_host": [
        HLA_BAM + ["--outputDirectory", "{wd}/host"],
        HLA_BAM + ["--outputDirectory", "{wd}/sharded", "--backend",
                   "sharded"]],
    "test_kir_action_paired_fastq": [
        ["--action", "KIR", "--ALTpanel", "{panel}", "--FASTQ1", "{kir1}",
         "--FASTQ2", "{kir2}"]],
    "test_hla_action_zero_matching_reads": [
        ["--action", "HLA", "--BAM", "{none_bam}", "--graph", "{g}",
         "--sampleID", "S1", "--workingDir", "{wd}", "--outputDirectory",
         "{wd}/out0"]],
    "test_hla_action_extract_exon_kmer_counts": [
        HLA_BAM + ["--outputDirectory", "{wd}/outk",
                   "--extractExonkMerCounts", "1"]],
    "test_hla_action_keep_extracted_fastq": [
        HLA_BAM + ["--outputDirectory", "{wd}/o1", "--keepExtractedFastq",
                   "1"],
        ["--action", "HLA", "--FASTQ1", "{wd}/o1/R_1.fastq", "--FASTQ2",
         "{wd}/o1/R_2.fastq", "--graph", "{g}", "--sampleID", "S1",
         "--workingDir", "{wd}", "--outputDirectory", "{wd}/o2"]],
    "test_hla_action_warns_on_short_unpaired_reads": [
        ["--action", "HLA", "--FASTQU", "{short_fq}", "--graph", "{g}",
         "--sampleID", "S1", "--workingDir", "{wd}", "--outputDirectory",
         "{wd}/outw"]],
    "test_remap_and_reduce_action": [
        ["--action", "remapAndReduce", "--BAM", "{bam}", "--graph", "{g}",
         "--out", "{wd}/remapped.bam"]],
    "test_downsample_bam_action": [
        ["--action", "downsampleBAM", "--BAM", "{bam}", "--out",
         "{wd}/ds.bam", "--fraction", "0.5", "--seed", "7"],
        ["--action", "downsampleBAM", "--BAM", "{bam}", "--out",
         "{wd}/batch", "--targetGigabases", "1.0"],
        ["--action", "downsampleBAM", "--BAM", "{bam}", "--out",
         "{wd}/ds.bam"]],
}


def _bam_world(root, rng):
    """tests/test_cli.py::_bam_world's recipe: a simulated package with a
    knownReferences spec of the BAM's contig, and a BAM of reads from
    haplotypes 1 and 2."""
    sim = simulate_prg_package(rng, backbone_length=1800, n_haplotypes=4)
    pkg_dir = os.path.join(root, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    rs = ReadSimulator(rng, read_length=90, fragment_mean=300,
                       fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 12.0,
                                               name_prefix=f"h{h}")
    bam_path = os.path.join(root, "in.bam")
    w = BamWriter(bam_path, [("chr6", contig_len)])
    for p in pairs:
        for mate_flag, r in ((FLAG_READ1, p.r1), (FLAG_READ2, p.r2)):
            seq, qual = r.seq, r.qual
            flag = FLAG_PAIRED | mate_flag
            if r.reverse:
                seq, qual, flag = revcomp(seq), qual[::-1], flag | FLAG_REVERSE
            w.write(BamRecord(name=r.name, flag=flag, ref_id=0,
                              pos=max(r.start_pos, 0), mapq=60,
                              cigar=[(len(seq), 0)], seq=seq, qual=qual))
    w.close()
    return pkg_dir, bam_path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every input file of the cases, by placeholder name."""
    root = str(tmp_path_factory.mktemp("replay_inputs"))
    rng = np.random.default_rng(12345)
    g, bam = _bam_world(root, rng)
    out = {"g": g, "bam": bam}
    # test_prepare_graph: a package written without its compiled graph
    simulate_prg_package(np.random.default_rng(12345), backbone_length=500
                         ).write_package(os.path.join(root, "g500"),
                                         compile_now=False)
    out["g500"] = os.path.join(root, "g500")
    # test_hla_action_zero_matching_reads: reads that share nothing with
    # the graph
    out["none_bam"] = os.path.join(root, "none.bam")
    w = BamWriter(out["none_bam"], [("chr6", 100000)])
    for i in range(30):
        seq = "".join(rng.choice(list("ACGT"), 101))
        for flag, pos in ((FLAG_READ1, 1000 + i), (FLAG_READ2, 1300 + i)):
            w.write(BamRecord(name=f"x{i}", flag=FLAG_PAIRED | flag,
                              ref_id=0, pos=pos, mapq=60,
                              cigar=[(101, 0)], seq=seq, qual="I" * 101))
    w.close()
    # test_hla_action_warns_on_short_unpaired_reads
    out["short_fq"] = os.path.join(root, "u.fq")
    write_fastq(out["short_fq"], [
        FastqRead(f"u{i}", "".join(rng.choice(list("ACGT"), 90)), "I" * 90)
        for i in range(20)])
    # test_kir_action_paired_fastq: a two-haplotype panel and pairs of 80 bp
    base = "".join(rng.choice(list("ACGT"), 800))
    alt = base[:400] + "".join(rng.choice(list("ACGT"), 3)) + base[403:]
    out["panel"] = os.path.join(root, "panel.fa")
    with open(out["panel"], "w") as fh:
        fh.write(f">h1\n{base}\n>h2\n{alt}\n")
    r1s, r2s = [], []
    frag, rl = 280, 80
    for i, s in enumerate(range(0, 800 - frag - 1, 23)):
        r2 = base[s + frag - rl:s + frag]
        r1s.append(FastqRead(f"p{i}/1", base[s:s + rl], "I" * rl))
        r2s.append(FastqRead(f"p{i}/2", revcomp(r2), "I" * rl))
    out["kir1"], out["kir2"] = (os.path.join(root, f"R{m}.fq") for m in "12")
    write_fastq(out["kir1"], r1s)
    write_fastq(out["kir2"], r2s)
    return out


def _run(main, argv) -> int:
    """main(argv)'s exit code; a SystemExit's as the interpreter gives it."""
    try:
        return main(argv)
    except SystemExit as exc:
        return exc.code if isinstance(exc.code, int) else 1


def _same_file(got: str, want: str, name: str) -> None:
    if name.endswith(".bam"):
        assert [vars(r) for r in ref_bam.BamReader(got)] == \
            [vars(r) for r in ref_bam.BamReader(want)], name
    elif name.endswith(".npz"):
        with np.load(got) as a, np.load(want) as b:
            keys = set(b.files)
            if os.path.basename(name).startswith("align_shard_"):
                # by design the port packs unpaired chains without the
                # reference's score caches (parallel_host.pack_unpaired_chains)
                keys -= SHARD_CACHES
            assert set(a.files) == keys, name
            for k in keys:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    elif "_PP_" in name:
        g, w = _pp_table(got), _pp_table(want)
        assert g.keys() == w.keys(), name
        for key, (p, ll, mm) in w.items():
            assert abs(g[key][0] - p) <= 1e-6, (name, key)
            assert abs(g[key][1] - ll) <= 1e-2 + 1e-6 * abs(ll), (name, key)
            assert g[key][2] == mm, (name, key)
    elif name.endswith("KIR_haplotypes.txt"):
        a, b = (_read(p).decode().splitlines() for p in (got, want))
        assert a[0] == b[0] and len(a) == len(b) == 2, name
        fa, fb = a[1].split("\t"), b[1].split("\t")
        assert fa[:2] == fb[:2], name
        assert abs(float(fa[2]) - float(fb[2])) <= POSTERIOR_TOL, name
    else:
        assert _read(got) == _read(want), name


@pytest.mark.skipif(not spawn_safe(), reason="--backend sharded starts a "
                    "rank: no file-backed __main__ to spawn from")
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_command_lines_run_on_the_port(case, inputs, tmp_path,
                                                 monkeypatch):
    codes, dirs = {}, {}
    for tag, main, extra in (("ref", ref_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        wd = str(tmp_path / tag)
        os.makedirs(wd)
        if case == "test_prepare_graph":
            shutil.copytree(inputs["g500"], os.path.join(wd, "g"))
        monkeypatch.chdir(wd)       # the KIR case writes to ./sample_KIR
        codes[tag] = [_run(main, [a.format(wd=wd, **inputs) for a in argv]
                           + extra) for argv in CASES[case]]
        dirs[tag] = wd
    assert codes["port"] == codes["ref"]
    assert codes["ref"][0] == 0
    names = _tree(dirs["ref"])
    assert _tree(dirs["port"]) == names
    for name in sorted(names):
        _same_file(os.path.join(dirs["port"], name),
                   os.path.join(dirs["ref"], name), name)
