"""The port's own copies of the host layers against the reference's, on the
same inputs made from numpy seeds: simulators, utils, FASTA/FASTQ, BAM and
CRAM readers, the CRAM writer, the native binding, graph package, k-mer index and seeder,
global alignment and decoy index, the numpy NW forward and backtrace,
projection and scoring, the host half of the likelihood model, and the whole
CLI on FASTQ, BAM, CRAM and long-read input (calls equal, Q within 1e-6,
every output file byte-identical except the pair-posterior dump, whose
likelihoods come from different float32 reductions)."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import hla_la_tpu.native as ref_native
import hla_la_tpu_torch.native as port_native
from hla_la_tpu import sim as ref_sim
from hla_la_tpu.cli import main as ref_main
from hla_la_tpu.graph.package import GraphPackage as RefPackage
from hla_la_tpu.io import bam as ref_bam
from hla_la_tpu.io import cram as ref_cram
from hla_la_tpu.io import fasta as ref_fasta
from hla_la_tpu.io import fastq as ref_fastq
from hla_la_tpu.io.cram_write import write_cram
from hla_la_tpu.mapping import decoy as ref_decoy
from hla_la_tpu.mapping import global_align as ref_global
from hla_la_tpu.mapping import kmer_index as ref_kmer
from hla_la_tpu.mapping import seeder as ref_seeder
from hla_la_tpu.models import alignment as ref_alignment
from hla_la_tpu.models.aligner import ReadAligner as RefAligner
from hla_la_tpu.ops import banded_nw as ref_nw
from hla_la_tpu.ops import pair_ll as ref_pair
from hla_la_tpu.sim.read_sim import revcomp
from hla_la_tpu.utils import config as ref_config
from hla_la_tpu.utils import nomenclature as ref_nomen
from hla_la_tpu.utils import phred as ref_phred
from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.graph.package import GraphPackage as PortPackage
from hla_la_tpu_torch.io import bam as port_bam
from hla_la_tpu_torch.io import cram as port_cram
from hla_la_tpu_torch.io.cram_write import write_cram as port_write_cram
from hla_la_tpu_torch.io import fasta as port_fasta
from hla_la_tpu_torch.io import fastq as port_fastq
from hla_la_tpu_torch.mapping import decoy as port_decoy
from hla_la_tpu_torch.mapping import global_align as port_global
from hla_la_tpu_torch.mapping import kmer_index as port_kmer
from hla_la_tpu_torch.mapping import seeder as port_seeder
from hla_la_tpu_torch.models import alignment as port_alignment
from hla_la_tpu_torch.models.aligner import ReadAligner as PortAligner
from hla_la_tpu_torch.ops import banded_nw as port_nw
from hla_la_tpu_torch.ops import pair_ll as port_pair
from hla_la_tpu_torch.utils import config as port_config
from hla_la_tpu_torch.utils import nomenclature as port_nomen
from hla_la_tpu_torch.utils import phred as port_phred

torch.set_num_threads(1)

Q_COLS = (3, 4)          # Q1, Q2 of the bestguess tables
CONTIG_LEN = 100000


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_value(a, b, where=""):
    """Equal, through plain objects (the two packages have a class each of
    the same name), containers and numpy arrays."""
    if hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        a, b = vars(a), vars(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _world(sim_pkg, seed, root):
    """A two-locus panel and diploid paired reads from `sim_pkg`'s
    simulators (the reference's or the port's)."""
    rng = np.random.default_rng(seed)
    sim = sim_pkg.simulate_prg_package(rng, backbone_length=1800,
                                       n_haplotypes=4, snp_rate=0.012,
                                       n_gene_alleles=12)
    pkg = sim.write_package(os.path.join(root, "pkg"))
    rs = sim_pkg.ReadSimulator(rng, read_length=90, fragment_mean=300,
                               fragment_sd=25, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 10.0,
                                               name_prefix=f"h{h}")
    return sim, pkg, pairs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_layers"))
    sim, pkg, pairs = _world(ref_sim, 2718, root)
    with open(os.path.join(pkg.dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{CONTIG_LEN}\t1\t\t\n")
    return root, sim, pkg, pairs


def _records(pairs):
    """Mates adjacent, reverse mates stored reverse-complemented with the
    flag set, as an aligner writes them."""
    recs = []
    for i, p in enumerate(pairs):
        for mate_flag, r in ((ref_bam.FLAG_READ1, p.r1),
                             (ref_bam.FLAG_READ2, p.r2)):
            seq, qual, flag = r.seq, r.qual, ref_bam.FLAG_PAIRED | mate_flag
            if r.reverse:
                seq, qual = revcomp(seq), qual[::-1]
                flag |= ref_bam.FLAG_REVERSE
            recs.append(ref_bam.BamRecord(
                name=r.name, flag=flag, ref_id=0, pos=1000 + i * 3, mapq=60,
                cigar=[(len(seq), 0)], seq=seq, qual=qual))
    return recs


# ------------------------------------------------------------- simulators
def test_simulators_write_the_same_world(world, tmp_path):
    """One seed, both packages' simulators: the same package files and the
    same reads."""
    root, _, pkg, pairs = world
    _, port_pkg, port_pairs = _world(port_sim, 2718, str(tmp_path))
    names = _tree(port_pkg.dir)
    assert names and names <= _tree(pkg.dir)
    for name in sorted(names):
        assert _read(os.path.join(port_pkg.dir, name)) == \
            _read(os.path.join(pkg.dir, name)), name
    assert len(port_pairs) == len(pairs) > 50
    for a, b in zip(port_pairs, pairs):
        _same_value(a, b, "pair")


# ------------------------------------------------------------------ utils
def test_config_defaults_agree():
    for name in ("RunConfig", "TyperConfig", "DPScoring"):
        _same_value(dataclasses.asdict(getattr(port_config, name)()),
                    dataclasses.asdict(getattr(ref_config, name)()), name)
    _same_value(dataclasses.asdict(port_config.TyperConfig().for_long_reads()),
                dataclasses.asdict(ref_config.TyperConfig().for_long_reads()))
    assert port_config.LOCI_2_EXONS == ref_config.LOCI_2_EXONS
    assert port_config.LOCI_FOR_TYPING == ref_config.LOCI_FOR_TYPING


def test_phred_helpers_agree():
    for kwargs in ({}, {"conservative_cap": None},
                   {"conservative_cap": 0.999, "floor": None}):
        np.testing.assert_array_equal(
            port_phred.phred_to_p_correct_table(**kwargs),
            ref_phred.phred_to_p_correct_table(**kwargs))
    rng = np.random.default_rng(5)
    for a, b in rng.normal(-30, 20, (50, 2)):
        assert port_phred.log_avg(a, b) == ref_phred.log_avg(a, b)
    v = rng.normal(-100, 30, 64)
    np.testing.assert_array_equal(port_phred.normalize_log(v),
                                  ref_phred.normalize_log(v))
    for q in range(33, 110):
        assert port_phred.phred_char_to_p_correct(q) == \
            ref_phred.phred_char_to_p_correct(q)


@pytest.mark.parametrize("a,b", [
    ("A*02:01", "A*02:01:01:01"), ("A*02:01", "A*02:02"),
    ("B*07:02:01G", "B*07:02"), ("C*04:01N", "C*04:01"),
    ("A*02:01;A*02:07", "A*02:07:01"), ("DRB1*15:01", "DQB1*15:01")])
def test_nomenclature_agrees(a, b):
    assert port_nomen.parse_allele(a) == ref_nomen.parse_allele(a)
    for res in (1, 2, 3):
        assert port_nomen.alleles_compatible(a, b, res) == \
            ref_nomen.alleles_compatible(a, b, res)
        assert port_nomen.allele_list_compatible(a, b, res) == \
            ref_nomen.allele_list_compatible(a, b, res)


# --------------------------------------------------------------------- io
def test_fastq_and_fasta_round_trip_across_packages(world, tmp_path):
    _, sim, _, pairs = world
    reads = [p.r1.to_fastq() for p in pairs[:40]]
    ref_fastq.write_fastq(str(tmp_path / "ref.fq"), reads)
    port_fastq.write_fastq(str(tmp_path / "port.fq"), reads)
    assert _read(tmp_path / "ref.fq") == _read(tmp_path / "port.fq")
    got = list(port_fastq.read_fastq(str(tmp_path / "ref.fq")))
    want = list(ref_fastq.read_fastq(str(tmp_path / "ref.fq")))
    assert [(r.name, r.seq, r.qual) for r in got] == \
        [(r.name, r.seq, r.qual) for r in want] and len(got) == 40
    seqs = {f"hap{h}": sim.linearized(h)[0] for h in (0, 1)}
    ref_fasta.write_fasta(str(tmp_path / "ref.fa"), seqs)
    port_fasta.write_fasta(str(tmp_path / "port.fa"), seqs)
    assert _read(tmp_path / "ref.fa") == _read(tmp_path / "port.fa")
    assert port_fasta.read_fasta(str(tmp_path / "ref.fa")) == \
        ref_fasta.read_fasta(str(tmp_path / "ref.fa")) == seqs


def test_native_bindings_load_one_library():
    """Both bindings build and load native/libhla_native.so; neither owns a
    copy."""
    assert port_native.available() and ref_native.available()
    assert port_native._find_lib()._name == ref_native._find_lib()._name
    assert os.path.basename(port_native._find_lib()._name) == \
        "libhla_native.so"


@pytest.mark.parametrize("use_native", [True, False])
def test_bam_reader_and_writer_agree(world, tmp_path, use_native):
    _, _, _, pairs = world
    recs = _records(pairs)
    paths = {}
    for tag, mod in (("ref", ref_bam), ("port", port_bam)):
        paths[tag] = str(tmp_path / f"{tag}.bam")
        w = mod.BamWriter(paths[tag], [("chr6", CONTIG_LEN)])
        for r in recs:
            w.write(mod.BamRecord(**vars(r)))
        w.close()
    assert _read(paths["ref"]) == _read(paths["port"])
    got = list(port_bam.BamReader(paths["ref"], use_native=use_native))
    want = list(ref_bam.BamReader(paths["ref"], use_native=use_native))
    assert len(got) == len(want) == len(recs)
    _same_value(got, want, "records")
    assert port_bam.BamReader(paths["ref"], use_native=False).contigs() == \
        ref_bam.BamReader(paths["ref"], use_native=False).contigs()
    regions = [("chr6", 0, 0)]
    g_by, g_n = port_bam.extract_reads(paths["ref"], regions)
    w_by, w_n = ref_bam.extract_reads(paths["ref"], regions)
    _same_value(g_by, w_by, "by_name")
    assert g_n == w_n
    _same_value(port_bam.bam_to_fastq_pairs(g_by),
                ref_bam.bam_to_fastq_pairs(w_by), "fastq pairs")


CRAM_CODECS = [
    {"method": ref_cram.M_GZIP},
    {"method": ref_cram.M_RANS4x8},
    {"method": ref_cram.M_RANSNx16},
    {"method": ref_cram.M_ARITH},
    {"method": ref_cram.M_RANSNx16, "qual_method": ref_cram.M_FQZ,
     "name_method": ref_cram.M_TOK3}]


def _codec_id(codecs):
    return "-".join(str(v) for v in codecs.values())


@pytest.mark.parametrize("codecs", CRAM_CODECS, ids=_codec_id)
def test_cram_reader_agrees(world, tmp_path, codecs):
    """One CRAM, written by the reference's writer with each block codec
    (gzip, rANS 4x8, rANS Nx16, the adaptive arithmetic coder, fqzcomp and
    the name tokeniser), decoded by both readers."""
    _, _, _, pairs = world
    rng = np.random.default_rng(11)
    genome = {"chr6": "".join(rng.choice(list("ACGT"), CONTIG_LEN))}
    path = str(tmp_path / "in.cram")
    write_cram(path, [("chr6", CONTIG_LEN)], _records(pairs[:60]), genome,
               per_slice=50, **codecs)
    assert port_bam.is_cram(path) and ref_bam.is_cram(path)
    got = port_cram.CramReader(path, reference=genome)
    want = ref_cram.CramReader(path, reference=genome)
    assert got.contigs() == want.contigs() == {"chr6": CONTIG_LEN}
    got, want = list(got), list(want)
    assert len(got) == len(want) == 120
    _same_value(got, want, "records")
    g_by, _ = port_bam.extract_reads(path, [("chr6", 0, 0)],
                                     cram_reference=genome)
    w_by, _ = ref_bam.extract_reads(path, [("chr6", 0, 0)],
                                    cram_reference=genome)
    _same_value(g_by, w_by, "by_name")


@pytest.mark.parametrize("codecs",
                         CRAM_CODECS + [{"method": ref_cram.M_RAW,
                                         "embed_reference": True}],
                         ids=_codec_id)
def test_cram_writer_agrees(world, tmp_path, monkeypatch, codecs):
    """The port's copy of the CRAM writer and the reference's write the
    same bytes from the same records, with each block codec (and raw
    blocks with the reference embedded).  The clock is held still: a gzip
    block's header carries the time it was written."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    _, _, _, pairs = world
    rng = np.random.default_rng(13)
    genome = {"chr6": "".join(rng.choice(list("ACGT"), CONTIG_LEN))}
    records = _records(pairs[:80])
    paths = {tag: str(tmp_path / f"{tag}.cram") for tag in ("port", "ref")}
    port_write_cram(paths["port"], [("chr6", CONTIG_LEN)], records, genome,
                    per_slice=50, **codecs)
    write_cram(paths["ref"], [("chr6", CONTIG_LEN)], records, genome,
               per_slice=50, **codecs)
    data = _read(paths["port"])
    assert data == _read(paths["ref"]) and len(data) > 1000
    assert len(list(port_cram.CramReader(paths["port"],
                                         reference=genome))) == 160


# ------------------------------------------------------------------ graph
def test_graph_package_compiles_the_same(world):
    _, _, pkg, _ = world
    port_pkg, ref_pkg = PortPackage(pkg.dir), RefPackage(pkg.dir)
    got, want = port_pkg.compiled(), ref_pkg.compiled()
    arrays = [k for k, v in vars(want).items() if isinstance(v, np.ndarray)]
    assert len(arrays) >= 6
    for k in vars(want):
        _same_value(getattr(got, k), getattr(want, k), k)
    assert port_pkg.segment_files() == ref_pkg.segment_files()
    assert port_pkg.prg_fasta() == ref_pkg.prg_fasta()
    _same_value(port_pkg.sequences(), ref_pkg.sequences(), "sequences")
    _same_value(port_pkg.level_to_seqpos(), ref_pkg.level_to_seqpos())
    _same_value(port_pkg.known_references(), ref_pkg.known_references())


# ---------------------------------------------------------------- mapping
def test_kmer_index_and_seeder_candidates_agree(world):
    _, sim, _, pairs = world
    seqs = {f"hap{h}": sim.linearized(h)[0].replace("_", "")
            for h in range(4)}
    got_idx = port_kmer.KmerIndex.build(seqs, k=20)
    want_idx = ref_kmer.KmerIndex.build(seqs, k=20)
    for k, v in vars(want_idx).items():
        _same_value(getattr(got_idx, k), v, k)
    reads = [r.seq for p in pairs[:60] for r in (p.r1, p.r2)]
    got, want = port_seeder.Seeder(got_idx), ref_seeder.Seeder(want_idx)
    n = 0
    for seq in reads:
        g, w = got.candidates(seq), want.candidates(seq)
        assert [c.key for c in g] == [c.key for c in w]
        _same_value(g, w, "candidates")
        n += len(g)
    assert n > len(reads)
    _same_value(got.candidates_batch_arrays(reads),
                want.candidates_batch_arrays(reads), "batch arrays")
    codes = np.frombuffer(reads[0].encode(), dtype=np.uint8)
    _same_value(port_kmer.encode_kmers(codes, 20),
                ref_kmer.encode_kmers(codes, 20), "encode_kmers")


def test_global_alignment_and_decoy_index_agree(world):
    _, sim, _, pairs = world
    a = sim.linearized(1)[0].replace("_", "")
    b = sim.linearized(2)[0].replace("_", "")
    assert port_global.global_alignment(a, b) == \
        ref_global.global_alignment(a, b)
    decoys = {"chrUn": b[200:1400]}
    reads = [p.r1.seq for p in pairs[:50]]
    np.testing.assert_array_equal(
        port_decoy.DecoyIndex.build(decoys).best_chain_kmers(reads),
        ref_decoy.DecoyIndex.build(decoys).best_chain_kmers(reads))


# --------------------------------------------------------------------- ops
def _nw_jobs(seed, B=24, L=70, W=32):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    start = W // 2 + rng.integers(-2, 3, B)
    reads = np.stack([refs[b, s:s + L] for b, s in enumerate(start)])
    sub = rng.random((B, L)) < 0.05
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    for b in range(0, B, 5):                     # a deletion in the read
        cut = int(rng.integers(10, L - 10))
        reads[b, cut:-2] = reads[b, cut + 2:]
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    return reads, lens, refs


@pytest.mark.parametrize("use_native", [True, False])
def test_numpy_nw_forward_and_backtrace_agree(use_native):
    reads, lens, refs = _nw_jobs(3)
    assert dataclasses.asdict(port_nw.NWScoring()) == \
        dataclasses.asdict(ref_nw.NWScoring())
    assert (port_nw.CIGAR_M, port_nw.CIGAR_I, port_nw.CIGAR_D) == \
        (ref_nw.CIGAR_M, ref_nw.CIGAR_I, ref_nw.CIGAR_D)
    got = port_nw.banded_nw_forward(reads, lens, refs, use_native=use_native)
    want = ref_nw.banded_nw_forward(reads, lens, refs, use_native=use_native)
    live = want[0] > -1e29
    assert live.sum() >= 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[live], w[live])
    n_gaps = 0
    for b in np.nonzero(live)[0]:
        g = port_nw.banded_nw_backtrace(got[3][b], int(lens[b]),
                                        int(got[1][b]), int(got[2][b]))
        w = ref_nw.banded_nw_backtrace(want[3][b], int(lens[b]),
                                       int(want[1][b]), int(want[2][b]))
        assert g == w and len(g) >= lens[b]
        n_gaps += sum(op != ref_nw.CIGAR_M for op, _, _ in g)
    assert n_gaps > 0


def test_projection_and_scoring_agree(world):
    """One staged NW batch of the reference aligner, projected and scored by
    both packages' project_and_score_batch and project_batch_raw."""
    _, _, pkg, pairs = world
    al = RefAligner(pkg)
    reads = [r.to_fastq() for p in pairs[:30] for r in (p.r1, p.r2)]
    seqs = [r.seq for r in reads]
    job_read, job_seq, job_rev, win_start = \
        al.seeder.candidates_batch_arrays(seqs)[:4]
    win_start = win_start - al.band // 2
    uniq, job_row = [], np.arange(len(job_read), dtype=np.int64)
    for r, rev in zip(job_read.tolist(), job_rev.tolist()):
        rd = reads[r]
        uniq.append((revcomp(rd.seq), rd.qual[::-1]) if rev
                    else (rd.seq, rd.qual))
    raw = al._align_core_raw(uniq, job_row, job_seq, win_start, job_rev)
    assert raw["ops"] is not None and len(job_read) > 60
    args = (raw["ops"], raw["n_ops"], raw["job_seq"], raw["win_start"],
            raw["reads_ascii"], raw["quals_ascii"], al.hap_codes_cat,
            al.hap_levels_cat, al.hap_offsets, al.hap_lens, raw["reverse"])
    got = port_alignment.project_and_score_batch(*args, raw["prg_ids"], False)
    want = ref_alignment.project_and_score_batch(*args, raw["prg_ids"], False)
    assert sum(a is not None for a in want) > 60
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _same_value(vars(g), vars(w), "alignment")
    _same_value(port_alignment.project_batch_raw(*args, False),
                ref_alignment.project_batch_raw(*args, False), "raw")
    chains = [a for a in got if a is not None]
    np.testing.assert_array_equal(
        port_alignment.weighted_ok_fractions_batch(chains),
        ref_alignment.weighted_ok_fractions_batch(
            [a for a in want if a is not None]))


def test_aligners_agree_with_graph_fallback_and_stats(world):
    """The port's aligner on the CPU against the reference's host aligner:
    the same pairs, chains and statistics, graph-DP fallback included."""
    _, _, pkg, pairs = world
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    port, ref = PortAligner(pkg, device="cpu"), RefAligner(pkg)
    got = port.align_pairs(fq, insert_mean=300, insert_sd=25)
    want = ref.align_pairs(fq, insert_mean=300, insert_sd=25)
    assert len(got) == len(want) > 50
    for g, w in zip(got, want):
        assert (g.read_id, g.mapq) == (w.read_id, w.mapq)
        _same_value(vars(g.chain1), vars(w.chain1), "chain1")
        _same_value(vars(g.chain2), vars(w.chain2), "chain2")
    g_stats, w_stats = vars(port.stats).copy(), vars(ref.stats).copy()
    assert g_stats.pop("extras") == {
        "nw_jobs_on_cpu": port.stats.n_chain_extensions,
        **w_stats.pop("extras")}
    assert g_stats == w_stats
    assert port.estimate_insert_size(fq) == ref.estimate_insert_size(fq)


def test_likelihood_host_half_agrees():
    rng = np.random.default_rng(17)
    C, J, R = 14, 40, 23
    cons = rng.choice(list("ACGT_"), J)
    seqs = []
    for _ in range(C):
        s = cons.copy()
        flip = rng.random(J) < 0.08
        s[flip] = rng.choice(list("ACGT_N"), int(flip.sum()))
        seqs.append("".join(s))
    assert port_pair.LOG_HALF == ref_pair.LOG_HALF
    np.testing.assert_array_equal(port_pair.cluster_onehot(seqs),
                                  ref_pair.cluster_onehot(seqs))
    codes = ref_pair.cluster_channel_codes(seqs)
    np.testing.assert_array_equal(port_pair.cluster_channel_codes(seqs),
                                  codes)
    plan = ref_pair.cluster_delta_plan(codes)
    _same_value(port_pair.cluster_delta_plan(codes), plan, "plan")
    assert len(plan[2]) > 0
    contrib_T = rng.normal(-2, 1, (J * 6, R)).astype(np.float32)
    mismatch_T = (rng.random((J * 6, R)) < 0.1).astype(np.float32)
    want = ref_pair.cluster_read_ll_delta(codes, contrib_T, mismatch_T)
    _same_value(port_pair.cluster_read_ll_delta(codes, contrib_T,
                                                mismatch_T), want, "delta")
    _same_value(port_pair.cluster_read_ll_delta_numpy(codes, contrib_T,
                                                      mismatch_T),
                ref_pair.cluster_read_ll_delta_numpy(codes, contrib_T,
                                                     mismatch_T), "numpy")
    L = rng.normal(-40, 8, (C, R)).astype(np.float32)
    np.testing.assert_array_equal(port_pair.pair_ll_reduction_numpy(L),
                                  ref_pair.pair_ll_reduction_numpy(L))
    mm = rng.integers(0, 5, (C, R)).astype(np.float32)
    for c1 in (0, C - 1):
        np.testing.assert_array_equal(
            port_pair.pair_min_mismatch_row(mm, c1),
            ref_pair.pair_min_mismatch_row(mm, c1))


# -------------------------------------------------------------- whole CLI
def _pp_table(path):
    """ClusterID -> (P, LL, Mismatches_avg) of a pair-posterior dump."""
    with open(path) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    assert rows[0] == ["ClusterID", "P", "LL", "Mismatches_avg"]
    return {r[0]: tuple(float(x) for x in r[1:]) for r in rows[1:]}


def _assert_runs_match(port_dir, ref_dir, bestguess_bytes=True):
    """Calls equal and Q within 1e-6; every file byte-identical except the
    pair-posterior dumps, held value by value: P within 1e-6, LL within the
    pair reduction's rtol 1e-6 / atol 1e-2, mismatches equal.
    bestguess_bytes=False (a world with a Q that is neither 0 nor 1, whose
    last printed digits follow the float32 pair sums): the bestguess table
    is held field by field only."""
    names = _tree(ref_dir)
    assert _tree(port_dir) == names and len(names) >= 10
    with open(os.path.join(port_dir, "hla", "R1_bestguess.txt")) as fh:
        got = [line.rstrip("\n").split("\t") for line in fh]
    with open(os.path.join(ref_dir, "hla", "R1_bestguess.txt")) as fh:
        want = [line.rstrip("\n").split("\t") for line in fh]
    assert len(got) == len(want) > 2 and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in Q_COLS:
                assert abs(float(a) - float(b)) <= 1e-6, (i, a, b)
            else:
                assert a == b, (i, a, b)
    for name in sorted(names):
        if "_PP_" in name:
            g = _pp_table(os.path.join(port_dir, name))
            w = _pp_table(os.path.join(ref_dir, name))
            assert g.keys() == w.keys() and len(w) >= 3
            for key, (p, ll, mm) in w.items():
                assert abs(g[key][0] - p) <= 1e-6, (name, key)
                assert abs(g[key][1] - ll) <= 1e-2 + 1e-6 * abs(ll)
                assert g[key][2] == mm, (name, key)
        elif bestguess_bytes or not name.endswith("R1_bestguess.txt"):
            assert _read(os.path.join(port_dir, name)) == \
                _read(os.path.join(ref_dir, name)), name


def _cli_inputs(kind, root, sim, pairs):
    """CLI arguments for one kind of input, with its files written."""
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    if kind == "fastq":
        ref_fastq.write_fastq(os.path.join(root, "R_1.fq"),
                              [a for a, _ in fq])
        ref_fastq.write_fastq(os.path.join(root, "R_2.fq"),
                              [b for _, b in fq])
        return ["--FASTQ1", os.path.join(root, "R_1.fq"),
                "--FASTQ2", os.path.join(root, "R_2.fq")]
    if kind == "bam":
        path = os.path.join(root, "in.bam")
        w = ref_bam.BamWriter(path, [("chr6", CONTIG_LEN)])
        for r in _records(pairs):
            w.write(r)
        w.close()
        return ["--BAM", path]
    if kind == "cram":
        rng = np.random.default_rng(23)
        genome = {"chr6": "".join(rng.choice(list("ACGT"), CONTIG_LEN))}
        ref_fasta.write_fasta(os.path.join(root, "genome.fa"), genome)
        path = os.path.join(root, "in.cram")
        write_cram(path, [("chr6", CONTIG_LEN)], _records(pairs), genome,
                   per_slice=500, method=ref_cram.M_RANS4x8)
        return ["--BAM", path, "--ref", os.path.join(root, "genome.fa")]
    rng = np.random.default_rng(29)
    rs = ref_sim.ReadSimulator(rng, insertion_rate=0.004,
                               deletion_rate=0.004)
    reads = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        reads += rs.simulate_unpaired_from_string(seq, levels, 5.0,
                                                  read_length=900,
                                                  name_prefix=f"lr{h}")
    path = os.path.join(root, "R_U.fq")
    ref_fastq.write_fastq(path, [r.to_fastq() for r in reads])
    return ["--FASTQU", path, "--longReads", "ont2d"]


@pytest.mark.parametrize("kind", ["fastq", "bam", "cram", "long_reads"])
def test_whole_cli_matches_the_reference(world, kind):
    root, sim, pkg, pairs = world
    inputs = _cli_inputs(kind, root, sim, pairs)
    common = ["--action", "HLA", *inputs, "--graph", pkg.dir,
              "--sampleID", "S1"]
    port_dir = os.path.join(root, f"{kind}_port")
    ref_dir = os.path.join(root, f"{kind}_ref")
    assert port_main(common + ["--outputDirectory", port_dir,
                               "--device", "cpu"]) == 0
    assert ref_main(common + ["--outputDirectory", ref_dir]) == 0
    _assert_runs_match(port_dir, ref_dir)
