"""Randomized soak of the full CLI: random worlds x input modes.

Each trial: simulate a package (random size/haplotypes/genes), simulate
reads from two random haplotypes (random coverage/read length/error),
feed them through a random input mode (BAM, CRAM, FASTQ pair, long-read
FASTQU), and assert the diploid calls are exactly the simulated truth.
Any crash or wrong call = bug.

The twin of soak.py for the PyTorch/CUDA port: the same trials, with the
port's CLI, simulators and typers, on the device that run() is given (the
card unless "cpu"; no fallback).

    python3 soak_torch.py [n] [start] [mode] [--device cuda|cpu]"""
import os
import shutil
import sys
import tempfile
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hla_la_tpu_torch import cli
from hla_la_tpu_torch.io.bam import BamRecord, BamWriter, FLAG_PAIRED, \
    FLAG_READ1, FLAG_READ2, FLAG_REVERSE
from hla_la_tpu_torch.io.fastq import write_fastq
from hla_la_tpu_torch.sim.graph_sim import simulate_prg_package
from hla_la_tpu_torch.sim.read_sim import ReadSimulator, revcomp

DEVICE = "cuda"     # where the trials run; run() sets it


def main(argv: list) -> int:
    """The port's CLI on DEVICE."""
    return cli.main([*argv, "--device", DEVICE])


def _emit_pair(w: "BamWriter", p, tlen: bool = False) -> None:
    """Write one simulated pair as two BAM records (reference orientation,
    reverse flag; optional TLEN like the KIR workflow expects) — the ONE
    place every soak mode shares, so flag/orientation handling cannot
    diverge between modes."""
    tl = (abs(p.r2.start_pos - p.r1.start_pos) + len(p.r2.seq)) if tlen \
        else 0
    for mf, r, t in ((FLAG_READ1, p.r1, tl), (FLAG_READ2, p.r2, -tl)):
        s, q = r.seq, r.qual
        flag = FLAG_PAIRED | mf
        if r.reverse:
            s, q = revcomp(s), q[::-1]
            flag |= FLAG_REVERSE
        kw = {"tlen": t} if tlen else {}
        w.write(BamRecord(name=r.name, flag=flag, ref_id=0,
                          pos=max(r.start_pos, 0), mapq=60,
                          cigar=[(len(s), 0)], seq=s, qual=q, **kw))


def one_trial(seed: int, base: str) -> str:
    rng = np.random.default_rng(seed)
    # most seeds sample the nominal regime; every 10-seed block also hits
    # the stress corners that found bugs during round 2 (dense panels,
    # platinum depth + MiSeq-length reads, tiny worlds)
    regime = ["nominal"] * 7 + ["dense", "platinum", "tiny"]
    regime = regime[seed % 10]
    backbone = int(rng.integers(*{"tiny": (400, 900)}.get(
        regime, (1200, 4000))))
    n_hap = int(rng.integers(*{"dense": (8, 13)}.get(regime, (3, 7))))
    sim = simulate_prg_package(rng, backbone_length=backbone,
                               n_haplotypes=n_hap)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    h1, h2 = rng.choice(np.arange(1, n_hap), size=2, replace=False)
    # NOTE no short-single-end mode: unpaired reads under 1000bp are a
    # non-workflow in the reference too (HLATyper.cpp:1032) — the CLI
    # warns and produces flat self-signalling output (suite-tested)
    mode = ["bam", "cram", "fastq", "long"][seed % 4]
    if regime == "tiny" and mode == "long":
        mode = "fastq"   # tiny worlds can be shorter than an ONT read
    if regime == "platinum":          # 40-60x WGS depth, 150-250bp reads
        cov = float(rng.uniform(40, 60))
        rl = int(rng.integers(150, 251))
        frag_mean = int(rng.integers(rl + 100, rl + 300))
    elif regime == "tiny":            # short fragments that FIT the world
        cov = float(rng.uniform(12, 25))
        rl = int(rng.integers(60, 100))
        frag_mean = int(rng.integers(150, 250))
    else:
        cov = float(rng.uniform(8, 20))
        rl = int(rng.integers(70, 140))
        frag_mean = int(rng.integers(250, 400))
    rs = ReadSimulator(rng, read_length=rl,
                       fragment_mean=frag_mean,
                       fragment_sd=int(rng.integers(15, 40)),
                       with_error=bool(seed % 3))
    pairs = []
    for h in (h1, h2):
        seq, levels = sim.linearized(int(h))
        pairs += rs.simulate_pairs_from_string(seq, levels, cov,
                                               name_prefix=f"h{h}")
    out_dir = os.path.join(base, "out")
    argv = ["--action", "HLA", "--graph", pkg_dir, "--sampleID", "S",
            "--workingDir", base, "--outputDirectory", out_dir,
            "--seed", str(seed)]
    if mode in ("bam", "cram"):
        class _Rec:
            def __init__(self):
                self.records = []

            def write(self, r):
                self.records.append(r)
        rec = _Rec()
        for p in pairs:
            _emit_pair(rec, p)
        records = rec.records
        if mode == "bam":
            path = os.path.join(base, "in.bam")
            w = BamWriter(path, [("chr6", contig_len)])
            for r in records:
                w.write(r)
            w.close()
            argv += ["--BAM", path]
        else:
            from hla_la_tpu_torch.io.cram_write import write_cram
            from hla_la_tpu_torch.io.cram import M_ARITH, M_FQZ, M_TOK3, \
                M_RANSNx16, M_GZIP
            ref_seq = "".join(rng.choice(list("ACGT"), contig_len))
            path = os.path.join(base, "in.cram")
            meth = [M_GZIP, M_RANSNx16, M_ARITH][seed % 3]
            write_cram(path, [("chr6", contig_len)], records,
                       {"chr6": ref_seq}, per_slice=int(rng.integers(
                           200, 2000)), method=meth,
                       qual_method=M_FQZ if seed % 2 else None,
                       name_method=M_TOK3 if seed % 2 else None)
            fa = os.path.join(base, "genome.fa")
            with open(fa, "w") as fh:
                fh.write(">chr6\n" + ref_seq + "\n")
            argv += ["--BAM", path, "--ref", fa]
    elif mode == "fastq":
        r1 = [p.r1.to_fastq() for p in pairs]
        r2 = [p.r2.to_fastq() for p in pairs]
        write_fastq(os.path.join(base, "R1.fq"), r1)
        write_fastq(os.path.join(base, "R2.fq"), r2)
        argv += ["--FASTQ1", os.path.join(base, "R1.fq"),
                 "--FASTQ2", os.path.join(base, "R2.fq")]
    else:   # long-read mode: ONT-like fragments (subs + indels, 0-6%)
        reads = []
        rng2 = np.random.default_rng(seed + 1)
        err = float(rng2.uniform(0, 0.06))
        for h in (h1, h2):
            seq, levels = sim.linearized(int(h))
            for i in range(60):
                L = int(rng2.integers(800, min(2500, len(seq) - 1)))
                s0 = int(rng2.integers(0, len(seq) - L))
                frag = list(seq[s0:s0 + L])
                if err > 0:
                    out_chars = []
                    for c in frag:
                        r = rng2.random()
                        if r < err * 0.5:          # substitution
                            out_chars.append("ACGT"[int(
                                rng2.integers(0, 4))])
                        elif r < err * 0.75:       # deletion
                            continue
                        elif r < err:              # insertion
                            out_chars.append(c)
                            out_chars.append("ACGT"[int(
                                rng2.integers(0, 4))])
                        else:
                            out_chars.append(c)
                    frag = out_chars
                from hla_la_tpu_torch.io.fastq import FastqRead
                reads.append(FastqRead(f"L{h}_{i}", "".join(frag),
                                       "I" * len(frag)))
        write_fastq(os.path.join(base, "RU.fq"), reads)
        argv += ["--FASTQU", os.path.join(base, "RU.fq"),
                 "--longReads", "ont2d"]
    rc = main(argv)
    assert rc == 0, f"rc={rc}"
    want = {locus: (f"{h1 + 1:02d}", f"{h2 + 1:02d}")
            for locus in ("A", "B")}
    _assert_diploid_calls(out_dir, want)
    return mode


def _assert_diploid_calls(out_dir: str, want: dict[str, tuple[str, str]]
                          ) -> None:
    """Assert R1_bestguess calls match the per-locus truth pair.

    graph_sim names haplotype h's allele *0{h+1}:01 (hap 0 = backbone);
    calls may be semicolon tie-sets (exon-identical alleles) — the true
    allele must appear in each chromosome's set, one chromosome each.
    Low-confidence mismatches are accepted IFF the truth pair carries
    (near-)equal posterior in the PP table (quantified ambiguity)."""
    path = os.path.join(out_dir, "hla", "R1_bestguess.txt")
    with open(path) as fh:
        lines = [l.split("\t") for l in fh.read().splitlines()[1:]]
    got: dict[str, list[set[str]]] = {}
    qs: dict[str, list[float]] = {}
    for f in lines:
        alts = {a.split("*")[1].split(":")[0] for a in f[2].split(";")}
        got.setdefault(f[0], []).append(alts)
        qs.setdefault(f[0], []).append(float(f[3]))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for locus, chroms in got.items():
        w1, w2 = want[locus]
        assert len(chroms) == 2, (locus, chroms)
        a, b = chroms
        ok = (w1 in a and w2 in b) or (w2 in a and w1 in b)
        if not ok and min(qs[locus]) < 0.9:
            pp = os.path.join(out_dir, "hla", f"R1_PP_{locus}_pairs.txt")
            best_p, truth_p = None, 0.0
            want_pair = {f"{locus}*{w1}:01", f"{locus}*{w2}:01"}
            for l in open(pp).read().splitlines()[1:]:
                cid, p = l.split("\t")[0], float(l.split("\t")[1])
                if best_p is None:
                    best_p = p
                pair_alleles = set()
                for half in cid.split("/"):
                    pair_alleles.update(half.split(";"))
                if want_pair <= pair_alleles:
                    truth_p = max(truth_p, p)
            ok = best_p is not None and truth_p >= 0.8 * best_p
        assert ok, (locus, chroms, (w1, w2), qs[locus])


def one_recomb_trial(seed: int, base: str) -> str:
    """Recombinant chromosome: chrom 1 switches panel haplotypes BETWEEN
    the two genes (a legal graph path no single linearized haplotype
    expresses) — reads spanning the junction must still chain/align
    (graph-fallback territory) and each locus must be typed to the
    haplotype that actually covers ITS exons."""
    rng = np.random.default_rng(seed)
    n_hap = int(rng.integers(4, 7))
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1500, 3500)), n_haplotypes=n_hap)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    ha, hb, hc = (int(x) for x in
                  rng.choice(np.arange(1, n_hap), size=3, replace=False))
    # crossover in the inter-gene backbone (genes span 0.15-0.45 and
    # 0.55-0.85 of the columns): gene A's exons come from ha, gene B's
    # from hb
    x = int(rng.uniform(0.47, 0.53) * sim.n_columns)
    aligned = sim.haplotypes[ha][:x] + sim.haplotypes[hb][x:]
    seq = []
    levels = []
    for i, c in enumerate(aligned):
        if c != "_":
            seq.append(c)
            levels.append(i)
    mosaic = "".join(seq)
    mosaic_levels = np.asarray(levels, dtype=np.int64)
    rs = ReadSimulator(rng, read_length=int(rng.integers(80, 130)),
                       fragment_mean=int(rng.integers(250, 400)),
                       fragment_sd=int(rng.integers(15, 40)),
                       with_error=bool(seed % 3))
    cov = float(rng.uniform(10, 20))
    pairs = rs.simulate_pairs_from_string(mosaic, mosaic_levels, cov,
                                          name_prefix="mos")
    seq_c, levels_c = sim.linearized(hc)
    pairs += rs.simulate_pairs_from_string(seq_c, levels_c, cov,
                                           name_prefix=f"h{hc}")
    path = os.path.join(base, "in.bam")
    w = BamWriter(path, [("chr6", contig_len)])
    for p in pairs:
        _emit_pair(w, p)
    w.close()
    out_dir = os.path.join(base, "out")
    assert main(["--action", "HLA", "--graph", pkg_dir, "--sampleID", "S",
                 "--workingDir", base, "--outputDirectory", out_dir,
                 "--BAM", path, "--seed", str(seed)]) == 0
    _assert_diploid_calls(out_dir, {
        "A": (f"{ha + 1:02d}", f"{hc + 1:02d}"),
        "B": (f"{hb + 1:02d}", f"{hc + 1:02d}"),
    })
    return f"recomb h{ha}|h{hb} x h{hc}"


def one_heldout_trial(seed: int, base: str) -> str:
    """Held-out allele: one chromosome carries a NOVEL variant of a panel
    haplotype (exonic+flanking mutations, not in the allele DB) — reads
    must still seed/align through the nearby panel sequences and the call
    must be the nearest DB allele (the source haplotype's), as for real
    patient alleles absent from IMGT."""
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1500, 3500)), n_haplotypes=int(rng.integers(3, 6)))
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    n_hap = len(sim.haplotypes)
    h1, h2 = rng.choice(np.arange(1, n_hap), size=2, replace=False)
    # novel variant of hap h1: mutate ~0.3-0.8% of bases everywhere
    seq1, lv1 = sim.linearized(int(h1))
    rate = float(rng.uniform(0.003, 0.008))
    s = list(seq1)
    n_mut = 0
    for i in range(len(s)):
        if rng.random() < rate:
            s[i] = "ACGT"[("ACGT".index(s[i])
                           + int(rng.integers(1, 4))) % 4]
            n_mut += 1
    novel = "".join(s)
    # error model ON: with error-free reads every pristine-chromosome obs
    # carries weightedOK exactly 1.0 while every novel-chromosome obs sits
    # strictly below it (its own novel mutations), so the filterFirst20
    # top-N (reference semantics, HLATyper.cpp:1509-1719) deterministically
    # erases the true allele at >=N coverage -> confident wrong homozygote
    # (seeds 33696/33706).  Real reads have quality noise; the weight
    # distributions overlap and the novel allele stays in the top N.
    rs = ReadSimulator(rng, read_length=int(rng.integers(90, 130)),
                       fragment_mean=int(rng.integers(260, 380)),
                       fragment_sd=int(rng.integers(15, 35)),
                       with_error=True)
    bam = os.path.join(base, "in.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    for name_prefix, seq, levels in (
            (f"n{h1}", novel, lv1),
            (f"h{h2}", *sim.linearized(int(h2)))):
        for p in rs.simulate_pairs_from_string(
                seq, levels, float(rng.uniform(12, 18)),
                name_prefix=name_prefix):
            _emit_pair(w, p)
    w.close()
    out_dir = os.path.join(base, "out")
    rc = main(["--action", "HLA", "--BAM", bam, "--graph", pkg_dir,
               "--sampleID", "S", "--workingDir", base,
               "--outputDirectory", out_dir, "--seed", str(seed)])
    assert rc == 0
    with open(os.path.join(out_dir, "hla", "R1_bestguess.txt")) as fh:
        lines = [l.split("\t") for l in fh.read().splitlines()[1:]]
    got: dict[str, list[set[str]]] = {}
    for f in lines:
        got.setdefault(f[0], []).append(
            {a.split("*")[1].split(":")[0] for a in f[2].split(";")})
    w1, w2 = f"{h1 + 1:02d}", f"{h2 + 1:02d}"
    for locus, chroms in got.items():
        assert len(chroms) == 2, (locus, chroms)
        a, b = chroms
        ok = (w1 in a and w2 in b) or (w2 in a and w1 in b)
        assert ok, (locus, chroms, (w1, w2), f"n_mut={n_mut} rate={rate}")
    return "heldout"


def one_kir_trial(seed: int, base: str) -> str:
    """Randomized --action KIR: random ALT panel (size, SNP load, indels),
    random (possibly homozygous) haplotype pair, BAM in -> exact haplotype
    calls out."""
    from hla_la_tpu_torch.models.kir_package import build_kir_package
    rng = np.random.default_rng(seed)
    L = int(rng.integers(1500, 4000))
    n_haps = int(rng.integers(3, 7))
    backbone = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
    haps = {}
    for hi in range(n_haps):
        s = list(backbone)
        for _ in range(int(rng.integers(20, 80))):
            p = int(rng.integers(0, L))
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        if rng.random() < 0.5:      # an aligned deletion block
            d0 = int(rng.integers(L // 4, L // 2))
            for p in range(d0, d0 + int(rng.integers(3, 15))):
                s[p] = "-"
        haps[f"KIR_ALT{hi}"] = "".join(s)
    g1 = (100, min(L // 3, 900))
    g2 = (L // 2, L // 2 + min(L // 3, 800))
    ann = {h: [("KIR2DL1", *g1), ("KIR3DL2", *g2)] for h in haps}
    pkg_dir = os.path.join(base, "kir")
    build_kir_package(pkg_dir, haps, ann,
                      covered_regions={"chr19": (0, 100000)})
    names = sorted(haps)
    h1 = names[int(rng.integers(n_haps))]
    h2 = names[int(rng.integers(n_haps))]    # may equal h1 (homozygous)
    rs = ReadSimulator(rng, read_length=int(rng.integers(80, 130)),
                       fragment_mean=int(rng.integers(250, 400)),
                       fragment_sd=int(rng.integers(15, 40)))
    bam = os.path.join(base, "in.bam")
    w = BamWriter(bam, [("chr19", 200000)])
    cov = float(rng.uniform(8, 20))
    for h in (h1, h2):
        seq = haps[h].replace("-", "")
        for p in rs.simulate_pairs_from_string(
                seq, np.arange(len(seq)), cov / 2, name_prefix=h):
            _emit_pair(w, p, tlen=True)
    w.close()
    out_dir = os.path.join(base, "out")
    rc = main(["--action", "KIR", "--ALTpanel", pkg_dir, "--BAM", bam,
               "--sampleID", "K", "--workingDir", base,
               "--outputDirectory", out_dir])
    assert rc == 0
    hap_call = open(os.path.join(out_dir,
                                 "KIR_haplotypes.txt")).read().splitlines()
    called = hap_call[1].split("\t")[:2]
    want = sorted((h1, h2))
    assert sorted(called) == want, (called, want)
    return "kir"


def one_asm_trial(seed: int, base: str) -> str:
    """Randomized HLA-ASM: random package, contigs = (possibly
    reverse-complemented, possibly truncated, lightly mutated) haplotype
    sequences -> per-locus calls must be the haplotype's alleles with edit
    distance <= the planted mutation count."""
    from hla_la_tpu_torch.models.asm import AssemblyTyper
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1500, 4000)), n_haplotypes=int(rng.integers(3, 6)))
    pkg = sim.write_package(os.path.join(base, "g"))
    n_hap = len(sim.haplotypes) if hasattr(sim, "haplotypes") else 3
    h = int(rng.integers(1, n_hap))
    seq, _ = sim.linearized(h)
    n_mut = int(rng.integers(0, 4))
    s = list(seq)
    for _ in range(n_mut):
        p = int(rng.integers(50, len(s) - 50))
        s[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[p]]
    contig = "".join(s)
    if rng.random() < 0.5:
        contig = revcomp(contig)
    lo = int(rng.integers(0, len(contig) // 10))
    hi = len(contig) - int(rng.integers(0, len(contig) // 10))
    contig = contig[lo:hi]
    typer = AssemblyTyper(pkg, device=DEVICE)
    calls = typer.type_contigs({"c1": contig})
    want = f"{h + 1:02d}"
    by_locus = {}
    for c in calls:
        by_locus.setdefault(c.locus, c)
    assert by_locus, "no gene hits on contig"
    for locus, c in by_locus.items():
        field = c.allele.split("*")[1].split(":")[0]
        # truncated contigs may clip a gene; full-distance calls on a
        # clipped gene are reported with large edit distance — only check
        # calls the typer itself considers close
        if c.edit_distance <= n_mut:
            # ties: haplotypes can coincide over a gene's exons — the
            # wanted allele must be IN the min-edit tie set
            fields = {a.split("*")[1].split(":")[0]
                      for a in c.alleles_at_min}
            assert want in fields, (locus, c.alleles_at_min, want,
                                    c.edit_distance)
    assert any(c.edit_distance <= n_mut for c in calls), \
        [(c.locus, c.allele, c.edit_distance) for c in calls]
    return "asm"


def one_decoy_trial(seed: int, base: str) -> str:
    """Randomized paralog defense: a mutated off-graph copy of a gene
    (random divergence 2-8%) contaminates the input; with
    --mapAgainstCompleteGenome the typing must still be exact and the
    paralog pairs must not reach the typer."""
    from hla_la_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1800, 4000)), n_haplotypes=int(rng.integers(3, 6)),
        snp_rate=0.012)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    n_hap = len(sim.haplotypes)
    h1, h2 = rng.choice(np.arange(1, n_hap), size=2, replace=False)
    # paralog: one gene region of a random haplotype, mutated
    hp = int(rng.integers(1, n_hap))
    hap_seq, lv = sim.linearized(hp)
    gene = "A" if rng.random() < 0.5 else "B"
    gene_cols = [i for i, nm in enumerate(sim.column_names)
                 if f"_gene_{gene}_" in nm]
    lo, hi = min(gene_cols), max(gene_cols)
    mask = (lv >= lo) & (lv <= hi)
    gene_seq = "".join(np.array(list(hap_seq))[mask])
    rate = float(rng.uniform(0.02, 0.08))
    para = [("ACGT"[("ACGT".index(c) + int(rng.integers(1, 4))) % 4]
             if rng.random() < rate else c) for c in gene_seq]
    flank_l = "".join(rng.choice(list("ACGT"), 3000))
    flank_r = "".join(rng.choice(list("ACGT"), 3000))
    decoy_contig = flank_l + "".join(para) + flank_r
    decoy_fa = os.path.join(base, "decoy.fa")
    write_fasta(decoy_fa, {"chr11_para": decoy_contig})
    rs = ReadSimulator(rng, read_length=int(rng.integers(80, 130)),
                       fragment_mean=int(rng.integers(250, 400)),
                       fragment_sd=int(rng.integers(15, 40)),
                       with_error=True)
    class _Rec:
        def __init__(self):
            self.records = []

        def write(self, r):
            self.records.append(r)

    rec = _Rec()

    def emit(p):
        _emit_pair(rec, p)
    records = rec.records

    for h in (h1, h2):
        seq, levels = sim.linearized(int(h))
        for p in rs.simulate_pairs_from_string(
                seq, levels, float(rng.uniform(10, 16)),
                name_prefix=f"h{h}"):
            emit(p)
    n_para = 0
    for p in rs.simulate_pairs_from_string(
            decoy_contig, np.full(len(decoy_contig), -1, dtype=np.int64),
            10.0, name_prefix="para"):
        if (p.r1.start_pos > len(flank_l) - 200
                and p.r1.start_pos < len(flank_l) + len(para)):
            emit(p)
            n_para += 1
    bam = os.path.join(base, "in.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    for r in records:
        w.write(r)
    w.close()
    out_dir = os.path.join(base, "out")
    rc = main(["--action", "HLA", "--BAM", bam, "--graph", pkg_dir,
               "--sampleID", "S", "--workingDir", base,
               "--outputDirectory", out_dir, "--seed", str(seed),
               "--mapAgainstCompleteGenome", "1",
               "--decoyFasta", decoy_fa])
    assert rc == 0
    with open(os.path.join(out_dir, "hla", "R1_bestguess.txt")) as fh:
        lines = [l.split("\t") for l in fh.read().splitlines()[1:]]
    w1, w2 = f"{h1 + 1:02d}", f"{h2 + 1:02d}"
    got: dict[str, list[set[str]]] = {}
    for f in lines:
        got.setdefault(f[0], []).append(
            {a.split("*")[1].split(":")[0] for a in f[2].split(";")})
    for locus, chroms in got.items():
        a, b = chroms
        ok = (w1 in a and w2 in b) or (w2 in a and w1 in b)
        assert ok, (locus, chroms, (w1, w2), f"n_para={n_para}")
    # paralog leakage into the utilized-read sets must stay marginal (the
    # defense drops pairs that seed better on the decoy; low-divergence
    # copies can legitimately tie — the in-suite contract allows ~5%)
    import glob
    leaked = 0
    for p in glob.glob(os.path.join(out_dir, "hla", "R1_readIDs_*.txt")):
        leaked += sum(1 for l in open(p) if l.startswith("para"))
    # the PRIMARY contracts are the exact-call assert above and the
    # in-suite fixed-divergence test (>=94% dropped at 4% divergence,
    # tests/test_decoy.py).  At the 2-4% divergence this trial draws,
    # individual read pairs legitimately tie between the PRG and the
    # decoy copy (few informative k-mers), so the ratio is noisy at
    # small n_para — this bound only catches the defense NOT ENGAGING
    assert leaked <= max(3, (6 * n_para) // 10), (leaked, n_para, rate)
    return "decoy"


def one_validate_trial(seed: int, base: str) -> str:
    """Randomized --action validate: a 2-sample cohort with known diploid
    truth must report 100% accuracy at every resolution (each sample's
    alleles are exon-distinct panel haplotypes)."""
    rng = np.random.default_rng(seed)
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1500, 3500)), n_haplotypes=5)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    rs = ReadSimulator(rng, read_length=int(rng.integers(80, 120)),
                       fragment_mean=int(rng.integers(260, 380)),
                       fragment_sd=int(rng.integers(15, 35)),
                       with_error=bool(seed % 2))
    sheet = []
    truth_rows = ["IndividualID\tA\tA\tB\tB"]
    hap_pairs = [(1, 2), (3, 4)]
    for si, (h1, h2) in enumerate(hap_pairs):
        bam = os.path.join(base, f"S{si}.bam")
        w = BamWriter(bam, [("chr6", contig_len)])
        for h in (h1, h2):
            seq, levels = sim.linearized(h)
            for p in rs.simulate_pairs_from_string(
                    seq, levels, float(rng.uniform(10, 16)),
                    name_prefix=f"s{si}h{h}"):
                _emit_pair(w, p)
        w.close()
        sheet.append(f"S{si} {bam}")
        a1, a2 = f"{h1 + 1:02d}", f"{h2 + 1:02d}"
        truth_rows.append(f"S{si}\tA*{a1}:01\tA*{a2}:01\t"
                          f"B*{a1}:01\tB*{a2}:01")
    sheet_p = os.path.join(base, "sheet.txt")
    open(sheet_p, "w").write("\n".join(sheet) + "\n")
    truth_p = os.path.join(base, "truth.txt")
    open(truth_p, "w").write("\n".join(truth_rows) + "\n")
    out_dir = os.path.join(base, "valout")
    rc = main(["--action", "validate", "--graph", pkg_dir,
               "--validationBAMs", sheet_p, "--trueHLA", truth_p,
               "--workingDir", base, "--outputDirectory", out_dir,
               "--seed", str(seed)])
    assert rc == 0
    rep = open(os.path.join(out_dir, "validation_report.txt")).read()
    total = [l for l in rep.splitlines() if l.startswith("TOTAL")][0]
    accs = [float(x) for x in total.split("\t")[3:] if x]
    assert accs and all(a == 1.0 for a in accs), (total, rep)
    return "validate"


def one_shard_trial(seed: int, base: str) -> str:
    """Randomized multi-host byte-identity: the same random world typed
    single-host vs 2-host shard+merge must produce byte-identical outputs
    (bestguess, G translation, reads_per_level, per-locus pileups)."""
    import filecmp
    import glob
    rng = np.random.default_rng(seed)
    backbone = int(rng.integers(1200, 4000))
    n_hap = int(rng.integers(3, 7))
    sim = simulate_prg_package(rng, backbone_length=backbone,
                               n_haplotypes=n_hap)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    h1, h2 = rng.choice(np.arange(1, n_hap), size=2, replace=False)
    rs = ReadSimulator(rng, read_length=int(rng.integers(70, 140)),
                       fragment_mean=int(rng.integers(250, 400)),
                       fragment_sd=int(rng.integers(15, 40)),
                       with_error=bool(seed % 2))
    bam = os.path.join(base, "in.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    for h in (h1, h2):
        seq, levels = sim.linearized(int(h))
        for p in rs.simulate_pairs_from_string(
                seq, levels, float(rng.uniform(8, 16)),
                name_prefix=f"h{h}"):
            _emit_pair(w, p)
    w.close()
    single = os.path.join(base, "single")
    assert main(["--action", "HLA", "--BAM", bam, "--graph", pkg_dir,
                 "--sampleID", "S", "--workingDir", base,
                 "--outputDirectory", single, "--seed", str(seed)]) == 0
    shard_dir = os.path.join(base, "shards")
    for host in ("0", "1"):
        assert main(["--action", "HLA", "--BAM", bam, "--graph", pkg_dir,
                     "--sampleID", "S", "--workingDir", base,
                     "--outputDirectory", os.path.join(base, f"h{host}"),
                     "--nHosts", "2", "--hostIdx", host,
                     "--shardDir", shard_dir, "--seed", str(seed)]) == 0
    merged = os.path.join(base, "merged")
    assert main(["--action", "HLA", "--graph", pkg_dir, "--sampleID", "S",
                 "--workingDir", base, "--outputDirectory", merged,
                 "--mergeShards", shard_dir, "--seed", str(seed)]) == 0
    for fn in ["hla/R1_bestguess.txt", "hla/R1_bestguess_G.txt",
               "reads_per_level.txt"]:
        a, b = os.path.join(single, fn), os.path.join(merged, fn)
        assert filecmp.cmp(a, b, shallow=False), f"{fn} differs"
    for a in glob.glob(os.path.join(single, "hla", "R1_pileup_*.txt")):
        b = os.path.join(merged, "hla", os.path.basename(a))
        assert filecmp.cmp(a, b, shallow=False), os.path.basename(a)
    return "shard"


def one_remap_trial(seed: int, base: str) -> str:
    """Randomized remapAndReduce: WGS-style BAM -> PRG-coordinate BAM;
    reads must land at their exact simulated truth level (error-free
    reads: >=95%; error-model reads: >=80% — indels legitimately shift a
    window's best alignment start by a base or two)."""
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.io.bam import BamReader
    from hla_la_tpu_torch.tools import remap_and_reduce
    rng = np.random.default_rng(seed)
    n_hap = int(rng.integers(3, 7))
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1200, 3500)), n_haplotypes=n_hap)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    with_error = bool(seed % 2)
    rs = ReadSimulator(rng, read_length=int(rng.integers(70, 140)),
                       fragment_mean=int(rng.integers(250, 400)),
                       fragment_sd=int(rng.integers(15, 40)),
                       with_error=with_error)
    bam = os.path.join(base, "in.bam")
    w = BamWriter(bam, [("chr6", contig_len)])
    truth_first = {}
    n_pairs_in = 0
    for h in rng.choice(np.arange(1, n_hap), size=2, replace=False):
        seq, levels = sim.linearized(int(h))
        for p in rs.simulate_pairs_from_string(
                seq, levels, float(rng.uniform(6, 14)),
                name_prefix=f"h{h}"):
            _emit_pair(w, p)
            n_pairs_in += 1
            for is_r1, r in ((True, p.r1), (False, p.r2)):
                lv = r.levels[r.levels >= 0]
                truth_first[(r.name, is_r1)] = int(lv.min())
    w.close()
    out = os.path.join(base, "remapped.bam")
    n_pairs, n_un = remap_and_reduce(bam, GraphPackage(pkg_dir), out,
                                     device=DEVICE)
    assert n_pairs >= 0.9 * n_pairs_in, (n_pairs, n_pairs_in)
    rd = BamReader(out)
    recs = list(rd)
    rd.close()
    assert len(recs) == 2 * n_pairs
    assert all(a.pos <= b.pos for a, b in zip(recs, recs[1:]))
    exact = sum(r.pos == truth_first[(r.name, r.is_read1)] for r in recs)
    floor = 0.80 if with_error else 0.95
    assert exact >= floor * len(recs), \
        f"{exact}/{len(recs)} at truth level (floor {floor})"
    return f"remap {'err' if with_error else 'clean'} " \
           f"{exact}/{len(recs)} exact"


def one_corrupt_trial(seed: int, base: str) -> str:
    """Randomized corruption: random byte flips / truncations of a BAM or
    CRAM input must either fail LOUDLY or leave the typing outputs
    byte-identical to the clean run — never silently different (every
    decoded byte is CRC-protected: BGZF CRC32/ISIZE, CRAM block +
    container-header CRC32s, BGZF EOF-marker check)."""
    import filecmp
    import glob
    import io as _io
    from contextlib import redirect_stderr, redirect_stdout
    rng = np.random.default_rng(seed)
    n_hap = int(rng.integers(3, 6))
    sim = simulate_prg_package(rng, backbone_length=int(
        rng.integers(1000, 2500)), n_haplotypes=n_hap)
    pkg_dir = os.path.join(base, "g")
    sim.write_package(pkg_dir)
    contig_len = 100000
    with open(os.path.join(pkg_dir, "knownReferences", "fake.txt"),
              "w") as fh:
        fh.write("contigID\tcontigLength\tExtractCompleteContig\t"
                 "PartialExtraction_Start\tPartialExtraction_Stop\n")
        fh.write(f"chr6\t{contig_len}\t1\t\t\n")
    h1, h2 = rng.choice(np.arange(1, n_hap), size=2, replace=False)
    rs = ReadSimulator(rng, read_length=int(rng.integers(70, 120)),
                       fragment_mean=300, fragment_sd=25,
                       with_error=bool(seed % 2))
    records = []

    class _Rec:
        def write(self, r):
            records.append(r)
    rec = _Rec()
    for h in (h1, h2):
        seq, levels = sim.linearized(int(h))
        for p in rs.simulate_pairs_from_string(
                seq, levels, float(rng.uniform(6, 12)),
                name_prefix=f"h{h}"):
            _emit_pair(rec, p)
    use_cram = bool(seed % 2)
    argv_extra = []
    if use_cram:
        from hla_la_tpu_torch.io.cram_write import write_cram
        ref_seq = "".join(rng.choice(list("ACGT"), contig_len))
        path = os.path.join(base, "in.cram")
        write_cram(path, [("chr6", contig_len)], records, {"chr6": ref_seq})
        fa = os.path.join(base, "genome.fa")
        with open(fa, "w") as fh:
            fh.write(">chr6\n" + ref_seq + "\n")
        argv_extra = ["--ref", fa]
    else:
        path = os.path.join(base, "in.bam")
        w = BamWriter(path, [("chr6", contig_len)])
        for r in records:
            w.write(r)
        w.close()

    def run_cli(inp, out_dir):
        argv = ["--action", "HLA", "--graph", pkg_dir, "--sampleID", "S",
                "--workingDir", base, "--outputDirectory", out_dir,
                "--BAM", inp, "--seed", str(seed)] + argv_extra
        sink = _io.StringIO()
        try:
            with redirect_stdout(sink), redirect_stderr(sink):
                return main(argv)
        except (Exception, SystemExit):
            return -1   # loud failure

    clean_dir = os.path.join(base, "clean")
    assert run_cli(path, clean_dir) == 0, "clean run must succeed"
    clean_files = sorted(
        glob.glob(os.path.join(clean_dir, "hla", "R1_bestguess*.txt"))
        + glob.glob(os.path.join(clean_dir, "hla", "R1_pileup_*.txt"))
        + [os.path.join(clean_dir, "reads_per_level.txt")])

    good = open(path, "rb").read()
    n_loud = n_benign = 0
    for trial_i in range(6):
        b = bytearray(good)
        if trial_i == 5 or rng.random() < 0.25:   # truncation
            b = b[:int(rng.integers(1, len(b)))]
        else:                                     # 1-4 byte flips
            for _ in range(int(rng.integers(1, 5))):
                off = int(rng.integers(0, len(b)))
                b[off] ^= int(rng.integers(1, 256))
        bad_path = os.path.join(
            base, "bad.cram" if use_cram else "bad.bam")
        open(bad_path, "wb").write(bytes(b))
        out_dir = os.path.join(base, f"out{trial_i}")
        rc = run_cli(bad_path, out_dir)
        if rc != 0:
            n_loud += 1
            continue
        for a in clean_files:                     # benign: byte-identical
            c = os.path.join(out_dir, os.path.relpath(a, clean_dir))
            assert filecmp.cmp(a, c, shallow=False), \
                f"SILENT CORRUPTION: {os.path.basename(a)} differs (rc=0)"
        n_benign += 1
    return f"corrupt {'cram' if use_cram else 'bam'} " \
           f"{n_loud} loud / {n_benign} benign"


def run(n: int, start: int, mode: str = "hla", device: str = "cuda") -> int:
    global DEVICE
    from hla_la_tpu_torch.device import resolve
    DEVICE = resolve(device).type      # raises here without the device
    fails = 0
    trial = {"kir": one_kir_trial, "asm": one_asm_trial,
             "shard": one_shard_trial, "decoy": one_decoy_trial,
             "validate": one_validate_trial,
             "heldout": one_heldout_trial,
             "recomb": one_recomb_trial,
             "remap": one_remap_trial,
             "corrupt": one_corrupt_trial}.get(mode, one_trial)
    for seed in range(start, start + n):
        base = tempfile.mkdtemp(prefix=f"soak{seed}_")
        try:
            label = trial(seed, base)
            print(f"seed {seed}: OK ({label})", flush=True)
        except (Exception, SystemExit):   # CLI errors raise SystemExit;
            fails += 1                    # count them, don't kill the batch
            print(f"seed {seed}: FAIL", flush=True)
            traceback.print_exc()
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return fails


def soak_main(argv=None) -> int:
    """The command line: the card's line first, the trials' lines, then
    one JSON line."""
    import argparse
    import json
    from hla_la_tpu_torch.bench_common import card_line
    ap = argparse.ArgumentParser(description="randomized soak of the CLI")
    ap.add_argument("n", type=int, nargs="?", default=20)
    ap.add_argument("start", type=int, nargs="?", default=1000)
    ap.add_argument("mode", nargs="?", default="hla")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    card = card_line(args.device)
    print(card, flush=True)
    fails = run(args.n, args.start, args.mode, args.device)
    print(json.dumps({"mode": args.mode, "seeds": [args.start,
                      args.start + args.n - 1], "trials": args.n,
                      "fails": fails, "device": args.device, "card": card}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(soak_main())
