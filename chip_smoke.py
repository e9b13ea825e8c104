"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero
and no result line is printed.  The three full-size worlds are built in
processes of their own from the start (with the second sample of (r); the
first sample's BAM once the IMGT-scale world is there), and (g), (f), (i)
and (t) run before (e), while the IMGT-scale world is still being built;
(r) and (s) run after (m):

  (a) toolchain: torch, CUDA, nvcc, and the card's name and power limit;
  (b) build: compile the kernels from hla_la_tpu_torch/csrc with nvcc;
  (c) K1, the banded NW forward, against its plain PyTorch version on the
      card, bit-identical on live rows and across reruns, through the GPU
      probe ``hla_la_tpu_torch.gpu_check.run``: first its own random ACGT
      jobs at the main path's shape, with its HEALTHY/DEGRADED verdict, then
      B x L x W = 65,536 x 101 x 32 (the short-read main path's shape),
      4,096 x 101 x 32 (also held against the CPU), 4,096 x 77 x 31 (a band
      that is not a multiple of the kernel's four cells per lane) and
      4,096 x 150 x 10 (a narrow band, eight jobs per warp);
  (d) K3, the pair-likelihood difference term, against its plain version at
      C = 2,200 clusters x R = 16,460 reads (the e2e world's locus A shape,
      not a multiple of the kernel's read chunk), rtol 1e-6 and atol 1e-2 on
      the full pair log-likelihood, exactly symmetric and bit-identical
      across reruns; the kernel's and the plain version's largest error
      against a float64 numpy evaluation on sampled cluster pairs; and the
      kernel's share of its special-function bound;
  (e) end to end: an IMGT-scale two-locus world (stress_imgt.py's recipe:
      2,200 alleles per locus, 1,250x targeted coverage) typed by the port's
      CLI (``--action HLA --device cuda``).  The main path must launch K1 and
      K3; the calls must hold the planted alleles with Q1 > 0.9 at C >= 2,000
      clusters per locus, and the full pair dump must be written;
  (f) reference on a small world (60 alleles per locus, 40x): the port's CLI
      on cuda against the port's CLI on the CPU, whose plain kernels the
      tests hold to the JAX package.  Identical coverage track and calls,
      Q1/Q2 within 1e-3;
  (g) K2, the banded NW forward for bands wider than 32, against the same
      plain version on the card, bit-identical on live rows and across
      reruns, at B x L x W = 128 x 4,096 x 256 (a quarter of the length of
      the long-read working point 128 x 16,384 x 256, which bench_nw.py
      times: the plain version's row loop is the longest wait of this
      script there), 1,024 x 1,400 x 160 (W not a power of two), 256 x 500 x 100
      (four cells per lane; also held against the CPU), 64 x 1,000 x 600
      (a job across three warps), 256 x 500 x 33 (a band that is not a
      multiple of the cells per lane, two jobs per warp), 838 x 10,000 x 256
      (the most jobs one NW call of phase (h) holds under the aligner's
      pointer budget) and 8,192 x 1,100 x 256 (pointer offsets past 2^31);
      and, in a process of its own while (f), (i) and (t) run, 32 x 50,000
      x 256 (a split long read's 50 kb chunk, as (y) has them);
  (h) end to end on long reads: a two-locus world with class-I-sized genes
      (2,200 alleles per locus) and unpaired 10 kb ONT-like reads at 30x,
      typed by the port's CLI (``--longReads ont2d --FASTQU ... --device
      cuda``).  The path must launch K2 and K3 and run every NW job on the
      card; each locus must call exactly its planted alleles with Q1 > 0.9.
      K3 is then held against its plain version at each locus's C x R, as
      in (d);
  (i) the same recipe at a small size (backbone 6,000, 60 alleles, 2 kb
      reads at 12x) on cuda against the CPU, as (f);
  (j) the kernels at the shapes of the linear-ALT (KIR) and assembly (ASM)
      typers: K1 at the KIR run's NW call, 65,536 x 100 x 32, with a
      quarter of the windows off a haplotype's left or right end; K2 at one
      exon of the ASM world, 2,200 alleles x the longest allele x 48, under
      the unit scoring (match 0, every penalty -1: ties everywhere), ragged
      lengths against one shared window; both bit-identical to the plain
      version on live rows; K3 at C = 32 and C = 6 haplotypes with
      R = 22,500 and R = 45,000, as in (d);
  (k) ``--action KIR --BAM ... --device cuda`` on a linear-ALT package of
      32 haplotypes of 150 kb with 14 genes and paired 100 bp reads at 15x
      from two planted haplotypes: the planted pair called with posterior
      > 0.9, reads2Genes at least 90% right against the simulator's truth,
      no read from outside the covered region, every NW job on the card in
      calls of jobs_per_call jobs, K1 and K3 launched.  K3 is then held
      against its plain version at the run's C x R;
  (l) ``--action ASM --device cuda`` on the world of (e) with two contigs
      cut from the planted haplotypes, one reverse-complemented: each
      contig's call holds its planted allele at edit distance 0,
      genePositions.tab puts every exon on its contig's strand, K2
      launched;
  (m) small KIR and ASM worlds on cuda against the CPU: calls, reads2Genes,
      summary.txt and genePositions.tab equal, posterior within 1e-3;
  (n) K3's launch rule and tile ranges: with one tile (C = 32 and C = 6 at
      R = 22,500) the read range is cut into more than one block and the
      kernel beats its plain version; at C = 2,200 x R = 16,460 and at
      C = 32 the tile ranges that 2 and 4 model ranks take sum to the
      one-call matrix bit for bit;
  (o) the CLI's paralog defence and an ambiguous call, cuda against the
      CPU: the decoy world with ``--decoyFasta`` (the same pairs dropped,
      nearly all of the paralog's, the same calls), and the ambiguous world
      (a Q1 strictly inside (0.05, 0.95); Q1/Q2 within 1e-3);
  (p) worker processes and align shards on cuda: ``--maxThreads 4`` on the
      world of (e) (host-only workers: this process's device server runs
      their NW calls, and the card holds one context): every output file
      byte-equal to the one-process run of (e), every NW job on the card,
      the workers' jobs all run and K1 launched for them by the server, no
      worker with CUDA initialised (ready or after its last task), and no
      worker among nvidia-smi's compute apps while the pool is up; then,
      on the small world of (f), ``run_hla_typing`` with four workers and
      the typing workers' gate lowered, so that K3 is launched for the
      workers too, and ``--nHosts 2 --hostIdx 0/1 --shardDir`` and
      ``--mergeShards``, each byte-equal to (f)'s one-process run (both on
      the small world since (z) runs the fan-out at IMGT scale: the time
      limit).  One-process and worker walls are printed side by side, with
      each worker's ready split;
  (q) the sharded backend on the one card: ``ShardedNW`` bit-equal to
      ``NWRunner.run`` and ``pair_ll_reduction_sharded`` within rtol 1e-6 /
      atol 1e-2 of the one-device reduction, on an NCCL group of one rank
      and on two gloo ranks that share the card (their collectives on host
      tensors); then the CLI's ``--sharded 1`` (NCCL) on the small world of
      (f) and ``--sharded 4`` (gloo) on the world of (e) against the
      one-process runs: NW batches split over all four ranks, the pair
      reduction over the 2 x 2 mesh that follows from their count (each
      rank half of K3's tile list on half the reads); the same calls, Q1/Q2
      within 1e-3, every NW job on the card, K1 and K3 launched on every
      rank.  One card cannot show traffic BETWEEN cards: that is not
      measured here.

  (r) ``--action validate`` on a cohort of two IMGT-scale samples in one
      process, started for it (``sim.cohort_world``: S1 is the world of (e)
      read from a BAM, S2 reads of haplotypes 3 and 4 of the same package;
      the truth table names one wrong allele of S2 at locus B): "cohort
      accuracy: 87.50%", one discordant call whose pileup analysis lists
      columns, S1's calls those of (e), every NW job of each sample on the
      card, K1 and K3 launched for each (S1 as often as in (e)), and the
      page-locked bytes of the process not grown from S1 to S2; per sample
      its wall, align s and type s;
  (s) ``--action remapAndReduce`` on S1's BAM: at least 90% of the pairs
      written, coordinate-sorted on the one PRG contig inside its levels,
      every NW job on the card, K1 launched;
  (t) every action the port gained with (r) and (s), on the small world
      of (f) and its cohort, and ``--extractExonkMerCounts 1``, cuda
      against the CPU: the same printed lines (but testPRGMapping's rate)
      and files (BAMs as records, pair dumps and bestguess tables with Q
      within 1e-3, the rest byte for byte); the five aligning self-tests
      print OK on cuda and launch K1.
  (u) the twin of __graft_entry__.entry (``hla_la_tpu_torch.graft_entry``)
      on cuda against the CPU: NW scores bit-identical, the pair matrix
      within rtol 1e-6 / atol 1e-2, the marginal within 1e-4; K1 and K3
      launched;
  (v) ``graft_entry.dryrun_multichip(2, "cuda")``: two gloo ranks on the
      card, the sharded kernel step, the typing step against the host
      formula and the miniature world typed on both ranks with the calls of
      one;
  (w) bench.py's real-PRG-scale world (``sim.bench_world``: 3,000,000
      levels, genes A and B, ~30k pairs) through bench_torch.py's objects,
      one align pass and one type pass: truth accuracy over 0.95, the calls
      exactly the planted alleles, K1 launched for the host-only workers
      and K3 in this process (two loci: under the typing fan-out's gate),
      every NW job on the card, no worker with CUDA initialised; then K1
      at the workers' call shape against its plain version;
  (x) stress_wgs.py's world with all 17 loci (``sim.wgs_world``) at a cut
      coverage of WGS_SMOKE_COVERAGE (3,000,000 levels and 17 loci kept;
      ~60k pairs, over the typing fan-out's gate of 50,000 aligned reads;
      stress_wgs_torch.py carries the full 12x): typed serially and with the
      fan-out, byte-identical, exact at every locus, K1 launched for the
      align workers and K3 for the typing workers (all host-only, served
      by this process); then K1 at the workers' call shape and K3 at the
      largest locus's C x R;
  (y) stress_long.py's reads of the bench panel (``sim.long_bench_reads``
      at a cut coverage of LONG_SMOKE_COVERAGE: ~9 Mb of 2-48 kb reads and
      the eight 60-90 kb reads cut at 50 kb) typed
      through run_hla_typing in long-read mode with 4 workers: the planted
      alleles called, truth accuracy over 0.9, every NW job on the card, K2
      launched for the host-only workers; then K3 at the largest locus's
      C x R.
  (z) ``stress_imgt_torch.py --loci4 --sharded`` in a process of its own,
      started with this one and waiting until (z) (its peak-memory check
      reads ru_maxrss, which starts from the forking process's peak): four
      loci of 2,200 alleles on a backbone of 8,000 (~83,000 pairs at
      1,250x) aligned in 8 workers, typed serially and with the per-locus
      fan-out, which must pass its real gate (50,000 aligned reads, 4
      loci) and run in 4 host-only typing workers with K3 launched for
      them once per locus at C >= 2,000, each launch timed in the device
      server; the script's checks (planted alleles in the called
      clusters, Q1 > 0.9, R floors, the full pair dumps, peak RSS, the
      fan-out byte-identical to serial); then K1 at the workers' call
      shape and K3 at one locus's C x R against their plain versions,
      and the script's kernel section at the run's largest C x R (K3 cold
      and warm, the host's native kernel, numpy on a slice of
      IMGT_NUMPY_SLICE_R reads, extrapolated), held to each other;
  (aa) stress_imgt.py --long: 1.5-3.8 kb reads of the world of (e)
      (``sim.imgt_long_reads``) aligned in long-read mode by the host-only
      workers (K2 launched for them) and typed in long-read mode at C >=
      2,000: the planted alleles in the called clusters, every NW job on
      the card; K2 bit-identical to its
      plain version at the run's largest NW call, K3 at its largest locus;
  (ab) from the same run, ``--sharded``: the pair reduction at the C x R of
      (z) on 8 ranks sharing the card (model 2 x data 4, gloo), within rtol
      1e-6 / atol 1e-2 of one device and of the host's native kernel; each
      rank's tile range, reads and K3 times; K3 at rank 0's share against
      plain;
  (ac) tpu_e2e.py's twin (``e2e_torch.main``, record in build/): the GPU
      probe, tpu_e2e.py's world on the CPU and on cuda cold and warm with
      identical calls, K3 at 2,200 x 16,384;
  (ad) bench_scaling.py's twin at 1, 2 and 4 ranks on the card: each rank
      count's NW scores bit-equal to one device and its pair matrix within
      rtol 1e-6 / atol 1e-2; one JSON line per count;
  (ae) soak.py's twin on cuda: seeds 1000-1003 of mode hla (BAM, CRAM,
      FASTQ pair, long reads) and seed 1000 of each other mode, all 13
      passing; the three kernels held to their plain versions at the
      largest launch each made;
  (af) ``--action KIR --sharded 2`` on the world of (k), two gloo ranks
      sharing the card: the call, posterior (within 1e-3) and reads2Genes
      of (k)'s one-process run; every NW call's scores and the likelihood
      rows bit-equal to (k)'s (``LinearALTsTyper.trace``), the pair LL
      within rtol 1e-6 / atol 1e-2; every NW job on the card on each rank;
      each rank's K1 and K3 launches and largest launch, and K1 and K3 held
      to their plain versions at the ranks' largest shapes;
  (ag) ``--action KIRsimulation --backend sharded`` (one rank on the card,
      through the --backend translation) on the small KIR world of (m) and
      ``--action TestHLATyping --sharded 2``: the planted calls, printed as
      the one-process runs print them, K1 and K3 launched on every rank;
  (ah) ``--action HLA --sharded 2 --maxThreads 4`` on the world of (e):
      one pool of 4 host-only workers, in rank 0, whose NW calls rank 0's
      device server runs (K1 launched for them), the alignments handed to
      rank 1 (bytes and seconds printed), every NW job on the card, no
      worker with torch imported, nvidia-smi listing the two ranks'
      contexts and no other while the run is up; the calls of (p)'s
      ``--maxThreads 4`` run with Q1/Q2 within 1e-3 and the pair dumps
      within rtol 1e-6 / atol 1e-2 (below the typing workers' gate both
      ranks run the sharded typer), then ``--sharded 2`` without workers
      on the same world for its align phase; then on the small world of (f)
      the typing workers' gate lowered on 2 ranks
      (``launch.rank_hla_typing``): rank 0 types in its pool, K3 launched by
      its device server for the workers, rank 1 runs no typer, every file
      byte-equal to (p)'s typing-workers run; then the long reads of (i)
      on 2 ranks with the pool's read threshold lowered to their count:
      rank 0's 4 workers align them, K2 launched for them by its device
      server, rank 1 takes the unpaired chains and both type them in the
      sharded typer, held to (i)'s cuda run as above.
  (ai) the pair epilogue (``ops/pair_ll.pair_epilogue``) at C x R =
      2,200 x 180 (an ``hla-imgt2`` locus) and 1,200 x 400, a quarter of
      the clusters' LL rows distinct and the rest their copies, as IMGT
      clusters tie, the mismatch rows tied apart from them: the card
      route against the host route on the same K3 input (the host route
      with K3 on the card, as a served typer takes it),
      the dump's columns and order, the triangle's values, P, the
      marginals, best1, best2, Q1, Q2 and the dump's bytes bit-identical,
      the card route counted; each route's host seconds and the card
      route's card time by CUDA events, median of 5 after a warm-up.
      (ai) runs first, before any world is built, on a quiet host.
  The three real-scale worlds and tpu_e2e.py's world are built in
  processes of their own from the start, beside the others (the four-locus
  world and the long reads of (aa) once the world of (e) is there), and
  (u)-(ah) run last, (ab) before (aa).

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them is the kernels' JSON
record, one entry per kernel and main path (K1 runs on fifteen, K2 on
five, K3 on eighteen; a path of (z)-(ah) also says where its launches
ran),
with the launches of that path's run and the kernel's time beside its
bound: the larger of its bytes (inputs read once, outputs written once) over
the card's memory rate and its operations over the card's peak rate for
their type, and, for K3, the time of its library call where that fits.
Nothing here imports jax or the JAX package.
The worlds are cached under build/chip_smoke_world/.  One kernel alone:

    python -c "import chip_smoke as c; c.check_nw_long(128, 4096, 256, {})"
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

for _blocked in ("jax", "hla_la_tpu"):   # any import of either fails loudly
    sys.modules[_blocked] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD_DIR = os.path.join(ROOT, "build", "chip_smoke_world")
# peaks of one H100 SXM (NVIDIA's data sheet; CUDA programming guide,
# arithmetic instruction throughput at compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16       # ex2, lg2, rcp, ... results per clock
NW_FLOPS_PER_CELL = 10          # 3 states: 5 adds, 5 max/selects
PAIR_FLOPS_PER_CELL = 5         # sub, mul, add 1, two running sums
PAIR_SFU_PER_CELL = 2           # one exp and one log
PAIR_F64_SAMPLES = 2048
# (B, L, W) of phase (c): the main path's shape first (the one recorded),
# then a batch also held against the CPU, a band that is not a multiple of
# the kernel's cells per lane, and an odd L with a narrow band
NW_SHAPES = ((65536, 101, 32), (4096, 101, 32), (4096, 77, 31),
             (4096, 150, 10))
NW_CPU = NW_SHAPES[1]
PAIR_C, PAIR_R = 2200, 16460
PAIR_RTOL, PAIR_ATOL = 1e-6, 1e-2
# K3's library call (pair_library) runs where its intermediate fits here
PAIR_LIBRARY_MAX_BYTES = 8e9
Q_TOL = 1e-3
Q1_MIN, C_MIN = 0.9, 2000       # stress_imgt.py's checks at IMGT scale
SMALL_WORLD = {"n_alleles": 60, "coverage": 40.0}
# (B, L, W) of phase (g) besides the shape of phase (h)'s NW calls; the
# third is also held against the CPU, the last passes 2^31 pointer bytes
NW_LONG_SHAPES = ((128, 4096, 256), (1024, 1400, 160), (256, 500, 100),
                  (64, 1000, 600), (256, 500, 33), (8192, 1100, 256))
NW_LONG_CPU = NW_LONG_SHAPES[2]
LONG_W = 256                    # the aligner's band in long-read mode
# (i) at 12x, cut from 20x for the time limit (its CPU run's plain NW at
# the long-read band is most of the phase)
SMALL_LONG_WORLD = {"backbone": 6000, "n_alleles": 60, "coverage": 12.0,
                    "read_length": 2000}
KIR_L, KIR_W = 100, 32          # the KIR world's reads, LinearALTsTyper.band
ASM_W = 48                      # AssemblyTyper.band
EDIT_SCORING = {"match": 0.0, "mismatch": -1.0, "gap_open": -1.0,
                "gap_extend": -1.0}     # models/asm.py::EDIT_SCORING
KIR_PAIR_SHAPES = ((32, 22500), (32, 45000), (6, 22500), (6, 45000))
POSTERIOR_MIN, R2G_MIN = 0.9, 0.9       # the KIR self-test's bars
SMALL_KIR_WORLD = {"length": 12000, "coverage": 10.0}
# (x) at a diploid coverage of 4: ~60k pairs, over the fan-out's gate
WGS_SMOKE_COVERAGE = 4.0
# (y) at a cut coverage of its windows (stress_long.py's is 25x), over the
# 512 reads from which run_hla_typing aligns in workers (~585 at 15x); its
# reads past 50 kb, two per window and haplotype, are drawn at any coverage
LONG_SMOKE_COVERAGE = 15.0
MARG_ATOL = 1e-4                # graft entry's marginal, cuda vs the CPU
# (z): the numpy reduction's read slice (stress_imgt.py's 512 reads take
# tens of GB of float64 temporaries at C = 2,200)
IMGT_NUMPY_SLICE_R = 32
# (ad): rank counts; (ae): soak seeds, fixed before any run
SCALING_RANKS = (1, 2, 4)
SOAK_HLA_SEEDS = (1000, 1001, 1002, 1003)     # bam, cram, fastq, long
SOAK_SEED = 1000
SOAK_MODES = ("kir", "asm", "shard", "decoy", "validate", "heldout",
              "recomb", "remap", "corrupt")
# (y): K2 at the split long reads' L (a 50 kb chunk) and the long-read band
SPLIT_NW_SHAPE = (32, 50000, 256)
SPLIT_RECORD = os.path.join(WORLD_DIR, "runs", "split_check.json")


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


_WORLD_BUILDS: dict = {}        # simulator's name -> the process making it


def start_world_builds(names=("typing_world", "long_read_world",
                              "kir_world", "second_sample"),
                       code="getattr(sim, sys.argv[1])(sys.argv[2])"
                       ) -> None:
    """Build the full-size worlds of simulators `names` into the cache
    under WORLD_DIR, each in a process of its own, while the kernels are
    built and held against their plain versions: the simulators are host
    Python and take minutes.  `code` builds world `sys.argv[1]` in
    directory `sys.argv[2]`."""
    for name in names:
        _WORLD_BUILDS[name] = subprocess.Popen(
            [sys.executable, "-c", "import sys; from hla_la_tpu_torch "
             "import sim; " + code, name, WORLD_DIR], cwd=ROOT)


def start_real_scale_builds() -> None:
    """The worlds of (w)-(y), each in a process of its own: bench.py's, the
    long reads of its panel (with the panel drawn again and its package
    written beside them), and stress_wgs.py's at a cut coverage."""
    start_world_builds(("bench_world",))
    start_world_builds(("long_bench_reads",), "sim.long_bench_reads("
                       f"sys.argv[2], coverage={LONG_SMOKE_COVERAGE!r})")
    start_world_builds(("wgs_world",), "sim.wgs_world(sys.argv[2], "
                       f"{WGS_SMOKE_COVERAGE!r})")


def start_e2e_build() -> None:
    """tpu_e2e.py's world for (ac), in a process of its own, in
    e2e_torch.py's cache (where its main looks)."""
    start_world_builds(("e2e_world",), "import e2e_torch; sim.e2e_world("
                       "e2e_torch.CACHE, e2e_torch.BACKBONE)")


def start_imgt_builds() -> None:
    """The worlds of (z) and (aa), each in a process of its own once the
    IMGT-scale world of (e) is built (so that they do not slow its build):
    stress_imgt.py's four-locus world, in stress_imgt_torch.py's cache
    (where its main looks), and the long reads of the world of (e)."""
    start_world_builds(("imgt4_world",), "import stress_imgt_torch as si; "
                       "si.imgt_world(loci4=True)")
    start_world_builds(("imgt_long_reads",), "sim.imgt_long_reads("
                       "sim.typing_world(sys.argv[2]))")


def start_imgt_twin() -> None:
    """``stress_imgt_torch.py --loci4 --sharded`` for (z) and (ab), in a
    process started now, while this one is small, that waits for a line on
    its input before it imports anything: a process's peak resident memory
    (ru_maxrss) starts from that of the process it was forked from, and the
    script checks its own peak.  (z) writes the line."""
    _WORLD_BUILDS["imgt_twin"] = subprocess.Popen(
        [sys.executable, "-c", "import sys\n"
         "sys.stdin.readline()\n"
         "import stress_imgt_torch as si\n"
         f"si.NUMPY_SLICE_R = {IMGT_NUMPY_SLICE_R}\n"
         "sys.exit(si.main(sys.argv[1:]))", "--loci4", "--sharded"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def start_split_check() -> None:
    """K2 at the shape of (y) against its plain version, in a process of
    its own: the plain version's row loop takes one and a half minutes,
    while the host-bound phases (f), (i) and (t) leave the card nearly
    idle.  Its record goes to SPLIT_RECORD, which (y) reads."""
    os.makedirs(os.path.dirname(SPLIT_RECORD), exist_ok=True)
    _WORLD_BUILDS["split_check"] = subprocess.Popen(
        [sys.executable, "-c", "import json, sys; import chip_smoke as c; "
         "r = {}; c.check_nw_long(*c.SPLIT_NW_SHAPE, r); "
         "json.dump(r, open(sys.argv[1], 'w'))", SPLIT_RECORD], cwd=ROOT)


def start_bam_build() -> None:
    """S1's BAM of the cohort of (r): the IMGT-scale world's reads, written
    in a process of its own once that world is built."""
    start_world_builds(("world_bam",),
                       "sim.world_bam(sim.typing_world(sys.argv[2]))")


def wait_build(name: str) -> None:
    proc = _WORLD_BUILDS.pop(name, None)
    if proc is not None and proc.wait() != 0:
        fail(f"{name} failed in its own process (exit code "
             f"{proc.returncode})")


def built_world(name: str, make=None):
    """The full-size world of simulator `name` (or what `make(sim)` returns)
    from the cache, once its build process (if one was started) has
    ended."""
    from hla_la_tpu_torch import sim
    t0 = time.perf_counter()
    wait_build(name)
    world = (make or (lambda s: getattr(s, name)(WORLD_DIR)))(sim)
    print(f"{name} ready after a further {time.perf_counter() - t0:.1f} s")
    return world


def stop_world_builds() -> None:
    for proc in _WORLD_BUILDS.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    _WORLD_BUILDS.clear()


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    from hla_la_tpu_torch.gpu_check import cuda_ms as probe_ms
    return probe_ms(fn, reps)


def sm_clocks_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock of card 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout
    now, top = (float(x) for x in out.strip().split(","))
    return now, top


def nw_bound(B: int, L: int, W: int) -> dict:
    """The least time the card could take for one NW forward call: reads,
    lengths and refs read once, scores, ends and pointers written once,
    against NW_FLOPS_PER_CELL float32 operations per cell."""
    n_bytes = B * L + 4 * B + B * (L + W) + 12 * B + B * (L + 1) * W
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = NW_FLOPS_PER_CELL * B * L * W / FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}     # no single PyTorch call computes it


def live_pairs(C: int, tile_range=None) -> int:
    """Cluster pairs c1 <= c2 of the whole matrix, or of the tiles
    (first, count) of K3's tile list alone."""
    if tile_range is None:
        return C * (C + 1) // 2
    from hla_la_tpu_torch.ops.pair_ll import PAIR_TILE as T, _tile_rows
    n = 0
    for ti, tj_lo, tj_hi in _tile_rows(C, *tile_range):
        rows = min((ti + 1) * T, C) - ti * T
        cols = min((tj_hi + 1) * T, C) - tj_lo * T
        # the row's first tile may lie on the diagonal: its lower half is
        # the mirror of its upper half
        n += rows * cols - (rows * (rows - 1) // 2 if tj_lo == ti else 0)
    return n


def pair_bound(C: int, R: int, max_mhz: float, tile_range=None) -> dict:
    """The least time the card could take for the pair reduction's
    C (C + 1) / 2 * R cells (those of `tile_range` alone, where given): L
    read and the output written once, against the float32 operations and
    against the two special-function results per cell at the card's top
    clock.  The latter is the larger by far."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cells = live_pairs(C, tile_range) * R
    by_bytes = 4 * (C * R + C * C) / HBM_BYTES_PER_S * 1e3
    by_flops = PAIR_FLOPS_PER_CELL * cells / FP32_FLOPS * 1e3
    by_sfu = (PAIR_SFU_PER_CELL * cells
              / (SFU_PER_CLOCK_PER_SM * sms * max_mhz * 1e6) * 1e3)
    by_ops = max(by_flops, by_sfu)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_ms_float32_only": by_flops}


def toolchain() -> str:
    import torch
    from hla_la_tpu_torch import _build
    from hla_la_tpu_torch.bench_common import card_line
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    smi = card_line("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}")
    print(f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    print(f"device 0: {torch.cuda.get_device_name(0)}; "
          f"count {torch.cuda.device_count()}; nvidia-smi: {smi}")
    return smi


def nw_world(rng, B: int, L: int, W: int, ref_n_rate: float = 0.002):
    """Alignable reads cut from random refs with substitutions and indels,
    plus N bases in reads and in refs (at `ref_n_rate`), suffix ref pads,
    uneven lengths and one empty read.  A ref N on a job's path leaves it
    no alignment (score NEG), so long jobs take a rate that keeps most of
    them alive."""
    import numpy as np
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    pos = W // 2 + rng.integers(-3, 4, B)
    col = np.arange(L)[None, :]
    # a random indel drift per read: +-1 steps at a few places
    steps = (rng.random((B, L)) < 0.02) * rng.choice([-1, 1], (B, L))
    src = np.clip(pos[:, None] + col + np.cumsum(steps, axis=1), 0,
                  L + W - 1)
    reads = np.take_along_axis(refs, src, axis=1)
    sub = rng.random((B, L)) < 0.03
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    reads[rng.random((B, L)) < 0.003] = 4                  # N in reads
    refs[rng.random((B, L + W)) < ref_n_rate] = 4          # N in refs
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    lens[rng.random(B) < 0.5] = L
    lens[0] = 0
    for b in range(0, B, 7):                               # suffix pads
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    reads[col >= lens[:, None]] = 4                        # pad past len
    return reads, lens, refs


def kir_nw_world(rng, B: int, L: int, W: int):
    """The linear-ALT typer's jobs: nw_world's reads and refs, with every
    eighth window off its haplotype's left end (pad codes up to W / 2
    columns in) and every eighth off its right end (pad codes from
    somewhere past the band's middle on)."""
    import numpy as np
    reads, lens, refs = nw_world(rng, B, L, W)
    col = np.arange(L + W)[None, :]
    left = np.arange(B) % 8 == 1
    right = np.arange(B) % 8 == 5
    refs[left[:, None] & (col < rng.integers(1, W // 2 + 1, B)[:, None])] = 4
    refs[right[:, None]
         & (col >= rng.integers(W // 2 + 4, L + W, B)[:, None])] = 4
    return reads, lens, refs


def exon_nw_world(rng, B: int, L: int, W: int):
    """The assembly typer's jobs: B allele sequences of ragged lengths
    (pad code 4 past each), all against ONE contig window; an allele
    differs from the window by a few substitutions, every fourth also by a
    one-base deletion."""
    import numpy as np
    window = rng.integers(0, 4, L + W).astype(np.uint8)
    src = W // 2 + np.arange(L)[None, :] + np.zeros((B, 1), np.int64)
    cut = rng.integers(1, L - 1, B)
    gone = ((np.arange(B) % 4 == 3)[:, None]
            & (np.arange(L)[None, :] >= cut[:, None]))
    reads = window[np.minimum(src + gone, L + W - 1)]
    sub = rng.random((B, L)) < 0.01
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    lens = rng.integers(L - L // 8, L + 1, B).astype(np.int64)
    lens[0] = L
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    return reads, lens, np.repeat(window[None], B, axis=0)


def hold_nw(kernel: str, shape: str, got, others: dict) -> tuple:
    """Fail unless the kernel's outputs `got` equal every plain version's in
    `others` on the live rows (score > -1e29 in the first); returns (live
    rows, max abs score error against the first)."""
    import numpy as np
    from hla_la_tpu_torch.gpu_check import mismatch
    why = mismatch(got, others)
    if why is not None:
        fail(f"{kernel} at {shape}: {why}")
    first = next(iter(others.values()))
    live = first[0] > -1e29
    return int(live.sum()), float(np.abs(got[0][live] - first[0][live]).max())


def check_nw(B: int, L: int, W: int, record: dict | None,
             make_world=nw_world) -> None:
    """K1 against the plain version on the card (and, at NW_CPU, on the
    CPU) on make_world's jobs, through the GPU probe
    (``hla_la_tpu_torch.gpu_check.run``); the times go into `record` if one
    is given."""
    from hla_la_tpu_torch import gpu_check

    stats = {}
    if gpu_check.run(L, W, B, seed=B + L + W, stats=stats, world=make_world,
                     cpu=(B, L, W) == NW_CPU) != 0:
        fail(f"K1 at B={B} L={L} W={W}: {stats['why']}")
    bound = nw_bound(B, L, W)
    print(f"  {100 * bound['bound_ms'] / stats['ms']:.1f}% of the "
          f"{bound['bound_by']} bound {bound['bound_ms']:.4f} ms")
    if record is not None:
        record.update(max_abs_err=stats["max_abs_err"], ms=stats["ms"],
                      plain_ms=stats["plain_ms"], **bound)


def timed(fn):
    """(fn(), device ms of that one call by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_nw_long(B: int, L: int, W: int, record: dict | None,
                  unit_scoring: bool = False) -> None:
    """K2 against the plain version on the card (and, at NW_LONG_CPU, on
    the CPU); the times go into `record` if one is given.  The plain
    version's row loop takes seconds at the long shapes, so its one checked
    call is also its timed one.  With `unit_scoring`: the assembly typer's
    jobs and scoring, and the live jobs' edit distances must differ."""
    import numpy as np
    import torch
    from hla_la_tpu_torch.ops.banded_nw import DEFAULT_SCORING
    from hla_la_tpu_torch.ops.banded_nw import banded_nw_plain
    from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda

    rng = np.random.default_rng(B * L + W)
    if unit_scoring:
        sc = EDIT_SCORING
        reads, lens, refs = exon_nw_world(rng, B, L, W)
    else:
        sc = DEFAULT_SCORING
        # K1's world has 0.27 ref N per job; so has this one at every length
        reads, lens, refs = nw_world(rng, B, L, W,
                                     ref_n_rate=0.27 / (L + W))
    host = [torch.from_numpy(a) for a in (reads, lens, refs)]
    args = tuple(t.cuda() for t in host) + (sc,)
    got = [t.cpu().numpy() for t in banded_nw_long_cuda(*args)]
    sync()
    plain, plain_ms = timed(lambda: banded_nw_plain(*args))
    others = {"plain on the card": [t.cpu().numpy() for t in plain]}
    del plain
    if (B, L, W) == NW_LONG_CPU:
        others["plain on the CPU"] = [t.numpy() for t in
                                      banded_nw_plain(*host, sc)]
    shape = f"B={B} L={L} W={W}"
    n_live, err = hold_nw("K2", shape, got, others)
    if unit_scoring and (n_live < B or len(set(got[0].tolist())) < 4):
        fail(f"K2 at {shape} under unit scoring: {n_live}/{B} live jobs, "
             f"distances {sorted(set(got[0].tolist()))[:8]}")
    names = " and ".join(others)
    del others
    again = banded_nw_long_cuda(*args)
    if not all(np.array_equal(a, b.cpu().numpy())
               for a, b in zip(got, again)):
        fail(f"K2 reruns at {shape} are not bit-identical")
    del again
    ms = cuda_ms(lambda: banded_nw_long_cuda(*args), reps=5)
    gcells = B * L * W / (ms * 1e-3) / 1e9
    bound = nw_bound(B, L, W)
    print(f"K2 {shape}{' under unit scoring' if unit_scoring else ''}: "
          f"bit-identical to the {names} on {n_live}/{B} live "
          f"rows, and across reruns; kernel {ms:.4f} ms ({gcells:.2f} "
          f"Gcells/s, {100 * bound['bound_ms'] / ms:.1f}% of the "
          f"{bound['bound_by']} bound {bound['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms ({B * (L + 1) * W / 1e6:.1f} MB of pointers)")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def pair_f64_errors(L, versions: dict) -> dict:
    """Largest |acc - float64 acc| of each version's (acc, Rpad) on
    PAIR_F64_SAMPLES cluster pairs: random ones, the corners and the pairs
    across the first tile seam.  The float64 value is numpy's, on the
    float32 L; padded reads add log 2 each."""
    import numpy as np
    C, R = L.shape
    rng = np.random.default_rng(C * R)
    c1 = rng.integers(0, C, PAIR_F64_SAMPLES)
    c2 = rng.integers(0, C, PAIR_F64_SAMPLES)
    fixed = [(0, 0), (0, C - 1), (C - 1, C - 1), (C - 1, 0),
             (min(63, C - 1), min(64, C - 1))]
    c1[:len(fixed)], c2[:len(fixed)] = zip(*fixed)
    L64 = L.astype(np.float64)
    want = np.empty(PAIR_F64_SAMPLES)
    for lo in range(0, PAIR_F64_SAMPLES, 256):
        d = np.abs(L64[c1[lo:lo + 256]] - L64[c2[lo:lo + 256]])
        want[lo:lo + 256] = (0.5 * d + np.log1p(np.exp(-d))).sum(axis=1)
    return {name: float(np.abs(
                acc.cpu().numpy()[c1, c2].astype(np.float64)
                - (want + math.log(2.0) * (rpad - R))).max())
            for name, (acc, rpad) in versions.items()}


def check_pair(C: int, R: int, record: dict, tile_range=None) -> None:
    """K3 against its plain version at C x R, timed beside its bound; with
    `tile_range` = (first, count), the call a model rank makes: those tiles
    of the tile list alone, held on the cells they cover."""
    import numpy as np
    import torch
    from hla_la_tpu_torch import _build
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.ops.pair_ll import LOG_HALF, pair_ll_diff_plain

    L = np.random.default_rng(0).normal(-40.0, 8.0, (C, R)
                                        ).astype(np.float32)
    Ld = torch.from_numpy(L).cuda()
    rowsum = L.astype(np.float64).sum(axis=1)
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])

    def full(acc_rpad):
        # the wrapper's host term; padded reads cancel via Rpad
        acc, rpad = acc_rpad
        return base + acc.cpu().numpy().astype(np.float64) + LOG_HALF * rpad

    acc1, rpad = pair_ll_diff_cuda(Ld, tile_range)
    acc2, _ = pair_ll_diff_cuda(Ld, tile_range)
    sync()
    if not torch.equal(acc1, acc2):
        fail("K3 reruns are not bit-identical")
    got = full((acc1, rpad))
    plain = pair_ll_diff_plain(Ld, tile_range=tile_range)
    want = full(plain)
    sync()
    if tile_range is not None:
        # what the range does not cover is zero in both and holds nothing:
        # the two versions pad the reads to different counts
        covered = (acc1 != 0).cpu().numpy()
        if not np.array_equal(covered, (plain[0] != 0).cpu().numpy()):
            fail(f"K3 C={C} R={R}: tile range {tile_range} covers other "
                 f"cells than the plain version's")
        got, want = np.where(covered, got, 0.0), np.where(covered, want, 0.0)
    err = np.abs(got - want)
    if not np.allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
        fail(f"K3 vs plain at C={C} R={R}: max abs err "
             f"{err.max():.4g} beyond rtol={PAIR_RTOL} atol={PAIR_ATOL}")
    if not np.array_equal(got, got.T):
        fail("K3 output is not symmetric")
    err64 = None    # sampled over the whole matrix: taken at this C in (d)
    if tile_range is None:
        err64 = pair_f64_errors(L, {"kernel": (acc1, rpad), "plain": plain})
    ms = cuda_ms(lambda: pair_ll_diff_cuda(Ld, tile_range), reps=5)
    mhz, max_mhz = sm_clocks_mhz()
    plain_ms = cuda_ms(
        lambda: pair_ll_diff_plain(Ld, tile_range=tile_range), reps=1)
    bound = pair_bound(C, R, max_mhz, tile_range)
    bound.update(pair_library(Ld, acc1, rpad, tile_range))
    gcells = live_pairs(C, tile_range) * R / (ms * 1e-3) / 1e9
    parts = _build.library().lib.hla_pair_ll_parts(C, R)
    if tile_range is not None:
        print(f"K3 C={C} R={R}: tiles {tile_range[0]} to "
              f"{sum(tile_range) - 1} of the tile list alone, "
              f"{live_pairs(C, tile_range)} of {live_pairs(C)} cluster pairs")
    print(f"K3 C={C} R={R} (kernel pads to {rpad} and cuts the reads into "
          f"{parts} part(s), plain pads to {plain[1]}): within rtol={PAIR_RTOL} atol={PAIR_ATOL} of plain "
          f"(max abs err {err.max():.4g}), exactly symmetric, bit-identical "
          f"reruns; "
          + (f"max |acc - float64| on {PAIR_F64_SAMPLES} sampled pairs: "
             f"kernel {err64['kernel']:.4g}, plain {err64['plain']:.4g}; "
             if err64 else "")
          + f"kernel {ms:.3f} ms ({gcells:.1f} Gcells/s over the live "
          f"cells c1 <= c2), plain {plain_ms:.3f} ms; special-function bound "
          f"{bound['bound_ms']:.3f} ms at {max_mhz:.0f} MHz "
          f"({100 * bound['bound_ms'] / ms:.1f}% of it reached; SM clock "
          f"after the timed launches {mhz:.0f} MHz); library call "
          + (f"{bound['library_ms']:.3f} ms (max abs err against the kernel "
             f"{bound['library_max_abs_err']:.4g})"
             if bound["library_ms"] is not None
             else f"none ({bound['library_why']})"))
    record.update(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                  read_parts=parts, **bound)
    if err64:
        record.update(max_abs_err_f64=err64["kernel"],
                      plain_max_abs_err_f64=err64["plain"])


def pair_library(Ld, acc, rpad: int, tile_range=None) -> dict:
    """The one PyTorch call that computes K3's difference term:
    torch.logaddexp over the broadcast pair of rows, summed over the reads,
    minus the rank-1 term 0.5 (rowsum_a + rowsum_b).  Timed by CUDA events
    where its float32 C x C x R intermediate fits in
    PAIR_LIBRARY_MAX_BYTES, and held to the kernel's `acc` (whose rpad - R
    padded reads add log 2 each); else None with the reason."""
    import torch
    C, R = Ld.shape
    need = 4 * C * C * R
    if tile_range is not None:
        return {"library_ms": None,
                "library_why": "the call computes every tile, not a range"}
    if need > PAIR_LIBRARY_MAX_BYTES:
        return {"library_ms": None,
                "library_why": f"its C x C x R float32 intermediate takes "
                               f"{need / 1e9:.1f} GB"}

    def library():
        rows = Ld.sum(dim=1)
        return (torch.logaddexp(Ld[:, None], Ld[None]).sum(-1)
                - 0.5 * (rows[:, None] + rows[None, :]))

    got = library()
    err = (got.double() - (acc.double() - math.log(2.0) * (rpad - R))
           ).abs().max().item()
    del got
    return {"library_ms": cuda_ms(library, reps=3),
            "library_max_abs_err": err}


@contextlib.contextmanager
def captured_stderr(sink: io.StringIO):
    """What this process AND the processes it starts write to file
    descriptor 2 goes into `sink` (and on to the real stderr afterwards):
    worker processes and ranks log there directly."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as fh:
        os.dup2(fh.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            fh.seek(0)
            text = fh.read().decode(errors="replace")
            sink.write(text)
            sys.stderr.write(text)


def read_table(path: str) -> list[list[str]]:
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def run_port(device: str, world, out_dir: str, extra=()) -> dict:
    """Type `world` with the port's CLI on `device` (plus the `extra`
    arguments); the kernels' launch counters are zeroed just before the run
    and read just after it.  With worker processes, every launch is still
    this process's: its device server runs the host-only workers' device
    calls, and the launches it made for them are read from the run's
    summed statistics ("served_launches"), with the workers' ready lines
    and their reports."""
    from hla_la_tpu_torch.bench_common import worker_lines
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
            "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
            device, *extra]
    log = io.StringIO()
    kernels = {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
               "K3": pair_ll_diff_cuda}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with captured_stderr(log):
        rc = port_main(argv)
    if device == "cuda":
        sync()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    if rc != 0:
        fail(f"port run on {device} failed (rc {rc})")
    text = log.getvalue()
    m_al = re.search(r"aligned (\d+)/(\d+) pairs \+ (\d+)/(\d+) unpaired "
                     r"in ([0-9.]+) s on \S+ \(([0-9.]+) reads/s\)", text)
    m_ty = re.search(r"typed (\d+) loci in ([0-9.]+) s", text)
    m_jobs = re.search(r"n_chain_extensions: (\d+)", text)
    m_dev = re.search(rf"nw_jobs_on_{device}: (\d+)", text)
    loci = re.findall(r"  (\S+): (\d+) clusters x (\d+) reads", text)
    if not (m_al and m_ty and m_jobs and loci):
        fail("port log lacks the align/type timing lines")
    nw_jobs = int(m_jobs.group(1))
    if not (m_dev and int(m_dev.group(1)) == nw_jobs):
        fail(f"not every one of the {nw_jobs} NW jobs ran on {device}")
    hla = os.path.join(out_dir, "hla")
    dropped = re.search(r"decoy_dropped_pairs: (\d+)", text)
    return {"dir": out_dir, "launches": launches, "wall_s": wall,
            "log": text,
            "served_launches": {
                k: int(n) for k, n in
                re.findall(r"served_launches_(K\d): (\d+)", text)},
            "decoy_dropped_pairs": int(dropped.group(1)) if dropped else 0,
            **worker_lines(text),
            "bestguess": read_table(os.path.join(hla, "R1_bestguess.txt")),
            "align_s": float(m_al.group(5)),
            "reads_per_s": float(m_al.group(6)),
            "pairs": int(m_al.group(2)), "unpaired": int(m_al.group(4)),
            "nw_jobs": nw_jobs, "type_s": float(m_ty.group(2)),
            "loci": {lc: (int(c), int(r)) for lc, c, r in loci}}


def check_host_only(res: dict, n_workers: int, kernel: str,
                    tag: str) -> None:
    """The checks of a run with `n_workers` alignment workers: every one
    was ready and stayed off CUDA, without even importing torch (ready, and
    after its last task), the
    device server ran `kernel` for them and all the NW jobs they sent, and
    every NW job of the run ran on the card (run_port checks that)."""
    if len(res["workers_ready"]) != n_workers:
        fail(f"{tag}: {len(res['workers_ready'])} of {n_workers} workers "
             f"reported ready")
    if len(res["workers_cuda"]) <= n_workers \
            or set(res["workers_cuda"]) != {"False"} \
            or set(res["workers_torch"]) != {"False"}:
        fail(f"{tag}: the workers' CUDA states {res['workers_cuda']}, torch "
             f"imported {res['workers_torch']}")
    server, served = res["server"], res["served_launches"]
    if server is None or served.get(kernel, 0) <= 0 \
            or server["launches"][kernel] != served[kernel] \
            or server["nw_jobs"] != res["served_nw_jobs"] \
            or not 0 < server["nw_jobs"] <= res["nw_jobs"]:
        fail(f"{tag}: the device server's record {server}, the workers' "
             f"served launches {served} and NW jobs "
             f"{res['served_nw_jobs']} of {res['nw_jobs']}")


def check_twin_workers(st: dict, kernels, tag: str) -> None:
    """A twin's record of a run with worker processes: every worker stayed
    off CUDA to its last task, and the device server launched each of
    `kernels` for them and ran every NW job the align workers counted."""
    cuda, served = st["workers_cuda_initialized"], st["served"]
    if not cuda or any(cuda) or any(st["workers_torch_imported"]) \
            or served is None \
            or any(served["launches"][k] <= 0 for k in kernels) \
            or not 0 < served["nw_jobs"] <= st["n_chain_extensions"]:
        fail(f"{tag}: the workers' CUDA states {cuda}, torch imported "
             f"{st['workers_torch_imported']}, the device server's record "
             f"{served} for {st['n_chain_extensions']} NW jobs")
    print(f"{tag}: {len(cuda)} worker reports, none with torch imported or "
          f"CUDA initialised; "
          f"the device server ran {served['requests']} requests, "
          f"{served['nw_jobs']} NW jobs, launches {served['launches']}")


@contextlib.contextmanager
def compute_apps_watch(poll_s: float = 1.0):
    """What ``nvidia-smi --query-compute-apps=pid`` lists before the block
    ("before": one pid per context on the card) and, polled every
    `poll_s`, while it runs ("during": every pid seen; "most": the most
    contexts listed at once)."""
    import threading

    def query() -> list:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        return [int(x) for x in out.split() if x.isdigit()]

    before = query()
    seen = {"before": before, "during": set(before), "most": len(before),
            "polls": 0}
    done = threading.Event()

    def poll():
        while not done.wait(poll_s):
            pids = query()
            seen["during"] |= set(pids)
            seen["most"] = max(seen["most"], len(pids))
            seen["polls"] += 1

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        done.set()
        thread.join()


def run_action(action: str, device: str, world, out_dir: str) -> dict:
    """Run `action` (KIR or ASM) of the port's CLI on `world` and `device`
    through run_cli.  Every NW job the typer made must have run on
    `device`."""
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", action, *world.cli_args(), "--sampleID", "S1",
            "--outputDirectory", out_dir]
    if action == "ASM":
        argv += ["--graph", world.graph]
    res = run_cli(argv, device, f"--action {action}")
    jobs, = all_jobs_on(device, res["log"], 1, f"--action {action}")
    return {"dir": out_dir, "launches": res["launches"],
            "wall_s": res["wall_s"], "nw_jobs": jobs}


def kir_outputs(res: dict) -> tuple[list[str], float, dict]:
    """(called pair, posterior, gene -> read names) of a KIR run."""
    row = read_table(os.path.join(res["dir"], "KIR_haplotypes.txt"))[1]
    r2g = {g: ids.split(",") if ids else [] for g, _, ids in
           read_table(os.path.join(res["dir"], "reads2Genes.txt"))[1:]}
    return row[:2], float(row[2]), r2g


def check_kir(res: dict, world) -> None:
    """The planted pair called with posterior > POSTERIOR_MIN; reads2Genes
    right for at least R2G_MIN of the assigned reads whose source span
    overlaps a gene (the bar of the KIRsimulation self-test); no read from
    outside the covered region."""
    pair, posterior, r2g = kir_outputs(res)
    if sorted(pair) != sorted(world.truth):
        fail(f"KIR: called {pair}, planted {world.truth}")
    if not POSTERIOR_MIN < posterior <= 1.0:
        fail(f"KIR: posterior {posterior} outside ({POSTERIOR_MIN}, 1]")
    truth = world.true_genes()
    n_ok = n_tot = 0
    for gene, names in r2g.items():
        if any(n.startswith("far") for n in names):
            fail(f"KIR: a read from outside the covered region in {gene}")
        known = [n for n in names if n in truth]
        n_tot += len(known)
        n_ok += sum(gene in truth[n] for n in known)
    if n_tot < world.n_pairs or n_ok < R2G_MIN * n_tot:
        fail(f"KIR: reads2Genes right for {n_ok}/{n_tot} reads")
    print(f"KIR: called {pair} (planted), posterior {posterior:.6f}; "
          f"reads2Genes right for {n_ok}/{n_tot} reads over "
          f"{len(r2g)} genes")


def asm_outputs(res: dict) -> tuple[list, list]:
    return (read_table(os.path.join(res["dir"], "summary.txt")),
            read_table(os.path.join(res["dir"], "genePositions.tab")))


def check_asm(res: dict, world) -> None:
    """Each contig's call of each locus holds its planted allele at edit
    distance 0, also against the truth table; genePositions.tab has both
    exons of every call on the contig's strand, located on a package
    haplotype."""
    summary, positions = asm_outputs(res)
    rows = {(r[0], r[1]): r for r in summary[1:]}
    for contig, planted in world.truth.items():
        for locus, allele in planted.items():
            r = rows.get((contig, locus))
            if r is None:
                fail(f"ASM: no call of {locus} on {contig}")
            if allele not in r[2].split(";") or r[4] != "0":
                fail(f"ASM: {contig} {locus}: called {r[2][:60]} at edit "
                     f"distance {r[4]}, planted {allele}")
            if r[5] != "0" or allele not in r[7].split(";"):
                fail(f"ASM: {contig} {locus}: truth columns {r[5:9]}")
            exons = [p for p in positions[1:]
                     if p[0] == locus and p[2] == contig]
            if len(exons) != 2 or any(
                    p[5] != world.strands[contig] or not p[6]
                    or int(p[7]) < 0 for p in exons):
                fail(f"ASM: {contig} {locus}: exon rows {exons}")
    if len(rows) != sum(len(p) for p in world.truth.values()):
        fail(f"ASM: {len(rows)} calls, expected one per contig and locus")
    print("ASM: " + "; ".join(
        f"{c} {lc} {r[2].split(';')[0]}{'+' if ';' in r[2] else ''} ED={r[4]}"
        f" ({world.strands[c]})" for (c, lc), r in sorted(rows.items())))


def compare_kir_asm_devices(kir, asm) -> None:
    """Small KIR and ASM worlds: the port's CLI on cuda against the CPU."""
    runs = {(a, dev): run_action(a, dev, w, os.path.join(
                WORLD_DIR, "runs", f"small_{a}_{dev}"))
            for a, w in (("KIR", kir), ("ASM", asm))
            for dev in ("cuda", "cpu")}
    got, want = (kir_outputs(runs["KIR", dev]) for dev in ("cuda", "cpu"))
    if got[0] != want[0] or got[2] != want[2]:
        fail(f"small KIR world: cuda called {got[0]}, the CPU {want[0]}, "
             f"reads2Genes {'equal' if got[2] == want[2] else 'differ'}")
    if abs(got[1] - want[1]) > Q_TOL:
        fail(f"small KIR world: posterior {got[1]} vs {want[1]}")
    check_kir(runs["KIR", "cuda"], kir)
    if asm_outputs(runs["ASM", "cuda"]) != asm_outputs(runs["ASM", "cpu"]):
        fail("small ASM world: summary.txt or genePositions.tab differ")
    check_asm(runs["ASM", "cuda"], asm)
    print("small KIR and ASM worlds: cuda and CPU runs agree (calls, "
          f"reads2Genes, summary.txt, genePositions.tab identical; "
          f"|d posterior| {abs(got[1] - want[1]):.3g}); "
          + ", ".join(f"{a} {dev} {r['wall_s']:.3f} s"
                      for (a, dev), r in runs.items()))


def check_launched(res: dict, names) -> None:
    for name in names:
        if res["launches"][name] <= 0:
            fail(f"the main path never launched {name}")


def check_truth(res: dict, world, c_min: int, exact: bool = False) -> None:
    """stress_imgt.py's checks: each planted allele is in a called cluster
    of its locus, Q1 > 0.9, at least `c_min` clusters, and the pair dump
    holds all C(C+1)/2 pairs.  With `exact`, the first allele of each
    called cluster must be a planted one, as tests/test_long_reads.py
    holds its long-read calls."""
    rows = res["bestguess"][1:]
    for locus, planted in world.truth.items():
        mine = [r for r in rows if r[0] == locus]
        if len(mine) != 2:
            fail(f"locus {locus}: {len(mine)} bestguess rows")
        called = [r[2].split(";") for r in mine]
        for allele in planted:
            if not any(allele in c for c in called):
                fail(f"locus {locus}: planted {allele} not called "
                     f"({[r[2][:40] for r in mine]})")
        if exact and sorted(c[0] for c in called) != sorted(planted):
            fail(f"locus {locus}: called {[c[0] for c in called]}, "
                 f"planted {planted}")
        q1 = [float(r[3]) for r in mine]
        if not all(math.isfinite(q) and Q1_MIN < q <= 1.0 for q in q1):
            fail(f"locus {locus}: Q1 {q1} outside ({Q1_MIN}, 1]")
        C, _ = res["loci"][locus]
        if C < c_min:
            fail(f"locus {locus}: {C} clusters < {c_min}")
        dump = os.path.join(res["dir"], "hla", f"R1_PP_{locus}_pairs.txt")
        with open(dump) as fh:
            n_lines = sum(1 for _ in fh)
        if n_lines != C * (C + 1) // 2 + 1:
            fail(f"locus {locus}: pair dump has {n_lines} lines for C={C}")


def report_run(tag: str, res: dict) -> None:
    print(f"{tag}: align {res['align_s']:.3f} s ({res['reads_per_s']:.1f} "
          f"reads/s, {res['pairs']} pairs + {res['unpaired']} unpaired, "
          f"{res['nw_jobs']} NW jobs), type {res['type_s']:.3f} s, whole "
          f"CLI {res['wall_s']:.3f} s; launches {res['launches']}")
    for lc, (c, r) in res["loci"].items():
        print(f"  locus {lc}: C={c} clusters x R={r} reads")


def compare_devices(world, tag: str, exact: bool = False,
                    truth: bool = True) -> dict:
    """The port's CLI on cuda against the port's CLI on the CPU; the cuda
    run's calls are held to the planted alleles as check_truth does
    (unless `truth` is off).  Returns the two runs by device."""
    runs = {dev: run_port(dev, world, os.path.join(
                WORLD_DIR, "runs", f"{tag.replace(' ', '_')}_{dev}"))
            for dev in ("cuda", "cpu")}
    q_err = check_same_run(runs["cuda"], runs["cpu"])
    if truth:
        check_truth(runs["cuda"], world, 0, exact)
    print(f"{tag}: cuda and CPU runs agree (coverage track and calls "
          f"identical, max |dQ| {q_err:.3g}); cuda {runs['cuda']['wall_s']:.3f}"
          f" s, CPU {runs['cpu']['wall_s']:.3f} s")
    return runs


def check_same_run(got: dict, want: dict) -> float:
    """Identical coverage tracks and bestguess tables, except Q1/Q2 (full
    float repr) within Q_TOL; returns the largest Q difference."""
    track = [read_table(os.path.join(r["dir"], "reads_per_level.txt"))
             for r in (got, want)]
    if track[0] != track[1]:
        fail("coverage tracks (reads_per_level.txt) differ")
    return same_calls(got["bestguess"], want["bestguess"], "bestguess")


def kernel_records() -> dict:
    """One record per kernel and main path, to be filled by the phases."""
    short, long_ = "short reads, phase (e)", "long reads, phase (h)"
    kir, asm = "linear-ALT typing, phase (k)", "assembly typing, phase (l)"
    nw = {"name": "banded_nw", "path": short, "route": "cuda",
          "source": "hla_la_tpu_torch/csrc/banded_nw.cu",
          "replaces": "hla_la_tpu/ops/pallas_nw.py:264"}
    nw_long = {"name": "banded_nw_long", "path": long_, "route": "cuda",
               "source": "hla_la_tpu_torch/csrc/banded_nw_long.cu",
               "replaces": "hla_la_tpu/ops/pallas_nw.py:550"}
    pair = {"name": "pair_ll_diff", "path": short, "route": "cuda",
            "source": "hla_la_tpu_torch/csrc/pair_ll.cu",
            "replaces": "hla_la_tpu/ops/pallas_pair.py:85"}     # and :138
    entry = "the graft entry's typing step, phase (u)"
    bench = "bench.py's 3M-level world in 8 workers, phase (w)"
    wgs = "stress_wgs.py's 17-locus world, typing fan-out, phase (x)"
    split = "stress_long.py's split long reads in 4 workers, phase (y)"
    imgt4 = "stress_imgt.py --loci4, 4 IMGT-scale loci, phase (z)"
    imgt_long = "stress_imgt.py --long, long reads at C = 2,200, phase (aa)"
    ranks8 = "stress_imgt.py --sharded, the reduction on 8 ranks, phase (ab)"
    e2e = "tpu_e2e.py's twin, phase (ac)"
    scaling = "bench_scaling.py's twin, full_step on 4 ranks, phase (ad)"
    soak = "soak.py's twin, 13 randomized CLI trials, phase (ae)"
    kir_ranks = "linear-ALT typing on 2 ranks (--action KIR --sharded 2), " \
        "phase (af)"
    cohort = "a cohort of two samples (--action validate), phase (r)"
    remap = "--action remapAndReduce, phase (s)"
    workers = "short reads in 4 worker processes, phase (p)"
    typing_workers = "typing workers, small world, phase (p)"
    ranks = "short reads on 4 ranks (--sharded 4), phase (q)"
    ranks_pool = "short reads on 2 ranks, rank 0's pool of 4 workers " \
        "(--sharded 2 --maxThreads 4), phase (ah)"
    ranks_fan_out = "typing fan-out in rank 0 of 2, small world, phase (ah)"
    ranks_long_pool = "long reads on 2 ranks, rank 0's pool of 4 workers, " \
        "small long-read world, phase (ah)"
    served_align = "parent, for the host-only align workers"
    served_typing = "parent, for the host-only typing workers"
    return {"nw": nw, "pair": pair, "nw_long": nw_long,
            "pair_long": {**pair, "path": long_},
            "nw_kir": {**nw, "path": kir}, "pair_kir": {**pair, "path": kir},
            "nw_asm": {**nw_long, "path": asm},
            "nw_workers": {**nw, "path": workers},
            "pair_workers": {**pair, "path": typing_workers},
            "nw_sharded": {**nw, "path": ranks},
            "pair_sharded": {**pair, "path": ranks},
            "nw_cohort": {**nw, "path": cohort},
            "pair_cohort": {**pair, "path": cohort},
            "nw_remap": {**nw, "path": remap},
            "nw_entry": {**nw, "path": entry},
            "pair_entry": {**pair, "path": entry},
            "nw_bench": {**nw, "path": bench},
            "pair_bench": {**pair, "path": bench},
            "nw_wgs": {**nw, "path": wgs},
            "pair_wgs": {**pair, "path": wgs},
            "nw_split": {**nw_long, "path": split},
            "pair_split": {**pair, "path": split},
            "nw_imgt4": {**nw, "path": imgt4, "ran_in": served_align},
            "pair_imgt4": {**pair, "path": imgt4, "ran_in": served_typing},
            "nw_imgt_long": {**nw_long, "path": imgt_long,
                             "ran_in": served_align},
            "pair_imgt_long": {**pair, "path": imgt_long, "ran_in": "parent"},
            "pair_ranks8": {**pair, "path": ranks8, "ran_in": "8 ranks"},
            "nw_e2e": {**nw, "path": e2e, "ran_in": "parent"},
            "pair_e2e": {**pair, "path": e2e, "ran_in": "parent"},
            "nw_scaling": {**nw, "path": scaling, "ran_in": "4 ranks"},
            "pair_scaling": {**pair, "path": scaling, "ran_in": "4 ranks"},
            "nw_soak": {**nw, "path": soak, "ran_in": "parent"},
            "nw_long_soak": {**nw_long, "path": soak, "ran_in": "parent"},
            "pair_soak": {**pair, "path": soak, "ran_in": "parent"},
            "nw_kir_ranks": {**nw, "path": kir_ranks, "ran_in": "2 ranks"},
            "pair_kir_ranks": {**pair, "path": kir_ranks,
                               "ran_in": "2 ranks"},
            "nw_ranks_pool": {**nw, "path": ranks_pool,
                              "ran_in": "rank 0, for the host-only align "
                                        "workers"},
            "pair_ranks_fan_out": {**pair, "path": ranks_fan_out,
                                   "ran_in": "rank 0, for the host-only "
                                             "typing workers"},
            "nw_long_ranks_pool": {**nw_long, "path": ranks_long_pool,
                                   "ran_in": "rank 0, for the host-only "
                                             "align workers"}}


def hla_phases(nw: dict, pair: dict, nw_long: dict, pair_long: dict) -> dict:
    """Phases (c)-(i) and (t): the kernels at --action HLA's shapes, its
    two main paths, and every action new to the port on a small world.  Returns the one-process cuda runs that later phases hold
    their many-process runs against: {"imgt": (world, run), "small": ...}."""
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.sim import (LONG_READ_LENGTH, long_read_world,
                                      typing_world)

    # (g) runs before (e): its plain versions' row loops take a minute of
    # the time the IMGT-scale world needs to be built
    phase("(c) K1 banded NW vs plain, through the GPU probe")
    from hla_la_tpu_torch import gpu_check
    probe = {}
    if gpu_check.run(stats=probe) != 0:
        fail(f"the GPU probe: {probe['why']}")
    for shape in NW_SHAPES:
        check_nw(*shape, nw if shape == NW_SHAPES[0] else None)
    sync()

    phase("(d) K3 pair reduction vs plain")
    check_pair(PAIR_C, PAIR_R, pair)
    sync()

    phase("(g) K2 long-read banded NW vs plain")
    path_shape = (jobs_per_call(LONG_READ_LENGTH, LONG_W),
                  LONG_READ_LENGTH, LONG_W)
    for B, L, W in NW_LONG_SHAPES:
        check_nw_long(B, L, W, None)
    check_nw_long(*path_shape, nw_long)     # the shape (h) launches
    sync()

    # (f), (i) and (t) need small worlds only: they run while the
    # IMGT-scale world is still being built, and while K2 is held at the
    # shape of (y) in a process of its own
    start_split_check()
    phase("(f) small world: the port's CLI on cuda vs on the CPU")
    small = typing_world(WORLD_DIR, **SMALL_WORLD)
    one_process = {"small": (small, compare_devices(small, "small")["cuda"])}
    sync()

    phase("(i) small long-read world: the port's CLI on cuda vs on the CPU")
    small_long = long_read_world(WORLD_DIR, **SMALL_LONG_WORLD)
    one_process["small_long"] = (small_long, compare_devices(
        small_long, "small long-read", exact=True)["cuda"])
    sync()

    phase("(t) every action new to the port, small world: cuda vs the CPU")
    small_actions(small)
    sync()

    phase("(e) end to end: the port's CLI on cuda, IMGT-scale world")
    world = built_world("typing_world")
    start_bam_build()
    start_imgt_builds()
    print(f"world: {world.graph}; planted {world.truth}")
    res = run_port("cuda", world, os.path.join(WORLD_DIR, "runs", "cuda"))
    check_launched(res, ("K1", "K3"))
    check_truth(res, world, C_MIN)
    print(f"calls hold the planted alleles: "
          f"{[r[:4] for r in res['bestguess'][1:]]}")
    report_run("port on cuda", res)
    nw["launches"] = res["launches"]["K1"]
    pair["launches"] = res["launches"]["K3"]
    one_process["imgt"] = (world, res)
    sync()

    phase("(h) end to end on long reads: the port's CLI on cuda")
    world = built_world("long_read_world")
    print(f"world: {world.graph}; planted {world.truth}")
    res = run_port("cuda", world, os.path.join(WORLD_DIR, "runs",
                                               "long_cuda"))
    check_launched(res, ("K2", "K3"))
    check_truth(res, world, 0, exact=True)
    print(f"calls are exactly the planted alleles: "
          f"{[r[:4] for r in res['bestguess'][1:]]}")
    report_run("port on cuda, long reads", res)
    nw_long["launches"] = res["launches"]["K2"]
    pair_long["launches"] = res["launches"]["K3"]
    for C, R in sorted(res["loci"].values(), key=lambda cr: cr[1]):
        check_pair(C, R, pair_long)     # the record keeps the largest R
    sync()
    return one_process


def kir_asm_phases(nw_kir: dict, pair_kir: dict, nw_asm: dict) -> dict:
    """Phases (j)-(m): the kernels at the shapes of --action KIR and
    --action ASM, and those two main paths.  Returns (k)'s world, run and
    the linear-ALT typer's trace of it, which (af) holds its ranks to."""
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.models.asm import AssemblyTyper
    from hla_la_tpu_torch.models.kir_package import KirPackage
    from hla_la_tpu_torch.models.linear_alts import LinearALTsTyper
    from hla_la_tpu_torch.sim import asm_world, kir_world

    phase("(j) K1, K2, K3 at the linear-ALT and assembly typers' shapes")
    kir_B = jobs_per_call(KIR_L, KIR_W)
    check_nw(kir_B, KIR_L, KIR_W, nw_kir, make_world=kir_nw_world)
    world_asm = asm_world(WORLD_DIR)
    exons = [alleles for per_exon in AssemblyTyper(
                 GraphPackage(world_asm.graph), device="cuda"
             ).allele_db.values() for alleles in per_exon.values()]
    asm_B = max(len(a) for a in exons)
    asm_L = max(len(s) for a in exons for s in a.values())
    print(f"assembly world: {len(exons)} exons of up to {asm_B} alleles, "
          f"the longest {asm_L} bases")
    check_nw_long(asm_B, asm_L, ASM_W, nw_asm, unit_scoring=True)
    for C, R in KIR_PAIR_SHAPES:
        check_pair(C, R, {})
    sync()

    phase("(k) --action KIR on cuda: 32 haplotypes of 150 kb, reads at 15x")
    world_kir = built_world("kir_world")
    print(f"world: {world_kir.panel}; {world_kir.n_pairs} pairs from "
          f"{world_kir.truth}")
    LinearALTsTyper.trace = []
    try:
        res = run_action("KIR", "cuda", world_kir,
                         os.path.join(WORLD_DIR, "runs", "kir_cuda"))
    finally:
        trace, LinearALTsTyper.trace = LinearALTsTyper.trace, None
    kir_one = {"world": world_kir, "run": res, "trace": trace}
    check_launched(res, ("K1", "K3"))
    check_kir(res, world_kir)
    # calls of jobs_per_call jobs, not one per read: two passes over the
    # reads (the pair model, reads2Genes), each ending in a partial call
    if res["launches"]["K1"] > res["nw_jobs"] / kir_B + 2:
        fail(f"KIR: {res['launches']['K1']} K1 launches for "
             f"{res['nw_jobs']} NW jobs of {kir_B} per call")
    print(f"port on cuda, --action KIR: whole CLI {res['wall_s']:.3f} s, "
          f"{res['nw_jobs']} NW jobs on the card ({kir_B} per call); "
          f"launches {res['launches']}")
    nw_kir["launches"] = res["launches"]["K1"]
    pair_kir["launches"] = res["launches"]["K3"]
    check_pair(len(KirPackage.load(world_kir.panel).haplotypes),
               world_kir.n_pairs, pair_kir)     # the run's C x R
    sync()

    phase("(l) --action ASM on cuda: two contigs, 2,200 alleles per locus")
    res = run_action("ASM", "cuda", world_asm,
                     os.path.join(WORLD_DIR, "runs", "asm_cuda"))
    check_launched(res, ("K2",))
    check_asm(res, world_asm)
    print(f"port on cuda, --action ASM: whole CLI {res['wall_s']:.3f} s, "
          f"{res['nw_jobs']} NW jobs on the card; launches "
          f"{res['launches']}")
    nw_asm["launches"] = res["launches"]["K2"]
    sync()

    phase("(m) small KIR and ASM worlds: the port's CLI on cuda vs the CPU")
    compare_kir_asm_devices(kir_world(WORLD_DIR, **SMALL_KIR_WORLD),
                            asm_world(WORLD_DIR, **SMALL_WORLD))
    sync()
    return kir_one


def pinned_bytes() -> tuple[int, int]:
    """(bytes of page-locked host memory the process holds, page-locked
    blocks it has allocated so far) by PyTorch's host allocator, where all
    of the port's pinned buffers come from (``NWRunner.host_buffer``)."""
    import torch
    st = torch.cuda.host_memory_stats()
    if not {"allocated_bytes.current", "num_host_alloc"} <= set(st):
        fail(f"host_memory_stats lacks the pinned-memory counts: {sorted(st)}")
    return st["allocated_bytes.current"], st["num_host_alloc"]


@contextlib.contextmanager
def per_sample_probe(samples: list):
    """While in the context, every run_hla_typing call appends to `samples`
    its wall, the K1 and K3 launches it made and the page-locked bytes
    after it (``validate_cohort`` looks the function up in
    ``models.pipeline`` at each call)."""
    from hla_la_tpu_torch.models import pipeline
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    inner = pipeline.run_hla_typing

    def probed(*args, **kwargs):
        k1, k3 = banded_nw_cuda.launches, pair_ll_diff_cuda.launches
        t0 = time.perf_counter()
        res = inner(*args, **kwargs)
        sync()
        samples.append({"wall_s": time.perf_counter() - t0,
                        "K1": banded_nw_cuda.launches - k1,
                        "K3": pair_ll_diff_cuda.launches - k3,
                        "pinned": pinned_bytes()})
        return res
    pipeline.run_hla_typing = probed
    try:
        yield
    finally:
        pipeline.run_hla_typing = inner


def validate_in_own_process(argv: list) -> tuple[dict, list]:
    """(r)'s --action validate on cuda, probed per sample, in a process of
    its own: the page-locked pool it reads is then the cohort's alone, not
    also the blocks that the phases before it left in PyTorch's host cache
    (with them, S2 took one more 128 KiB block than S1 in two of five
    calls).  Returns (run_cli's result, the per-sample records)."""
    path = os.path.join(WORLD_DIR, "runs", "cohort_probe.json")
    code = ("import json, sys\n"
            "import chip_smoke as c\n"
            "samples = []\n"
            "with c.per_sample_probe(samples):\n"
            "    res = c.run_cli(json.loads(sys.argv[1]), 'cuda', "
            "'--action validate')\n"
            "with open(sys.argv[2], 'w') as fh:\n"
            "    json.dump({'res': res, 'samples': samples}, fh)\n")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(argv),
                           path], cwd=ROOT)
    if proc.returncode != 0:
        fail(f"--action validate in its own process: exit code "
             f"{proc.returncode}")
    with open(path) as fh:
        got = json.load(fh)
    return got["res"], [{**s_, "pinned": tuple(s_["pinned"])}
                        for s_ in got["samples"]]


def run_cli(argv: list, device: str, tag: str) -> dict:
    """The port's CLI on `argv` + ``--device device``; the kernels' launch
    counters are zeroed just before the run and read just after it.
    Returns its wall, launches, printed lines and log."""
    from hla_la_tpu_torch.bench_common import Tee
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    kernels = {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
               "K3": pair_ll_diff_cuda}
    log, out = io.StringIO(), io.StringIO()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with captured_stderr(log), \
            contextlib.redirect_stdout(Tee(sys.stdout, out)):
        rc = port_main([*argv, "--device", device])
    if device == "cuda":
        sync()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{tag} on {device}: exit code {rc}")
    return {"wall_s": wall, "launches": {k: fn.launches
                                         for k, fn in kernels.items()},
            "lines": out.getvalue().splitlines(), "log": log.getvalue()}


def all_jobs_on(device: str, log: str, n_runs: int, tag: str) -> list[int]:
    """The NW jobs of each of the `n_runs` aligner runs logged in `log`;
    fails unless each ran all of them on `device`."""
    jobs = [int(n) for n in re.findall(r"n_chain_extensions: (\d+)", log)]
    on = [int(n) for n in re.findall(rf"nw_jobs_on_{device}: (\d+)", log)]
    if len(jobs) != n_runs or jobs != on or not all(jobs):
        fail(f"{tag}: NW jobs {jobs}, on {device} {on}")
    return jobs


def same_calls(got_rows: list, want_rows: list, tag: str) -> float:
    """Two bestguess tables: every column equal but Q1/Q2, within Q_TOL;
    returns the largest Q difference."""
    if len(got_rows) != len(want_rows) or got_rows[0] != want_rows[0]:
        fail(f"{tag}: bestguess tables differ in shape")
    q_err = 0.0
    for a, b in zip(got_rows[1:], want_rows[1:]):
        for i, (x, y) in enumerate(zip(a, b)):
            if i in (3, 4):
                q_err = max(q_err, abs(float(x) - float(y)))
            elif x != y:
                fail(f"{tag}: column {got_rows[0][i]}: {x} vs {y}")
    if q_err > Q_TOL:
        fail(f"{tag}: Q1/Q2 differ by {q_err:.3g} > {Q_TOL}")
    return q_err


def check_remapped(path: str, n_levels: int, n_records: int, tag: str):
    """remapAndReduce's BAM: `n_records` records on the one PRG contig,
    coordinate-sorted, every position inside the PRG's levels."""
    from hla_la_tpu_torch.io.bam import BamReader
    rd = BamReader(path)
    recs = list(rd)
    if rd.references != [("PRG", n_levels)]:
        fail(f"{tag}: contigs {rd.references}, want PRG of {n_levels}")
    pos = [r.pos for r in recs]
    if len(recs) != n_records or pos != sorted(pos) or not all(
            0 <= p < n_levels for p in pos):
        fail(f"{tag}: {len(recs)} records (want {n_records}), sorted "
             f"{pos == sorted(pos)}, positions {min(pos)}-{max(pos)} of "
             f"{n_levels} levels")
    return recs


def cohort_phases(one_process: dict, rec: dict) -> None:
    """Phases (r) and (s): --action validate on a cohort of two IMGT-scale
    samples and --action remapAndReduce on the first one's BAM."""
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.sim import cohort_world

    _, one = one_process["imgt"]
    runs = os.path.join(WORLD_DIR, "runs")
    phase("(r) --action validate on cuda: a cohort of two IMGT-scale samples")
    t0 = time.perf_counter()
    wait_build("world_bam")
    built_world("second_sample")
    cohort = cohort_world(WORLD_DIR)
    print(f"cohort world ready after a further {time.perf_counter() - t0:.1f}"
          f" s")
    print(f"cohort: {[(s_.sample_id, s_.bam) for s_ in cohort.samples]}; "
          f"the truth table names {cohort.wrong[2]} in place of a planted "
          f"{cohort.wrong[1]} allele of {cohort.wrong[0]}")
    out_dir = os.path.join(runs, "cohort")
    shutil.rmtree(out_dir, ignore_errors=True)
    res, samples = validate_in_own_process(
        ["--action", "validate", *cohort.cli_args(), "--outputDirectory",
         out_dir])
    want = "cohort accuracy: 87.50% over 2 samples (1 discordant calls)"
    if res["lines"] != [want]:
        fail(f"--action validate printed {res['lines']}, want [{want!r}]")
    jobs = all_jobs_on("cuda", res["log"], 2, "--action validate")
    align = [float(x) for x in re.findall(
        r"aligned \d+/\d+ pairs \+ \d+/\d+ unpaired in ([0-9.]+) s",
        res["log"])]
    typed = [float(x) for x in re.findall(r"typed \d+ loci in ([0-9.]+) s",
                                          res["log"])]
    sample, locus, _ = cohort.wrong
    pileups = [f for f in os.listdir(out_dir)
               if f.startswith("pileup_analysis_")]
    if pileups != [f"pileup_analysis_{sample}_{locus}.txt"]:
        fail(f"pileup analyses {pileups}")
    n_cols = len(read_table(os.path.join(out_dir, pileups[0]))) - 2
    if n_cols < 1:
        fail(f"{pileups[0]} lists no column")
    q_err = same_calls(read_table(os.path.join(
        out_dir, "S1", "hla", "R1_bestguess.txt")), one["bestguess"],
        "S1 of the cohort against (e)")
    if len(samples) != 2 or len(align) != 2 or len(typed) != 2:
        fail(f"{len(samples)} samples typed, {align}, {typed}")
    if (samples[0]["K1"], samples[0]["K3"]) != (one["launches"]["K1"],
                                                one["launches"]["K3"]) \
            or samples[1]["K1"] <= 0 or samples[1]["K3"] <= 0:
        fail(f"launches per sample {samples}, (e) {one['launches']}")
    if samples[1]["pinned"] != samples[0]["pinned"]:
        fail(f"page-locked memory grew from S1 to S2: {samples}")
    for s_, n, a, t in zip(samples, jobs, align, typed):
        print(f"  sample: wall {s_['wall_s']:.3f} s (align {a:.3f} s, type "
              f"{t:.3f} s), {n} NW jobs all on the card, K1 {s_['K1']} and "
              f"K3 {s_['K3']} launches; after it {s_['pinned'][0]} "
              f"page-locked bytes in {s_['pinned'][1]} allocations so far")
    print(f"--action validate: {want}; {pileups[0]} lists {n_cols} "
          f"column(s); S1's calls are (e)'s (max |dQ| {q_err:.3g}); whole "
          f"CLI {res['wall_s']:.3f} s; launches {res['launches']}")
    rec["nw_cohort"].update({k: v for k, v in rec["nw"].items()
                             if k not in ("path", "launches")},
                            launches=res["launches"]["K1"])
    rec["pair_cohort"].update({k: v for k, v in rec["pair"].items()
                               if k not in ("path", "launches")},
                              launches=res["launches"]["K3"])
    sync()

    phase("(s) --action remapAndReduce on cuda: S1's BAM")
    out = os.path.join(runs, "remapped.bam")
    res = run_cli(["--action", "remapAndReduce", "--BAM",
                   cohort.samples[0].bam, "--graph", cohort.graph, "--out",
                   out], "cuda", "--action remapAndReduce")
    m = re.fullmatch(r"remapAndReduce: (\d+) pairs \+ (\d+) unpaired reads "
                     r"remapped to PRG coordinates -> (.*)",
                     res["lines"][-1] if res["lines"] else "")
    if not m or m.group(3) != out:
        fail(f"--action remapAndReduce printed {res['lines']}")
    n_pairs, n_un = int(m.group(1)), int(m.group(2))
    jobs = all_jobs_on("cuda", res["log"], 1, "--action remapAndReduce")
    n_levels = GraphPackage(cohort.graph).prg().n_levels
    check_remapped(out, n_levels, 2 * n_pairs + n_un,
                   "--action remapAndReduce")
    if res["launches"]["K1"] <= 0 or n_pairs < 0.9 * one["pairs"]:
        fail(f"remapAndReduce: {n_pairs} of {one['pairs']} pairs, "
             f"launches {res['launches']}")
    print(f"--action remapAndReduce: {n_pairs} pairs + {n_un} unpaired "
          f"reads written of {one['pairs']} pairs, coordinate-sorted on PRG "
          f"({n_levels} levels); {jobs[0]} NW jobs all on the card; K1 "
          f"{res['launches']['K1']} launches; whole CLI {res['wall_s']:.3f} s")
    rec["nw_remap"].update({k: v for k, v in rec["nw"].items()
                            if k not in ("path", "launches")},
                           launches=res["launches"]["K1"])
    sync()


# the actions that align or type, and what each must print last on cuda
ALIGNING_SELF_TESTS = ("testPRGMapping", "testPRGMappingUnpaired",
                       "TestHLATyping", "testAlignments2Chains",
                       "testChainExtension")
RATE = re.compile(r", [0-9.]+ reads/s")


def small_actions(small) -> None:
    """Each action the port gained with validate and remapAndReduce, on
    (f)'s small world and its cohort, through the CLI on cuda and on the
    CPU: the same printed lines (but testPRGMapping's rate) and the same
    files (BAMs as decoded records, pair dumps and bestguess tables with
    Q within Q_TOL, the rest byte for byte)."""
    from hla_la_tpu_torch.io.fastq import read_fastq
    from hla_la_tpu_torch.sim import cohort_world

    cohort = cohort_world(WORLD_DIR, **SMALL_WORLD)
    root = os.path.join(WORLD_DIR, "runs", "actions")
    shutil.rmtree(root, ignore_errors=True)
    inputs = os.path.join(root, "inputs")
    os.makedirs(inputs)
    seqs = [r.seq for r, _ in zip(read_fastq(small.fastq1), range(400))]
    with open(os.path.join(inputs, "genome.fa"), "w") as fh:
        fh.write(">g1\n" + "".join(seqs[:30]) + "\n")
    with open(os.path.join(inputs, "query.fa"), "w") as fh:
        fh.write(">q\n" + "".join(seqs[:30])[500:2500] + "\n")
    with open(os.path.join(inputs, "panel.fa"), "w") as fh:
        fh.write(f">hit\n{''.join(seqs[:30])}\n>miss\n{'ACGT' * 30}\n")
    with open(os.path.join(inputs, "panel.mfa"), "w") as fh:
        fh.write(">h1\nACGTAACGTACGTACGTACGTACGT\n"
                 ">h2\nACGTTACGTACG-ACGTACGTACGT\n"
                 ">h3\nACGTAACGTACGGACG-ACGTACGT\n")
    s1_bam = cohort.samples[0].bam
    actions = {
        "testBinary": [],
        "prepareGraph": ["--graph", "{wd}/g"],
        "simulate": ["--workingDir", "{wd}", "--seed", "3"],
        "oneSimulationFromPRG": ["--workingDir", "{wd}", "--seed", "4"],
        "simulateFromNormalGenome": ["--ASMfasta", inputs + "/genome.fa",
                                     "--workingDir", "{wd}"],
        "checkSequencePresence": ["--graph", small.graph],
        "globalAlignment": ["--ASMfasta", inputs + "/query.fa", "--ref",
                            inputs + "/genome.fa", "--workingDir", "{wd}"],
        **{a: ["--workingDir", "{wd}"] for a in ALIGNING_SELF_TESTS},
        "validate": [*cohort.cli_args(), "--workingDir", "{wd}"],
        "extractkMerCounts": ["--graph", small.graph, *small.cli_args(),
                              "--outputDirectory", "{wd}"],
        "graphFromMFA": ["--ASMfasta", inputs + "/panel.mfa", "--graph",
                         "{wd}/g"],
        "downsampleBAM": ["--BAM", s1_bam, "--out", "{wd}/ds.bam",
                          "--fraction", "0.3", "--seed", "2"],
        # on the downsampled BAM: the action is host work and scans reads
        "findKIRinBAM": ["--BAM", os.path.join(root, "downsampleBAM", "cpu",
                                               "ds.bam"),
                         "--ALTpanel", inputs + "/panel.fa"],
        "remapAndReduce": ["--BAM", s1_bam, "--graph", small.graph,
                           "--out", "{wd}/prg.bam"],
    }
    walls = []
    for action, args in actions.items():
        got = {}
        for dev in ("cuda", "cpu"):
            wd = os.path.join(root, action, dev)
            os.makedirs(wd)
            if action == "prepareGraph":
                shutil.copytree(small.graph, wd + "/g")
            got[dev] = run_cli(["--action", action,
                                *[a.format(wd=wd) for a in args]], dev,
                               f"--action {action}")
            got[dev]["lines"] = [RATE.sub("", ln).replace(wd, "WD")
                                 for ln in got[dev]["lines"]]
        if got["cuda"]["lines"] != got["cpu"]["lines"]:
            fail(f"--action {action}: cuda printed {got['cuda']['lines']}, "
                 f"the CPU {got['cpu']['lines']}")
        n = same_outputs(os.path.join(root, action, "cuda"),
                         os.path.join(root, action, "cpu"), action)
        last = got["cuda"]["lines"][-1] if got["cuda"]["lines"] else ""
        if action in ALIGNING_SELF_TESTS:
            if not (last == "OK" or last.endswith(" — OK")):
                fail(f"--action {action} on cuda ends with {last!r}")
            if got["cuda"]["launches"]["K1"] <= 0:
                fail(f"--action {action}: no K1 launch on cuda")
        walls.append(f"{action} {got['cuda']['wall_s']:.2f}/"
                     f"{got['cpu']['wall_s']:.2f} s "
                     f"(K1 {got['cuda']['launches']['K1']}, "
                     f"K3 {got['cuda']['launches']['K3']}; {n} files)")
    kmers = [run_port(dev, small, os.path.join(root, f"kmers_{dev}"),
                      ("--extractExonkMerCounts", "1"))
             for dev in ("cuda", "cpu")]
    files = [open(os.path.join(r["dir"], "kMerCounts.txt"), "rb").read()
             for r in kmers]
    if files[0] != files[1] or files[0].count(b"\n") < 100:
        fail("--extractExonkMerCounts 1: kMerCounts.txt differs between "
             "cuda and the CPU")
    same_calls(kmers[0]["bestguess"], kmers[1]["bestguess"],
               "--extractExonkMerCounts 1")
    print(f"{len(actions)} actions and --extractExonkMerCounts 1: cuda and "
          f"CPU print the same lines and write the same files; the five "
          f"aligning self-tests print OK on cuda; wall cuda/CPU: "
          + "; ".join(walls))


def same_outputs(got_dir: str, want_dir: str, tag: str) -> int:
    """Fail unless both directories hold the same files: BAMs as decoded
    records, pair dumps by value (P within Q_TOL, LL within the pair
    reduction's tolerances, mismatches equal), bestguess tables by
    same_calls, the rest byte for byte.  Returns their number."""
    from hla_la_tpu_torch.io.bam import BamReader

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)
    names = tree(want_dir)
    if tree(got_dir) != names:
        fail(f"{tag}: files {sorted(set(tree(got_dir)) ^ set(names))} are "
             f"in one run only")
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".bam"):
            same = [vars(r) for r in BamReader(a)] == \
                [vars(r) for r in BamReader(b)]
        elif "_PP_" in name:
            # keyed by cluster pair: pairs of near-equal LL may swap rows
            ta, tb = ({r[0]: r[1:] for r in read_table(f)[1:]}
                      for f in (a, b))
            same = ta.keys() == tb.keys() and all(
                abs(float(x[0]) - float(y[0])) <= Q_TOL
                and math.isclose(float(x[1]), float(y[1]),
                                 rel_tol=PAIR_RTOL, abs_tol=PAIR_ATOL)
                and x[2] == y[2] for x, y in
                ((ta[k], tb[k]) for k in ta))
        elif "R1_bestguess" in name:
            same_calls(read_table(a), read_table(b), f"{tag} {name}")
            same = True
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
        if not same:
            fail(f"{tag}: {name} differs between cuda and the CPU")
    return len(names)


def pair_epilogue_phase(shapes=((2200, 180), (1200, 400)),
                        reps: int = 5) -> list[dict]:
    """(ai): the pair epilogue's card route against its host route."""
    import numpy as np
    import torch
    from hla_la_tpu_torch import native
    from hla_la_tpu_torch.ops import pair_ll as pl
    phase("(ai) the pair epilogue: card route against host route")
    out = []
    for C, R in shapes:
        rng = np.random.default_rng(C * 1000 + R)
        base = rng.integers(0, C // 4, C)
        L = rng.normal(-35, 2, (C // 4, R)).astype(np.float32)[base]
        MM = rng.integers(0, 3, (C // 4, R)).astype(np.float32)[
            rng.integers(0, C // 4, C)]
        mrs = MM.sum(axis=1)
        ids = [f"A*{i:04d};A*{i:04d}N".encode() for i in range(C)]
        routes = {"host": lambda: pl.pair_epilogue(
                      L, mrs, "cuda", reduce=pl.pair_ll_reduction),
                  "card": lambda: pl.pair_epilogue(L, mrs, "cuda")}
        got, wall, card_ms, post_s = {}, {}, {}, {}
        for name, fn in routes.items():
            calls = pl.pair_epilogue.card_calls
            got[name] = fn()                                  # warm-up
            if pl.pair_epilogue.card_calls != calls + (name == "card"):
                fail(f"(ai) the {name} route at C = {C} took the other")
            w, ev = [], []
            for _ in range(reps):
                sync()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                w.append(time.perf_counter() - t0)
                ev.append(e0.elapsed_time(e1))
            wall[name], card_ms[name] = sorted(w)[reps // 2], \
                sorted(ev)[reps // 2]
            t0 = time.perf_counter()
            post = pl.pair_posterior(got[name][4], got[name][2], MM)
            post_s[name] = time.perf_counter() - t0
            got[name] = (*got[name], post, native.format_pairs(
                got[name][0], got[name][1], post.P_o, got[name][2],
                got[name][3], ids))
        h, c = got["host"], got["card"]
        for k, a, b in zip(("a", "b", "LL_o", "MM_o", "pair_vals"), h, c):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                fail(f"(ai) {k} differs between the routes at C = {C}")
        ph, pc = h[5], c[5]
        if (ph.P_o.tobytes(), ph.marg.tobytes(), ph.best1, ph.best2,
                ph.best2_p, float(ph.mm_min_row[ph.best2])) != \
                (pc.P_o.tobytes(), pc.marg.tobytes(), pc.best1, pc.best2,
                 pc.best2_p, float(pc.mm_min_row[pc.best2])):
            fail(f"(ai) the posterior differs between the routes at C = {C}")
        if h[6] is None or h[6] != c[6]:
            fail(f"(ai) the pair dump differs between the routes at C = {C}")
        k3_ms = cuda_ms(lambda: pl.pair_ll_diff_cuda(
            torch.from_numpy(L).cuda()), reps)
        row = {"C": C, "R": R, "pairs": C * (C + 1) // 2,
               "tied_share": float(1 - len(np.unique(h[4])) / len(h[4])),
               "host_route_s": wall["host"], "card_route_s": wall["card"],
               "host_route_events_ms": card_ms["host"],
               "card_route_events_ms": card_ms["card"],
               "k3_with_copy_in_ms": k3_ms,
               "posterior_s": post_s["card"],
               "dump_bytes": len(c[6]),
               "card_calls": pl.pair_epilogue.card_calls}
        print(f"pair epilogue at C = {C}, R = {R} ({row['pairs']} pairs, "
              f"{row['tied_share']:.4f} of the pair values tied): "
              f"bit-identical; host route {wall['host']:.4f} s, card route "
              f"{wall['card']:.4f} s host, {card_ms['card']:.3f} ms between "
              f"its CUDA events (K3 with its copy in {k3_ms:.3f} ms); the "
              f"posterior {post_s['card']:.4f} s", flush=True)
        out.append(row)
    print(json.dumps({"pair_epilogue": out}), flush=True)
    return out


def check_tile_ranges(C: int, R: int) -> None:
    """K3 with a tile range: the ranges that 2 and 4 model ranks take sum to
    the one-call matrix bit for bit, and one range agrees with the plain
    version's same range."""
    import numpy as np
    import torch
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.ops.pair_ll import (LOG_HALF, pair_ll_diff_plain,
                                              pair_tiles)

    Ld = torch.from_numpy(np.random.default_rng(1).normal(
        -40.0, 8.0, (C, R)).astype(np.float32)).cuda()
    whole, _ = pair_ll_diff_cuda(Ld)
    n = pair_tiles(C)
    for ranks in (2, 4):
        total = torch.zeros_like(whole)
        for j in range(ranks):
            lo, hi = n * j // ranks, n * (j + 1) // ranks
            total += pair_ll_diff_cuda(Ld, (lo, hi - lo))[0]
        sync()
        if not torch.equal(total, whole):
            fail(f"K3 C={C} R={R}: the tile ranges of {ranks} ranks do not "
                 f"sum to the one-call matrix (max |d| "
                 f"{(total - whole).abs().max().item():.4g})")
    # one range against the plain version's: the same cells, and on them
    # the full pair log-likelihood (rank-1 term added) within the bar
    last = (n * 3 // 4, n - n * 3 // 4)
    got, rpad = pair_ll_diff_cuda(Ld, last)
    want, rpad_plain = pair_ll_diff_plain(Ld, tile_range=last)
    got = got.cpu().numpy().astype(np.float64)
    want = want.cpu().numpy().astype(np.float64)
    rowsum = Ld.double().sum(dim=1).cpu().numpy()
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    cells = got != 0
    if not np.array_equal(cells, want != 0) or not np.allclose(
            (base + got + LOG_HALF * rpad)[cells],
            (base + want + LOG_HALF * rpad_plain)[cells],
            rtol=PAIR_RTOL, atol=PAIR_ATOL):
        fail(f"K3 C={C} R={R}: tile range {last} differs from plain (max "
             f"abs err {np.abs(got - want).max():.4g} before the padded "
             f"reads' constant)")
    print(f"K3 C={C} R={R}: {n} tiles; the ranges of 2 and of 4 ranks sum to "
          f"the one-call matrix bit for bit; range {last} covers the plain "
          f"version's cells within rtol={PAIR_RTOL} atol={PAIR_ATOL}")


def same_files(got_dir: str, want_dir: str, tag: str) -> int:
    """Fail unless both directories hold the same files (align shards
    aside) with the same bytes; returns their number."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files
                      if "align_shard" not in f)
    names = tree(want_dir)
    if tree(got_dir) != names:
        fail(f"{tag}: files {sorted(set(tree(got_dir)) ^ set(names))} are "
             f"in one run only")
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as a, \
                open(os.path.join(want_dir, name), "rb") as b:
            if a.read() != b.read():
                fail(f"{tag}: {name} differs from the one-process run")
    return len(names)


def flag_phases() -> None:
    """Phases (n) and (o): K3's launch rule and tile ranges; the CLI's
    paralog defence and an ambiguous call, cuda against the CPU."""
    from hla_la_tpu_torch.sim import (ambiguous_q1, ambiguous_world,
                                      decoy_world)

    phase("(n) K3: the read range cut by work per block; tile ranges")
    for C, R in ((32, 22500), (6, 22500)):
        rec = {}
        check_pair(C, R, rec)
        if rec["read_parts"] <= 1 or rec["ms"] >= rec["plain_ms"]:
            fail(f"K3 C={C} R={R}: {rec['read_parts']} part(s), kernel "
                 f"{rec['ms']:.3f} ms vs plain {rec['plain_ms']:.3f} ms")
    check_tile_ranges(PAIR_C, PAIR_R)
    check_tile_ranges(32, 21803)
    sync()

    phase("(o) --decoyFasta and an ambiguous call: cuda vs the CPU")
    decoy = decoy_world(WORLD_DIR)
    runs = {dev: run_port(dev, decoy, os.path.join(WORLD_DIR, "runs",
                                                   f"decoy_{dev}"))
            for dev in ("cuda", "cpu")}
    check_same_run(runs["cuda"], runs["cpu"])
    check_truth(runs["cuda"], decoy, 0)
    dropped = [runs[dev]["decoy_dropped_pairs"] for dev in ("cuda", "cpu")]
    if dropped[0] != dropped[1] or dropped[0] < 0.9 * decoy.n_paralog_pairs:
        fail(f"decoy world: {dropped[0]} pairs dropped on cuda, "
             f"{dropped[1]} on the CPU, of {decoy.n_paralog_pairs} paralog "
             f"pairs")
    print(f"decoy world: {dropped[0]} of {decoy.n_paralog_pairs} paralog "
          f"pairs dropped on cuda as on the CPU; the same calls")
    runs = compare_devices(ambiguous_world(WORLD_DIR), "ambiguous",
                           truth=False)
    try:
        inside = ambiguous_q1(runs["cuda"]["bestguess"])
    except AssertionError as exc:
        fail(f"ambiguous world: {exc}")
    print(f"ambiguous world: Q1 {inside} strictly inside (0.05, 0.95) on "
          f"cuda; rows {[r[:5] for r in runs['cuda']['bestguess'][1:]]}")
    sync()


def run_subprocess_cli(argv: list, tag: str) -> tuple[str, str]:
    """The port's CLI in a process of its own (so that every rank's log and
    printed lines are caught); returns its standard output and error."""
    proc = subprocess.run([sys.executable, "-m", "hla_la_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        fail(f"{tag}: exit code {proc.returncode}")
    return proc.stdout, proc.stderr


def rank_launches(log: str) -> list[dict]:
    """Each rank's kernel launches, from the "rank r: exit code 0" lines
    that the CLI logs once its ranks are done."""
    return [dict((k, int(n)) for k, n in re.findall(r"(K\d) (\d+)", ln))
            for ln in re.findall(r"rank \d+: exit code 0, kernel launches "
                                 r"(.*)", log)]


def check_sharded_cli(world, one: dict, n_ranks: int, tag: str) -> dict:
    """``--sharded n_ranks`` on `world` against the one-process cuda run
    `one`: the same calls and coverage track, Q1/Q2 within Q_TOL; on every
    rank every NW job on a card and K1 and K3 launched.  Returns the
    launches of rank 0."""
    out_dir = os.path.join(WORLD_DIR, "runs", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    _, log = run_subprocess_cli(
        ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
         "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
         "cuda", "--sharded", str(n_ranks)], tag)
    wall = time.perf_counter() - t0
    jobs = [int(n) for n in re.findall(r"n_chain_extensions: (\d+)", log)]
    on_card = [int(n) for n in re.findall(r"nw_jobs_on_cuda: (\d+)", log)]
    if len(jobs) != n_ranks or jobs != on_card or jobs[0] != one["nw_jobs"]:
        fail(f"{tag}: NW jobs per rank {jobs}, on a card {on_card}, "
             f"one process {one['nw_jobs']}")
    launches = rank_launches(log)
    if len(launches) != n_ranks or any(
            r["K1"] <= 0 or r["K3"] <= 0 for r in launches):
        fail(f"{tag}: kernel launches per rank {launches}")
    got = {"dir": out_dir, "bestguess": read_table(
        os.path.join(out_dir, "hla", "R1_bestguess.txt"))}
    q_err = check_same_run(got, one)
    print(f"{tag}: {n_ranks} rank(s) agree with the one-process run (calls "
          f"and coverage track identical, max |dQ| {q_err:.3g}); {jobs[0]} "
          f"NW jobs, all on the card; launches per rank {launches}; whole "
          f"CLI with its process start {wall:.3f} s (one process "
          f"{one['wall_s']:.3f} s)")
    return launches[0]


def worker_phases(one_process: dict, rec: dict) -> dict:
    """Phase (p): worker processes and align shards on the one card,
    against the one-process run of (e).  Returns the --maxThreads 4 run
    ("workers") and the directory of the small world's typing-workers run
    ("typing_workers")."""
    from hla_la_tpu_torch.bench_common import logged
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.pipeline import (pair_up_fastq,
                                                  run_hla_typing)
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.utils.config import RunConfig, TyperConfig

    world, one = one_process["imgt"]
    small, small_one = one_process["small"]
    runs = os.path.join(WORLD_DIR, "runs")

    phase("(p) --maxThreads 4 on cuda, IMGT-scale world; typing workers and "
          "align shards, small world")
    # nvidia-smi's compute apps while the pool is up: the workers are
    # host-only, so none of them may appear there
    with compute_apps_watch() as apps:
        res = run_port("cuda", world, os.path.join(runs, "workers"),
                       ("--maxThreads", "4"))
    n = same_files(res["dir"], one["dir"], "--maxThreads 4")
    check_host_only(res, 4, "K1", "--maxThreads 4")
    if res["launches"]["K1"] < res["served_launches"]["K1"] \
            or res["launches"]["K3"] <= 0:
        fail(f"--maxThreads 4: launches here {res['launches']}, of them "
             f"served for the workers {res['served_launches']}")
    if apps["most"] > len(apps["before"]) \
            or apps["during"] - set(apps["before"]) \
            or set(res["worker_pids"]) & apps["during"]:
        fail(f"--maxThreads 4: nvidia-smi listed up to {apps['most']} "
             f"contexts, pids {sorted(apps['during'])}, while the pool was "
             f"up, {apps['before']} before it (the workers "
             f"{res['worker_pids']})")
    report_run("port on cuda, 4 workers", res)
    print(f"--maxThreads 4: {n} files byte-equal to the one-process run; "
          f"all {res['nw_jobs']} NW jobs on the card, {res['served_nw_jobs']} "
          f"of them sent by the host-only workers to this process's device "
          f"server ({res['server']['requests']} requests), which launched "
          f"K1 {res['served_launches']['K1']} times for them (K1 here in all "
          f"{res['launches']['K1']}: the rest is the insert-size estimate); "
          f"every worker's CUDA initialised: {res['workers_cuda']} (ready, "
          f"then after its last task); nvidia-smi's compute apps: "
          f"{apps['before']} before the pool, at most {apps['most']} "
          f"contexts (pids {sorted(apps['during'])}) in {apps['polls']} "
          f"polls while it was up (this process is pid {os.getpid()} in its "
          f"namespace, the workers "
          f"{res['worker_pids']}); one process vs 4 workers: align "
          f"{one['align_s']:.3f} vs {res['align_s']:.3f} s, type "
          f"{one['type_s']:.3f} vs {res['type_s']:.3f} s, whole CLI "
          f"{one['wall_s']:.3f} vs {res['wall_s']:.3f} s")
    ready = res["workers_ready"]
    last = max(r[0] for r in ready)
    print(f"the 4 workers were ready {sorted(r[0] for r in ready)} s after "
          f"the pool was made (process start and imports "
          f"{sorted(r[1] for r in ready)} s, connection to the device server "
          f"{sorted(r[2] for r in ready)} s, package and aligner "
          f"{sorted(r[3] for r in ready)} s); the {res['pairs']} pairs then "
          f"took {res['align_s'] - last:.3f} s "
          f"({one['align_s'] / max(res['align_s'] - last, 1e-9):.2f} times "
          f"the one-process rate)")
    rec["nw_workers"]["launches"] = res["served_launches"]["K1"]
    # the workers' NW calls: a chunk of 256 pairs' jobs each
    check_nw(round(res["served_nw_jobs"] / res["served_launches"]["K1"]),
             101, 32, rec["nw_workers"])

    # run_hla_typing on the small world with the typing workers' gate
    # lowered (its two loci and few reads are under the default): K3 is
    # then launched for the workers too.  (z) runs the fan-out through its
    # real gate at four IMGT-scale loci
    log = io.StringIO()
    out_dir = os.path.join(runs, "typing_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    pair_ll_diff_cuda.launches = 0
    t0 = time.perf_counter()
    with logged(log):
        run_hla_typing(
            GraphPackage(small.graph),
            pairs=pair_up_fastq(small.fastq1, small.fastq2),
            output_dir=out_dir, device="cuda",
            cfg=RunConfig(max_threads=4, typer=TyperConfig(
                min_reads_for_typing_workers=1,
                min_loci_for_typing_workers=2)))
    wall = time.perf_counter() - t0
    same_files(out_dir, small_one["dir"], "typing workers")
    m = re.search(r"of them served for typing workers: K3 (\d+)",
                  log.getvalue())
    cuda = re.findall(r"alignment worker \d+: CUDA initialised (\w+) after "
                      r"its last task", log.getvalue())
    if not m or int(m.group(1)) <= 0 \
            or pair_ll_diff_cuda.launches != int(m.group(1)) \
            or not cuda or set(cuda) != {"False"}:
        fail(f"typing workers: K3 launches served for the workers "
             f"{m and m.group(1)}, here in all {pair_ll_diff_cuda.launches}; "
             f"the workers' CUDA states {cuda}")
    rec["pair_workers"]["launches"] = int(m.group(1))
    print(f"typing workers: byte-equal to the one-process run; K3 launched "
          f"{m.group(1)} times by the device server for the host-only "
          f"workers (every K3 launch of the run); the workers' CUDA "
          f"initialised after their last task: {cuda}; run_hla_typing "
          f"{wall:.3f} s")
    C, R = max(small_one["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_workers"])

    shard_dir = os.path.join(runs, "shards")
    shutil.rmtree(shard_dir, ignore_errors=True)
    walls = []
    for host in ("0", "1"):
        t0 = time.perf_counter()
        log = io.StringIO()
        with logged(log):
            rc = port_main(["--action", "HLA", *small.cli_args(), "--graph",
                            small.graph, "--sampleID", "S1",
                            "--outputDirectory",
                            os.path.join(runs, f"host{host}"), "--device",
                            "cuda", "--nHosts", "2", "--hostIdx", host,
                            "--shardDir", shard_dir])
        walls.append(time.perf_counter() - t0)
        jobs = re.search(r"n_chain_extensions: (\d+)", log.getvalue())
        on_card = re.search(r"nw_jobs_on_cuda: (\d+)", log.getvalue())
        if rc != 0 or not jobs or not on_card \
                or jobs.group(1) != on_card.group(1):
            fail(f"align shard {host}: rc {rc}, not every NW job on the card")
    merged = os.path.join(runs, "merged")
    shutil.rmtree(merged, ignore_errors=True)
    t0 = time.perf_counter()
    with logged(io.StringIO()):
        rc = port_main(["--action", "HLA", "--graph", small.graph,
                        "--sampleID", "S1", "--outputDirectory", merged,
                        "--device", "cuda", "--mergeShards", shard_dir])
    walls.append(time.perf_counter() - t0)
    if rc != 0:
        fail(f"--mergeShards: rc {rc}")
    n = same_files(merged, small_one["dir"], "shards + merge")
    print(f"--nHosts 2 + --mergeShards: {n} files byte-equal to the "
          f"one-process run; align shards {walls[0]:.3f} and {walls[1]:.3f} "
          f"s, merge and typing {walls[2]:.3f} s")
    sync()
    return {"workers": res, "typing_workers": out_dir}


def sharded_phases(one_process: dict, rec: dict) -> None:
    """Phase (q): the sharded backend on the one card, against the
    one-process runs of (e) and (f)."""
    import numpy as np
    from hla_la_tpu_torch.models.aligner import NWRunner
    from hla_la_tpu_torch.ops.pair_ll import pair_ll_reduction, pair_tiles
    from hla_la_tpu_torch.parallel import launch
    from hla_la_tpu_torch.parallel.mesh import model_axis

    world, one = one_process["imgt"]
    phase("(q) the sharded backend on one card: NCCL at one rank, gloo at "
          "two and four ranks (traffic between cards is not measured here)")
    rng = np.random.default_rng(7)
    B, L, W = 4097, 101, 32            # not divisible by 2 or 4
    reads, lens, refs = nw_world(rng, B, L, W)
    want_nw = [a.copy() for a in NWRunner("cuda").run(reads, lens, refs)]
    Lmat = rng.normal(-40.0, 8.0, (PAIR_C, 4115)).astype(np.float32)
    want_pair = pair_ll_reduction(Lmat, "cuda")
    # a process takes seconds to reach the card, one after the other: one
    # start per rank serves both functions; the 2 x 2 mesh is the CLI
    # run's below
    for n_ranks in (1, 2):
        n_model = model_axis(n_ranks)
        t0 = time.perf_counter()
        got = launch.run_ranks(launch.rank_nw_and_pair, n_ranks, "cuda",
                               (reads, lens, refs, Lmat))
        for rank, (got_nw, got_pair, launches) in enumerate(got):
            if not all(np.array_equal(a, b)
                       for a, b in zip(got_nw, want_nw)):
                fail(f"ShardedNW on {n_ranks} ranks: rank {rank} differs "
                     f"from NWRunner.run")
            if not np.allclose(got_pair, want_pair, rtol=PAIR_RTOL,
                               atol=PAIR_ATOL):
                fail(f"pair_ll_reduction_sharded on {n_ranks} ranks: max "
                     f"abs err {np.abs(got_pair - want_pair).max()}")
            if launches["K1"] != 1 or launches["K3"] != 1:
                fail(f"rank {rank} of {n_ranks}: launches {launches}")
        err = max(float(np.abs(g[1] - want_pair).max()) for g in got)
        print(f"{n_ranks} rank(s), model axis {n_model} "
              f"({'NCCL' if n_ranks == 1 else 'gloo, host tensors'}): "
              f"ShardedNW bit-equal to NWRunner.run at B={B} L={L} W={W}; "
              f"pair_ll_reduction_sharded at C={PAIR_C} R={Lmat.shape[1]} "
              f"within rtol={PAIR_RTOL} atol={PAIR_ATOL} of one device (max "
              f"abs err {err:.4g}), K1 and K3 launched once on every rank; "
              f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    small, small_one = one_process["small"]
    check_sharded_cli(small, small_one, 1, "sharded_nccl_1")
    launches = check_sharded_cli(world, one, 4, "sharded_gloo_4")
    rec["nw_sharded"]["launches"] = launches["K1"]
    rec["pair_sharded"]["launches"] = launches["K3"]
    # a rank's calls: a quarter of each NW batch; of each locus, half the
    # tile list (rank 0: the first half) on half the reads
    if model_axis(4) != 2:
        fail("four ranks no longer form a 2 x 2 mesh")
    check_nw(round(one["nw_jobs"] / launches["K1"] / 4), 101, 32,
             rec["nw_sharded"])
    C, R = max(one["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, -(-R // 2), rec["pair_sharded"], (0, pair_tiles(C) // 2))
    sync()


def graft_entry_phases(rec: dict) -> None:
    """Phases (u) and (v): the graft entry's typing step on cuda against
    the CPU, and the many-rank dry run with both ranks on the card."""
    import numpy as np
    from hla_la_tpu_torch import graft_entry
    from hla_la_tpu_torch.bench_common import zero_launches
    from hla_la_tpu_torch.models.parallel_host import kernel_launches

    phase("(u) the graft entry's typing step: cuda vs the CPU")
    fn, args = graft_entry.entry("cuda")
    zero_launches()
    t0 = time.perf_counter()
    got = fn(*args)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    got = [t.cpu().numpy() for t in got]
    fn_cpu, _ = graft_entry.entry("cpu")
    want = [t.numpy() for t in fn_cpu(*args)]
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        fail(f"graft entry on cuda: launches {launches}")
    if not np.array_equal(got[0], want[0]):
        fail("graft entry: NW scores differ between cuda and the CPU")
    pair_err = float(np.abs(got[1] - want[1]).max())
    marg_err = float(np.abs(got[2] - want[2]).max())
    if not np.allclose(got[1], want[1], rtol=PAIR_RTOL, atol=PAIR_ATOL):
        fail(f"graft entry: pair matrix differs by {pair_err:.4g}")
    if marg_err > MARG_ATOL:
        fail(f"graft entry: marginal differs by {marg_err:.4g}")
    s = graft_entry.ENTRY_SHAPES
    print(f"graft entry (B={s['B']} L={s['L']} W={s['W']}, C={s['C']} "
          f"R={s['R']} K={s['K']}): scores bit-identical to the CPU, pair "
          f"max abs err {pair_err:.4g}, marginal {marg_err:.3g}; launches "
          f"{launches}; {wall * 1e3:.1f} ms with its first launches")
    rec["nw_entry"]["launches"] = launches["K1"]
    rec["pair_entry"]["launches"] = launches["K3"]
    check_nw(s["B"], s["L"], s["W"], rec["nw_entry"])
    check_pair(s["C"], s["R"], rec["pair_entry"])
    sync()

    phase("(v) dryrun_multichip(2) with both ranks on the card")
    t0 = time.perf_counter()
    try:
        graft_entry.dryrun_multichip(2, "cuda")
    except (AssertionError, RuntimeError) as exc:
        fail(f"dryrun_multichip(2) on cuda: {exc}")
    print(f"dryrun_multichip(2) on cuda: all three phases passed in "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")


def real_scale_phases(rec: dict) -> None:
    """Phases (u)-(y): the graft entry, the dry run, and the real-PRG-scale
    worlds of bench.py, stress_wgs.py and stress_long.py on cuda."""
    import bench_torch
    import stress_long_torch
    import stress_wgs_torch

    graft_entry_phases(rec)
    n_workers = min(os.cpu_count() or 1, bench_torch.MAX_WORKERS)

    phase("(w) bench.py's 3M-level world: one align and one type pass")
    world = built_world("bench_world")
    try:
        st = bench_torch.bench(world, "cuda", n_workers, (0, 1), (0, 1))
    except AssertionError as exc:
        fail(f"bench world: {exc}")
    lw, lp = st["launches_workers"], st["launches_parent"]
    if lw["K1"] <= 0 or lp["K1"] < lw["K1"] or lp["K3"] <= 0:
        fail(f"bench world: launches here {lp}, of them for the workers "
             f"{lw}")
    check_twin_workers(st, ("K1",), "bench world")
    print(f"bench world ({world.n_levels} levels, {st['n_reads'] // 2} "
          f"pairs, {n_workers} workers): align {st['align_s'][0]:.3f} s "
          f"({st['n_reads'] / st['align_s'][0]:.1f} reads/s), type "
          f"{st['type_s'][0]:.3f} s; truth accuracy "
          f"{st['truth_accuracy']:.4f}; calls {st['calls']}; launches here "
          f"{lp}, of them for the host-only workers {lw}; all "
          f"{st['n_chain_extensions']} NW jobs on the card; C x R "
          f"{st['loci']}")
    rec["nw_bench"]["launches"] = lw["K1"]
    rec["pair_bench"]["launches"] = lp["K3"]
    check_nw(round(st["n_chain_extensions"] / lw["K1"]), 101, 32,
             rec["nw_bench"])
    C, R = max(st["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_bench"])
    sync()

    phase(f"(x) stress_wgs.py's world at {WGS_SMOKE_COVERAGE:g}x: serial vs "
          f"fan-out typing")
    world = built_world("wgs_world", lambda sim: sim.wgs_world(
        WORLD_DIR, WGS_SMOKE_COVERAGE))
    try:
        st = stress_wgs_torch.stress_wgs(world, "cuda", n_workers, os.path.join(
            WORLD_DIR, "runs", "wgs"))
    except AssertionError as exc:
        fail(f"WGS world: {exc}")
    print(f"WGS world ({world.n_levels} levels, {len(world.truth)} loci, "
          f"{st['pairs']} pairs, {st['pairs_aligned']} aligned): align "
          f"{st['align_s']:.3f} s ({st['reads_per_s']:.1f} reads/s), type "
          f"serial {st['type_serial_s']:.3f} s, fan-out "
          f"{st['type_fanout_s']:.3f} s over {st['typing_workers']} workers; "
          f"{st['files']} files byte-identical; calls exact at every locus; "
          f"launches here {st['launches_parent']}, of them for the "
          f"host-only workers {st['launches_workers']}; C x R {st['loci']}")
    if st["launches_workers"]["K1"] <= 0 or st["launches_workers"]["K3"] <= 0:
        fail(f"WGS world: launches for the workers {st['launches_workers']}")
    check_twin_workers(st, ("K1", "K3"), "WGS world")
    rec["nw_wgs"]["launches"] = st["launches_workers"]["K1"]
    rec["pair_wgs"]["launches"] = st["launches_workers"]["K3"]
    check_nw(round(st["n_chain_extensions"] / st["launches_workers"]["K1"]),
             101, 32, rec["nw_wgs"])
    C, R = max(st["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_wgs"])
    sync()

    phase("(y) stress_long.py's reads of the bench panel in 4 workers")
    wait_build("split_check")
    with open(SPLIT_RECORD) as fh:
        rec["nw_split"].update(json.load(fh))
    reads = built_world("long_bench_reads", lambda sim: sim.long_bench_reads(
        WORLD_DIR, coverage=LONG_SMOKE_COVERAGE))
    try:
        st = stress_long_torch.stress_long(reads, "cuda", os.path.join(
            WORLD_DIR, "runs", "long_bench"))
    except AssertionError as exc:
        fail(f"long reads of the bench panel: {exc}")
    if st["align_workers"] != 4 or st["launches_workers"]["K2"] <= 0:
        fail(f"long reads: {st['align_workers']} align workers, launches "
             f"{st['launches_workers']}")
    check_twin_workers(st, ("K2",), "long reads of the bench panel")
    print(f"long reads of the bench panel: {st['reads']} reads "
          f"({st['reads_over_split']} over 50 kb) -> {st['chunks']} chunks, "
          f"{st['mb']:.1f} Mb; whole run {st['wall_s']:.3f} s in 4 workers; "
          f"truth accuracy {st['truth_accuracy']:.4f}; calls {st['calls']}; "
          f"K2 launches for the host-only workers "
          f"{st['launches_workers']['K2']} (here in all "
          f"{st['launches_parent']['K2']}), K3 "
          f"{st['launches_parent']['K3']}; longest NW job L = "
          f"{st['longest_nw_job_L']}; all {st['n_chain_extensions']} NW jobs "
          f"on the card")
    rec["nw_split"]["launches"] = st["launches_workers"]["K2"]
    rec["pair_split"]["launches"] = st["launches_parent"]["K3"]
    C, R = max(st["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_split"])
    sync()


def imgt_phases(rec: dict) -> None:
    """Phases (z)-(ab): stress_imgt.py's twin on cuda: ``--loci4
    --sharded`` (the four-locus world with the typing fan-out at its real
    gate, the kernel section, the reduction on 8 ranks) as a process of its
    own, as the script runs (its peak-memory check is of that run alone);
    then long-read mode at C = 2,200 through its function."""
    import stress_imgt_torch as si
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.sim import typing_world
    from hla_la_tpu_torch.sim.worlds import IMGT4_GENES
    n_workers = min(os.cpu_count() or 1, si.MAX_WORKERS)

    phase("(z) stress_imgt.py --loci4 --sharded in a process of its own "
          "(started with this one): serial vs fan-out typing at 4 loci, then "
          "(ab) 8 ranks")
    wait_build("imgt4_world")
    t0 = time.perf_counter()
    proc = _WORLD_BUILDS.pop("imgt_twin")
    out, _ = proc.communicate("go\n")
    lines = out.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2 or lines[-2] != "STRESS_IMGT OK":
        fail(f"stress_imgt_torch.py --loci4 --sharded: exit code "
             f"{proc.returncode}, last lines {lines[-2:]}")
    st = json.loads(lines[-1])
    print(f"stress_imgt_torch.py --loci4 --sharded: "
          f"{time.perf_counter() - t0:.1f} s with its process, its pool and "
          f"its ranks")
    runs = st["typing_worker_runs"]
    worker_ms = [ms for run in runs for ms in run["k3_ms"]]
    lw = st["launches_workers"]
    if not st["fanout_ran"] or st["fanout_gate_lowered"] \
            or st["typing_workers"] != len(IMGT4_GENES) \
            or lw["K3"] != len(IMGT4_GENES) or len(worker_ms) != lw["K3"] \
            or lw["K1"] <= 0:
        fail(f"--loci4 fan-out: ran {st['fanout_ran']} in "
             f"{st['typing_workers']} workers (gate lowered "
             f"{st['fanout_gate_lowered']}), launches for the workers {lw}")
    check_twin_workers(st, ("K1",), "--loci4")
    print(f"--loci4 world ({st['pairs']} pairs, {st['pairs_aligned']} "
          f"aligned): align {st['align_s']:.3f} s in {st['align_workers']} "
          f"workers ({st['reads_per_s']:.1f} reads/s; pool and warm-up "
          f"{st['pool_ready_s']:.1f} s); typing serial "
          f"{st['type_serial_s']:.3f} s, fan-out {st['type_fanout_s']:.3f} s "
          f"in {st['typing_workers']} workers through the real gate "
          f"{st['fanout_gate']}, ready after "
          f"{[round(r['ready_s'], 2) for r in runs]} s, done after "
          f"{[round(r['done_s'], 2) for r in runs]} s; K3 per launch for "
          f"them (timed in the device server) "
          f"{[round(ms, 3) for ms in worker_ms]} ms; {st['files']} files "
          f"byte-identical; peak RSS {st['peak_rss_gb']:.2f} GB; calls "
          f"{st['calls']}; C x R {st['loci']}")
    rec["nw_imgt4"]["launches"] = lw["K1"]
    check_nw(round(st["n_chain_extensions"] / lw["K1"]), 101, 32,
             rec["nw_imgt4"])
    C, R = max(st["loci"].values(), key=lambda cr: cr[1])
    rec["pair_imgt4"].update(launches=lw["K3"], worker_ms=worker_ms)
    check_pair(C, R, rec["pair_imgt4"])
    pr = st["pair_reduction"]
    print(f"kernel section at C={pr['C']} R={pr['R']}: K3 "
          f"{pr['k3_warm_ms']:.3f} ms warm ({pr['k3_cold_ms']:.3f} cold, "
          f"with its copies and rank-1 term), native on the host "
          f"{pr.get('native_s', float('nan')):.3f} s, numpy "
          f"{pr['numpy_s']:.1f} s ({pr['numpy_s_is']})")
    rec["pair_imgt4"]["kernel_section"] = pr
    sync()

    phase("(ab) the sharded reduction on 8 ranks (4 x 2), from the run of (z)")
    sh = st["sharded"]
    per = sh["per_rank"]
    if sh["ranks"] != 8 or sh["mesh"] != "4x2" \
            or any(r["launches"] != 2 for r in per):
        fail(f"8-rank reduction: {sh['ranks']} ranks, mesh {sh['mesh']}, "
             f"launches {[r['launches'] for r in per]}")
    rank_ms = [[round(x, 3) for x in r["k3_ms"]] for r in per]
    print(f"8 ranks on the card ({sh['backend']}): {sh['warm_s']:.3f} s warm "
          f"({sh['cold_s']:.3f} s cold), {sh['wall_s']:.1f} s with the ranks' "
          f"start; K3 per rank {rank_ms} ms; tile ranges "
          f"{[r['tile_range'] for r in per]}, reads "
          f"{[r['reads'] for r in per]}; |sharded - one device| "
          f"{sh['vs_one_device_max_abs']:.4g}, |sharded - native| "
          f"{sh.get('vs_native_max_abs', float('nan')):.4g}")
    rec["pair_ranks8"].update(
        launches=sum(r["launches"] for r in per),
        rank_ms=[ms for r in per for ms in r["k3_ms"]])
    check_pair(pr["C"], per[0]["reads"][1], rec["pair_ranks8"],
               tuple(per[0]["tile_range"]))
    sync()

    phase("(aa) stress_imgt.py --long: long reads at C = 2,200")
    wait_build("imgt_long_reads")
    try:
        st = si.stress_long(typing_world(WORLD_DIR), "cuda", n_workers,
                            os.path.join(WORLD_DIR, "runs", "imgt_long"))
    except AssertionError as exc:
        fail(f"--long: {exc}")
    k2 = st["launches_workers"]["K2"]
    if k2 <= 0:
        fail(f"--long: K2 launches for the workers {st['launches_workers']}")
    check_twin_workers(st, ("K2",), "--long")
    print(f"--long: {st['reads']} reads ({st['mb']:.2f} Mb, longest "
          f"{st['longest_read']}), {st['aligned']} aligned in "
          f"{st['align_s']:.3f} s (pool {st['pool_s']:.1f} s), typed in "
          f"{st['type_s']:.3f} s; calls {st['calls']}; C x R {st['loci']}; "
          f"K2 {k2} launches for the host-only workers, K3 "
          f"{st['launches_parent']['K3']} here; all "
          f"{st['n_chain_extensions']} NW jobs on the card")
    # an unpaired read's jobs span the read: the largest call holds the
    # longest read, at most jobs_per_call of them
    L_max = st["longest_read"]
    B = min(jobs_per_call(L_max, LONG_W), -(-st["n_chain_extensions"] // k2))
    rec["nw_imgt_long"]["launches"] = k2
    check_nw_long(B, L_max, LONG_W, rec["nw_imgt_long"])
    rec["pair_imgt_long"]["launches"] = st["launches_parent"]["K3"]
    C, R = max(st["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_imgt_long"])
    sync()


def twin_phases(rec: dict) -> None:
    """Phases (ac)-(ae): the twins of tpu_e2e.py, bench_scaling.py and
    soak.py on cuda."""
    import bench_scaling_torch
    import e2e_torch
    import soak_torch
    from hla_la_tpu_torch.bench_common import largest_launches, zero_launches
    from hla_la_tpu_torch.models.parallel_host import kernel_launches
    from hla_la_tpu_torch.ops.pair_ll import pair_tiles

    phase("(ac) tpu_e2e.py's twin: the CPU against cold and warm cuda")
    wait_build("e2e_world")
    out = os.path.join(ROOT, "build", "e2e_torch.json")
    try:
        rc = e2e_torch.main(["--out", out])
    except AssertionError as exc:
        fail(f"e2e twin: {exc}")
    if rc != 0:
        fail(f"e2e twin exited {rc}")
    with open(out) as fh:
        e2e = json.load(fh)
    print(f"e2e twin ({e2e['world']['pairs']} pairs): CPU "
          f"{e2e['host_e2e_s']:.3f} s, cuda cold "
          f"{e2e['device_e2e_cold_s']:.3f} s, warm "
          f"{e2e['device_e2e_warm_s']:.3f} s; calls {e2e['calls']} "
          f"identical, max |dQ1| {e2e['max_abs_dq1']:.3g}; K3 at "
          f"{e2e['pair_C']} x {e2e['pair_R']}: {e2e['pair_s'] * 1e3:.3f} ms "
          f"({e2e['pair_gcells_per_s']:.1f} Gcells/s); launches of the "
          f"device runs {e2e['launches_device_runs']}")
    rec["nw_e2e"]["launches"] = e2e["launches_device_runs"]["K1"]
    check_nw(*e2e["largest_launches"]["K1"], rec["nw_e2e"])
    rec["pair_e2e"]["launches"] = e2e["pair_launches"]
    check_pair(e2e["pair_C"], e2e["pair_R"], rec["pair_e2e"])
    sync()

    phase("(ad) bench_scaling.py's twin at 1, 2 and 4 ranks on the card")
    try:
        runs = bench_scaling_torch.scaling("cuda", SCALING_RANKS)
    except AssertionError as exc:
        fail(f"scaling twin: {exc}")
    for run in runs:
        print(json.dumps({k: v for k, v in run.items()
                          if k not in ("inputs", "out")}))
    last = runs[-1]
    per_rank = last["launches_per_rank"]
    if any(lc["K1"] <= 0 or lc["K3"] <= 0 for lc in per_rank):
        fail(f"scaling twin: launches per rank {per_rank}")
    bs = bench_scaling_torch
    rec["nw_scaling"]["launches"] = sum(lc["K1"] for lc in per_rank)
    check_nw(bs.B0, bs.L, bs.W, rec["nw_scaling"])
    rec["pair_scaling"]["launches"] = sum(lc["K3"] for lc in per_rank)
    n_model = int(last["mesh"].split("x")[1])
    check_pair(bs.C, bs.B0, rec["pair_scaling"],
               (0, pair_tiles(bs.C) // n_model))
    sync()

    phase("(ae) soak.py's twin on cuda: seeds 1000-1003 of hla, 1000 of the "
          "rest")
    zero_launches()
    fails = soak_torch.run(len(SOAK_HLA_SEEDS), SOAK_HLA_SEEDS[0], "hla",
                           "cuda")
    for mode in SOAK_MODES:
        fails += soak_torch.run(1, SOAK_SEED, mode, "cuda")
    launches, largest = kernel_launches(), largest_launches()
    sync()
    n_trials = len(SOAK_HLA_SEEDS) + len(SOAK_MODES)
    if fails:
        fail(f"soak twin: {fails} of {n_trials} trials failed")
    if any(launches[k] <= 0 for k in ("K1", "K2", "K3")):
        fail(f"soak twin: launches {launches}")
    print(f"soak twin: all {n_trials} trials passed on cuda; launches "
          f"{launches}, largest {largest}")
    rec["nw_soak"]["launches"] = launches["K1"]
    check_nw(*largest["K1"], rec["nw_soak"])
    rec["nw_long_soak"]["launches"] = launches["K2"]
    check_nw_long(*largest["K2"], rec["nw_long_soak"])
    rec["pair_soak"]["launches"] = launches["K3"]
    check_pair(*largest["K3"], rec["pair_soak"])
    sync()


def same_trace(got: list, want: list, tag: str) -> float:
    """A linear-ALT trace (LinearALTsTyper.trace) against another: every NW
    call's scores and the likelihood rows bit for bit, the pair matrix
    within rtol PAIR_RTOL / atol PAIR_ATOL.  Returns its max abs error."""
    import numpy as np
    if [t[0] for t in got] != [t[0] for t in want]:
        fail(f"{tag}: traced calls {[t[0] for t in got]}, one process "
             f"{[t[0] for t in want]}")
    err = 0.0
    for g, w in zip(got, want):
        if not np.array_equal(g[1], w[1]):
            fail(f"{tag}: {'NW scores' if g[0] == 'nw_scores' else 'rows'}"
                 f" differ from the one-process run's")
        if g[0] == "pair":
            err = max(err, float(np.abs(g[2] - w[2]).max()))
            if not np.allclose(g[2], w[2], rtol=PAIR_RTOL, atol=PAIR_ATOL):
                fail(f"{tag}: pair LL max abs err {err:.4g} beyond "
                     f"rtol={PAIR_RTOL} atol={PAIR_ATOL}")
    return err


def same_printed(got: list, want: list, tag: str) -> None:
    """Printed lines equal but for a posterior, which may move by Q_TOL."""
    pat = re.compile(r"posterior ([0-9.]+)")
    if [pat.sub("posterior P", ln) for ln in got] != \
            [pat.sub("posterior P", ln) for ln in want]:
        fail(f"{tag}: printed {got}, one process {want}")
    for a, b in zip(pat.findall("\n".join(got)), pat.findall("\n".join(want))):
        if abs(float(a) - float(b)) > Q_TOL:
            fail(f"{tag}: posterior {a} against {b}")


def sharded_action_phases(kir_one: dict, rec: dict) -> None:
    """Phases (af) and (ag): the sharded backend on --action KIR,
    KIRsimulation and TestHLATyping, each against its one-process run on
    the card."""
    from hla_la_tpu_torch.parallel import launch
    from hla_la_tpu_torch.sim import kir_world

    world, one = kir_one["world"], kir_one["run"]
    phase("(af) --action KIR --sharded 2 on the world of (k): two gloo "
          "ranks sharing the card")
    t0 = time.perf_counter()
    out_dir = os.path.join(WORLD_DIR, "runs", "kir_sharded")
    shutil.rmtree(out_dir, ignore_errors=True)
    log = io.StringIO()
    # the ranks are new processes: their launch counts start at 0
    with captured_stderr(log):
        ranks = launch.run_ranks(launch.rank_cli, 2, "cuda", (
            ["--action", "KIR", *world.cli_args(), "--sampleID", "S1",
             "--outputDirectory", out_dir, "--device", "cuda", "--sharded",
             "2"], True))
    wall = time.perf_counter() - t0
    if [r[0] for r in ranks] != [0, 0]:
        fail(f"KIR on 2 ranks: exit codes {[r[0] for r in ranks]}")
    got, want = kir_outputs({"dir": out_dir}), kir_outputs(one)
    if got[0] != want[0] or got[2] != want[2] \
            or abs(got[1] - want[1]) > Q_TOL:
        fail(f"KIR on 2 ranks: called {got[0]} (posterior {got[1]}), one "
             f"process {want[0]} ({want[1]}); reads2Genes "
             f"{'equal' if got[2] == want[2] else 'differ'}")
    check_kir({"dir": out_dir}, world)
    err = max(same_trace(r[3], kir_one["trace"], f"KIR rank {rank}")
              for rank, r in enumerate(ranks))
    n_scores = sum(len(t[1]) for t in kir_one["trace"]
                   if t[0] == "nw_scores")
    text = log.getvalue()
    jobs = [int(n) for n in re.findall(r"n_chain_extensions: (\d+)", text)]
    on_card = [int(n) for n in re.findall(r"nw_jobs_on_cuda: (\d+)", text)]
    if jobs != [one["nw_jobs"]] * 2 or on_card != jobs:
        fail(f"KIR on 2 ranks: NW jobs per rank {jobs}, on the card "
             f"{on_card}, one process {one['nw_jobs']}")
    launches = [r[1] for r in ranks]
    largest = [r[2] for r in ranks]
    if any(lc["K1"] <= 0 or lc["K3"] <= 0 for lc in launches):
        fail(f"KIR on 2 ranks: launches per rank {launches}")
    for line in re.findall(r"linear-ALT pair reduction on rank .*", text):
        print(line)
    H, R = next(t[1] for t in kir_one["trace"] if t[0] == "pair").shape
    print(f"KIR on 2 ranks: the call, posterior (|d| "
          f"{abs(got[1] - want[1]):.3g}) and reads2Genes of (k); {n_scores} "
          f"NW scores and the {H} x {R} likelihood rows bit-equal, pair LL "
          f"max abs err {err:.4g}; {jobs[0]} NW jobs per "
          f"rank, all on the card; launches per rank {launches}, largest "
          f"per rank {largest}; whole run with the ranks' start "
          f"{wall:.3f} s (one process {one['wall_s']:.3f} s)")
    for key, kernel in (("nw_kir_ranks", "K1"), ("pair_kir_ranks", "K3")):
        rec[key]["launches"] = sum(lc[kernel] for lc in launches)
        rec[key]["launches_per_rank"] = [lc[kernel] for lc in launches]
    check_nw(*max((lg["K1"] for lg in largest), key=lambda s_: s_[0]),
             rec["nw_kir_ranks"], make_world=kir_nw_world)
    check_pair(*max((lg["K3"] for lg in largest), key=lambda s_: s_[1]),
               rec["pair_kir_ranks"])
    sync()
    print(f"(af) took {time.perf_counter() - t0:.1f} s")

    phase("(ag) --action KIRsimulation --backend sharded (one rank) and "
          "--action TestHLATyping --sharded 2 on the card")
    t0 = time.perf_counter()
    small = kir_world(WORLD_DIR, **SMALL_KIR_WORLD)
    work = os.path.join(WORLD_DIR, "runs", "test_typing")
    shutil.rmtree(work, ignore_errors=True)
    for tag, argv, flags, n_ranks in (
            ("--action KIRsimulation", ["--action", "KIRsimulation",
                                        "--ALTpanel", small.panel, "--seed",
                                        "5"], ["--backend", "sharded"], 1),
            ("--action TestHLATyping", ["--action", "TestHLATyping"],
             ["--sharded", "2"], 2)):
        if tag.endswith("TestHLATyping"):
            argv = argv + ["--workingDir", os.path.join(work, "one")]
        t1 = time.perf_counter()
        want = run_cli(argv, "cuda", tag)
        one_s = time.perf_counter() - t1
        if tag.endswith("TestHLATyping"):
            argv = argv[:-1] + [os.path.join(work, "sharded")]
        t1 = time.perf_counter()
        out, log = run_subprocess_cli(argv + ["--device", "cuda", *flags],
                                      f"{tag} {' '.join(flags)}")
        ranks_s = time.perf_counter() - t1
        lines = out.splitlines()
        same_printed(lines, want["lines"], f"{tag} {' '.join(flags)}")
        if "OK" not in lines[0] and lines[-1] != "OK":
            fail(f"{tag} {' '.join(flags)}: printed {lines}")
        launches = rank_launches(log)
        if len(launches) != n_ranks or any(
                lc["K1"] <= 0 or lc["K3"] <= 0 for lc in launches):
            fail(f"{tag} {' '.join(flags)}: launches per rank {launches}")
        if flags[0] == "--backend" and \
                "--backend sharded: --device cuda, --sharded 1" not in log:
            fail("--backend sharded was not taken as one rank on the card")
        print(f"{tag} {' '.join(flags)}: {n_ranks} rank(s) print the one-"
              f"process lines {lines}; launches per rank {launches}; "
              f"{ranks_s:.3f} s with the process and its ranks' start (one "
              f"process {one_s:.3f} s, launches {want['launches']})")
    sync()
    print(f"(ag) took {time.perf_counter() - t0:.1f} s")


def handover_lines(log: str) -> dict:
    """What a --sharded run with workers logs of its hand-overs (each rank
    0's bytes and seconds to send, each other rank's wait and read) and of
    each rank's alignment phase (seconds, in log order)."""
    return {
        "sent": [(what, int(n), float(s_)) for what, n, s_ in re.findall(
            r"rank 0 handed over (.*?): (\d+) bytes sent in ([0-9.]+) s",
            log)],
        "taken": [(int(r), what, int(n), float(w), float(s_))
                  for r, what, n, w, s_ in re.findall(
                      r"rank (\d+) took (.*?) from rank 0: (\d+) bytes after "
                      r"waiting ([0-9.]+) s, read in ([0-9.]+) s", log)],
        "align_s": [float(x) for x in re.findall(
            r"aligned \d+/\d+ pairs \+ \d+/\d+ unpaired in ([0-9.]+) s",
            log)]}


def sharded_worker_phases(one_process: dict, workers: dict,
                          rec: dict) -> None:
    """Phase (ah): --sharded 2 --maxThreads 4, one pool of four host-only
    workers in rank 0 whose alignments rank 0 hands to rank 1, on the world
    of (e) against (p)'s --maxThreads 4 run; then the typing workers' gate
    lowered on the small world of (f): rank 0 types in its pool, against
    (p)'s typing-workers run; then (i)'s long reads aligned in rank 0's
    pool and typed on both ranks, against (i)'s cuda run."""
    from hla_la_tpu_torch.bench_common import worker_lines
    from hla_la_tpu_torch.parallel import launch
    from hla_la_tpu_torch.utils.config import RunConfig, TyperConfig

    world, _ = one_process["imgt"]
    small, small_one = one_process["small"]
    one = workers["workers"]
    phase("(ah) --sharded 2 --maxThreads 4 on the world of (e): one pool of "
          "4 host-only workers in rank 0; the typing fan-out in rank 0 on "
          "the small world; long reads through rank 0's pool on (i)'s world")
    t0 = time.perf_counter()
    tag = "--sharded 2 --maxThreads 4"
    out_dir = os.path.join(WORLD_DIR, "runs", "sharded_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    # nvidia-smi's compute apps while the ranks and the pool are up: the
    # two ranks' contexts, and none of a worker (counted: the card host
    # lists every process of this machine under one pid)
    with compute_apps_watch() as apps:
        t1 = time.perf_counter()
        _, log = run_subprocess_cli(
            ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
             "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
             "cuda", "--sharded", "2", "--maxThreads", "4"], tag)
        wall = time.perf_counter() - t1
    n = same_outputs(out_dir, one["dir"], tag)
    got = {"dir": out_dir, "bestguess": read_table(
        os.path.join(out_dir, "hla", "R1_bestguess.txt"))}
    q_err = check_same_run(got, one)
    jobs = [int(x) for x in re.findall(r"n_chain_extensions: (\d+)", log)]
    on_card = [int(x) for x in re.findall(r"nw_jobs_on_cuda: (\d+)", log)]
    if len(jobs) != 2 or jobs != on_card or max(jobs) != one["nw_jobs"]:
        fail(f"{tag}: NW jobs per rank {jobs}, on the card {on_card}, "
             f"(p)'s run {one['nw_jobs']}")
    res = {**worker_lines(log), "nw_jobs": max(jobs), "served_launches": {
        k: int(x) for k, x in re.findall(r"served_launches_(K\d): (\d+)",
                                         log)}}
    check_host_only(res, 4, "K1", tag)
    launches = rank_launches(log)
    pools = log.count("aligning with 4 worker processes on cuda")
    hand = handover_lines(log)
    if len(launches) != 2 or any(lc["K1"] <= 0 or lc["K3"] <= 0
                                 for lc in launches) \
            or launches[0]["K1"] < res["served_launches"]["K1"] or pools != 1 \
            or [w[0] for w in hand["sent"]] != ["the alignments"] \
            or [t[:2] for t in hand["taken"]] != [(1, "the alignments")]:
        fail(f"{tag}: launches per rank {launches}, served "
             f"{res['served_launches']}, {pools} pools, hand-overs {hand}")
    if apps["most"] != len(apps["before"]) + 2:
        fail(f"{tag}: nvidia-smi listed at most {apps['most']} contexts, "
             f"{len(apps['before'])} before the run: not the two ranks' "
             f"beside them")
    ready = res["workers_ready"]
    (_, n_bytes, send_s), = hand["sent"]
    (_, _, _, wait_s, read_s), = hand["taken"]
    print(f"{tag}: {n} files of (p)'s --maxThreads 4 run (the pair dumps "
          f"within rtol={PAIR_RTOL} atol={PAIR_ATOL}, max |dQ| {q_err:.3g}); "
          f"one pool, rank 0's: its 4 workers ready "
          f"{sorted(r[0] for r in ready)} s after it was made, none with "
          f"torch imported or CUDA initialised; rank 0's device server ran "
          f"{res['server']['nw_jobs']} NW jobs in {res['server']['requests']} "
          f"requests, K1 {res['served_launches']['K1']} times; NW jobs per "
          f"rank {jobs}, all on the card; launches per rank {launches}; the "
          f"alignments handed over: {n_bytes} bytes, sent in {send_s:.3f} "
          f"s, rank 1 waited {wait_s:.3f} s and read them in {read_s:.3f} s; "
          f"align phases (log order) {hand['align_s']} s against (p)'s "
          f"{one['align_s']:.3f} s; nvidia-smi: {apps['before']} before, at "
          f"most {apps['most']} contexts (pids {sorted(apps['during'])}) in "
          f"{apps['polls']} polls; whole CLI with the ranks' start "
          f"{wall:.3f} s ((p) {one['wall_s']:.3f} s)")
    rec["nw_ranks_pool"]["launches"] = res["served_launches"]["K1"]
    check_nw(round(res["served_nw_jobs"] / res["served_launches"]["K1"]),
             101, 32, rec["nw_ranks_pool"])

    # the same ranks without workers: each aligns every read itself, and
    # both runs' sharded typers reduce the same alignments alike
    pooled_dir = out_dir
    out_dir = os.path.join(WORLD_DIR, "runs", "sharded_2")
    shutil.rmtree(out_dir, ignore_errors=True)
    t1 = time.perf_counter()
    _, log = run_subprocess_cli(
        ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
         "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
         "cuda", "--sharded", "2"], "--sharded 2")
    bare_wall = time.perf_counter() - t1
    n = same_files(out_dir, pooled_dir, "--sharded 2")
    jobs = re.findall(r"n_chain_extensions: (\d+)", log)
    if jobs != re.findall(r"nw_jobs_on_cuda: (\d+)", log) or len(jobs) != 2:
        fail(f"--sharded 2: NW jobs per rank {jobs}, not all on the card")
    print(f"--sharded 2 without workers: {n} files byte-equal to those of "
          f"the run with rank 0's pool; align phases "
          f"{handover_lines(log)['align_s']} s "
          f"against {hand['align_s']} s with rank 0's pool and "
          f"{one['align_s']:.3f} s in (p)'s one process; launches per rank "
          f"{rank_launches(log)}; whole CLI {bare_wall:.3f} s against "
          f"{wall:.3f} s")

    # the typing workers' gate lowered (the small world's two loci and few
    # reads are under the default), as (p) ran it in one process
    tag = "--sharded 2, typing fan-out in rank 0"
    out_dir = os.path.join(WORLD_DIR, "runs", "sharded_typing_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = RunConfig(max_threads=4, typer=TyperConfig(
        min_reads_for_typing_workers=1, min_loci_for_typing_workers=2))
    log = io.StringIO()
    t1 = time.perf_counter()
    with captured_stderr(log):
        ranks = launch.run_ranks(launch.rank_hla_typing, 2, "cuda", (
            small.graph, (small.fastq1, small.fastq2), out_dir, cfg))
    wall = time.perf_counter() - t1
    n = same_files(out_dir, workers["typing_workers"], tag)
    text = log.getvalue()
    served = [int(x) for x in re.findall(
        r"of them served for typing workers: K3 (\d+)", text)]
    (calls0, lc0, _), (calls1, lc1, _) = ranks
    if calls0 != calls1 or len(served) != 1 or served[0] <= 0 \
            or lc0["K3"] != served[0] or lc1["K3"] != 0 \
            or text.count("rank 1: rank 0 types the loci in worker "
                          "processes") != 1:
        fail(f"{tag}: calls {calls0} / {calls1}, K3 served {served}, "
             f"launches per rank {[lc0, lc1]}")
    print(f"{tag}: {n} files byte-equal to (p)'s typing-workers run; rank 0 "
          f"typed in its pool, its device server launched K3 {served[0]} "
          f"times for the workers; rank 1 ran no typer (K3 {lc1['K3']}); "
          f"launches per rank {[lc0, lc1]}; {wall:.3f} s with the ranks' "
          f"start")
    rec["pair_ranks_fan_out"]["launches"] = served[0]
    C, R = max(small_one["loci"].values(), key=lambda cr: cr[1])
    check_pair(C, R, rec["pair_ranks_fan_out"])
    sync()

    # long reads: (i)'s world has too few reads to start a pool, so the
    # ranks lower the threshold to its count; the typing gate fails and
    # both ranks type the handed-over chains in the sharded typer; rank 1
    # aligns nothing (no insert size to estimate), so its statistics hold
    # no NW job
    long_world, long_one = one_process["small_long"]
    tag = "--sharded 2 --maxThreads 4 --longReads ont2d"
    out_dir = os.path.join(WORLD_DIR, "runs", "sharded_long_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    log = io.StringIO()
    t1 = time.perf_counter()
    with captured_stderr(log):
        ranks = launch.run_ranks(launch.rank_hla_typing, 2, "cuda", (
            long_world.graph, (long_world.fastq,), out_dir,
            RunConfig(max_threads=4, long_reads="ont2d"), 0))
    wall = time.perf_counter() - t1
    n = same_outputs(out_dir, long_one["dir"], tag)
    text = log.getvalue()
    (calls0, lc0, big0), (calls1, lc1, _) = ranks
    jobs = [int(x) for x in re.findall(r"n_chain_extensions: (\d+)", text)]
    on_card = [int(x) for x in re.findall(r"nw_jobs_on_cuda: (\d+)", text)]
    res = {**worker_lines(text), "nw_jobs": max(jobs, default=0),
           "served_launches": {k: int(x) for k, x in re.findall(
               r"served_launches_(K\d): (\d+)", text)}}
    check_host_only(res, 4, "K2", tag)
    hand = handover_lines(text)
    k2 = res["served_launches"]["K2"]
    if calls0 != calls1 or sorted(jobs) != [0, long_one["nw_jobs"]] \
            or on_card != [long_one["nw_jobs"]] \
            or text.count("aligning with 4 worker processes on cuda") != 1 \
            or lc0["K2"] != k2 or lc1["K2"] != 0 \
            or min(lc0["K3"], lc1["K3"]) <= 0 \
            or [w[0] for w in hand["sent"]] != ["the alignments"] \
            or [t[:2] for t in hand["taken"]] != [(1, "the alignments")]:
        fail(f"{tag}: calls {calls0} / {calls1}, NW jobs per rank {jobs}, "
             f"on the card {on_card}, (i)'s {long_one['nw_jobs']}, launches "
             f"per rank {[lc0, lc1]}, served K2 {k2}, hand-overs {hand}")
    (_, n_bytes, send_s), = hand["sent"]
    (_, _, _, wait_s, read_s), = hand["taken"]
    print(f"{tag}: {n} files of (i)'s cuda run (the pair dumps within "
          f"rtol={PAIR_RTOL} atol={PAIR_ATOL}); rank 0's 4 host-only workers "
          f"aligned {long_one['nw_jobs']} NW jobs, K2 {k2} times by its "
          f"device server (largest launch {big0.get('K2')}); the chains "
          f"handed over: {n_bytes} bytes, sent in {send_s:.3f} s, rank 1 "
          f"waited {wait_s:.3f} s and read them in {read_s:.3f} s; align "
          f"phases {hand['align_s']} s against (i)'s one process "
          f"{long_one['align_s']:.3f} s; launches per rank {[lc0, lc1]}; "
          f"{wall:.3f} s with the ranks' start")
    rec["nw_long_ranks_pool"]["launches"] = k2
    check_nw_long(*big0["K2"], rec["nw_long_ranks_pool"])
    sync()
    print(f"(ah) took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import torch
        import hla_la_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"FAIL: {exc} (run from a checkout of the repository)",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from hla_la_tpu_torch import _build
    from hla_la_tpu_torch.device import resolve
    resolve("cuda")
    t_start = time.perf_counter()

    phase("(a) toolchain")
    smi = toolchain()

    phase("(b) build")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {lib.path} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_s:.1f} s)")
    print(lib.log.strip())

    rec = kernel_records()
    pair_epilogue_phase()
    start_world_builds()
    start_real_scale_builds()
    start_e2e_build()
    start_imgt_twin()
    try:
        one_process = hla_phases(rec["nw"], rec["pair"], rec["nw_long"],
                                 rec["pair_long"])
        kir_one = kir_asm_phases(rec["nw_kir"], rec["pair_kir"],
                                 rec["nw_asm"])
        cohort_phases(one_process, rec)
        flag_phases()
        workers = worker_phases(one_process, rec)
        sharded_phases(one_process, rec)
        real_scale_phases(rec)
        imgt_phases(rec)
        twin_phases(rec)
        sharded_action_phases(kir_one, rec)
        sharded_worker_phases(one_process, workers, rec)
    finally:
        stop_world_builds()

    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rec.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
