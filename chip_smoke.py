"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero
and no result line is printed.  The three full-size worlds are built in
processes of their own from the start, and (g) runs before (e), while the
IMGT-scale world is still being built:

  (a) toolchain: torch, CUDA, nvcc, and the card's name and power limit;
  (b) build: compile the kernels from hla_la_tpu_torch/csrc with nvcc;
  (c) K1, the banded NW forward, against its plain PyTorch version on the
      card, bit-identical on live rows and across reruns, at
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
  (h) end to end on long reads: a two-locus world with class-I-sized genes
      (2,200 alleles per locus) and unpaired 10 kb ONT-like reads at 30x,
      typed by the port's CLI (``--longReads ont2d --FASTQU ... --device
      cuda``).  The path must launch K2 and K3 and run every NW job on the
      card; each locus must call exactly its planted alleles with Q1 > 0.9.
      K3 is then held against its plain version at each locus's C x R, as
      in (d);
  (i) the same recipe at a small size (backbone 6,000, 60 alleles, 2 kb
      reads at 20x) on cuda against the CPU, as (f);
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
  (p) worker processes and align shards on cuda, on the world of (e):
      ``--maxThreads 4`` (every worker holds a context on the card): every
      output file byte-equal to the one-process run of (e), every NW job on
      the card summed over the workers, K1 launched in the workers; then
      the same run through ``run_hla_typing`` with the typing workers' gate
      lowered, so that K3 is launched in the workers too; then ``--nHosts 2
      --hostIdx 0/1 --shardDir`` and ``--mergeShards``, byte-equal again.
      One-process and worker walls are printed side by side, with the
      time the workers took to be ready;
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

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them is the kernels' JSON
record, one entry per kernel and main path (K1 runs on four, K2 on two, K3
on five), with the
launches of that path's run and the kernel's time beside its bound: the
larger of its bytes (inputs read once, outputs written once) over the card's
memory rate and its operations over the card's peak rate for their type.
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
Q_TOL = 1e-3
Q1_MIN, C_MIN = 0.9, 2000       # stress_imgt.py's checks at IMGT scale
SMALL_WORLD = {"n_alleles": 60, "coverage": 40.0}
# (B, L, W) of phase (g) besides the shape of phase (h)'s NW calls; the
# third is also held against the CPU, the last passes 2^31 pointer bytes
NW_LONG_SHAPES = ((128, 4096, 256), (1024, 1400, 160), (256, 500, 100),
                  (64, 1000, 600), (256, 500, 33), (8192, 1100, 256))
NW_LONG_CPU = NW_LONG_SHAPES[2]
LONG_W = 256                    # the aligner's band in long-read mode
SMALL_LONG_WORLD = {"backbone": 6000, "n_alleles": 60, "coverage": 20.0,
                    "read_length": 2000}
KIR_L, KIR_W = 100, 32          # the KIR world's reads, LinearALTsTyper.band
ASM_W = 48                      # AssemblyTyper.band
EDIT_SCORING = {"match": 0.0, "mismatch": -1.0, "gap_open": -1.0,
                "gap_extend": -1.0}     # models/asm.py::EDIT_SCORING
KIR_PAIR_SHAPES = ((32, 22500), (32, 45000), (6, 22500), (6, 45000))
POSTERIOR_MIN, R2G_MIN = 0.9, 0.9       # the KIR self-test's bars
SMALL_KIR_WORLD = {"length": 12000, "coverage": 10.0}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


_WORLD_BUILDS: dict = {}        # simulator's name -> the process making it


def start_world_builds() -> None:
    """Build the three full-size worlds into the cache under WORLD_DIR, each
    in a process of its own, while the kernels are built and held against
    their plain versions: the simulators are host Python and take minutes."""
    code = ("import sys; from hla_la_tpu_torch import sim; "
            "getattr(sim, sys.argv[1])(sys.argv[2])")
    for name in ("typing_world", "long_read_world", "kir_world"):
        _WORLD_BUILDS[name] = subprocess.Popen(
            [sys.executable, "-c", code, name, WORLD_DIR], cwd=ROOT)


def built_world(name: str):
    """The full-size world of simulator `name` from the cache, once its
    build process (if one was started) has ended."""
    from hla_la_tpu_torch import sim
    t0 = time.perf_counter()
    proc = _WORLD_BUILDS.pop(name, None)
    if proc is not None and proc.wait() != 0:
        fail(f"building {name} failed (exit code {proc.returncode})")
    world = getattr(sim, name)(WORLD_DIR)
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
    """Mean device time of `fn` over `reps` launches (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
            "bound_ms_float32_only": by_flops,
            "library_ms": None}     # a broadcast logaddexp + sum would
    # need a C x C x R intermediate; no single PyTorch call computes it


def toolchain() -> str:
    import torch
    from hla_la_tpu_torch import _build
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
    first = next(iter(others.values()))
    live = first[0] > -1e29
    names = ("score", "end_k", "end_state", "pointers")
    for tag, other in others.items():
        for name, a, b in zip(names, got, other):
            if not np.array_equal(a[live], b[live]):
                bad = np.nonzero((a[live] != b[live]).reshape(
                    int(live.sum()), -1).any(axis=1))[0]
                fail(f"{kernel} vs {tag} at {shape}: {name} differs on "
                     f"{len(bad)} live rows (first {bad[:5].tolist()})")
    return int(live.sum()), float(np.abs(got[0][live] - first[0][live]).max())


def check_nw(B: int, L: int, W: int, record: dict | None,
             make_world=nw_world) -> None:
    """K1 against the plain version on the card (and, at NW_CPU, on the
    CPU) on make_world's jobs; the times go into `record` if one is
    given."""
    import numpy as np
    import torch
    from hla_la_tpu_torch.ops.banded_nw import DEFAULT_SCORING as sc
    from hla_la_tpu_torch.ops.banded_nw import banded_nw_plain
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda

    reads, lens, refs = make_world(np.random.default_rng(B + L + W), B, L, W)
    host = [torch.from_numpy(a) for a in (reads, lens, refs)]
    args = tuple(t.cuda() for t in host) + (sc,)
    got = [t.cpu().numpy() for t in banded_nw_cuda(*args)]
    sync()
    others = {"plain on the card":
              [t.cpu().numpy() for t in banded_nw_plain(*args)]}
    sync()
    if (B, L, W) == NW_CPU:
        others["plain on the CPU"] = [t.numpy() for t in
                                      banded_nw_plain(*host, sc)]
    shape = f"B={B} L={L} W={W}"
    n_live, err = hold_nw("K1", shape, got, others)
    again = [t.cpu().numpy() for t in banded_nw_cuda(*args)]
    if not all(np.array_equal(a, b) for a, b in zip(got, again)):
        fail(f"K1 reruns at {shape} are not bit-identical")
    ms = cuda_ms(lambda: banded_nw_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: banded_nw_plain(*args), reps=1)
    gcells = B * L * W / (ms * 1e-3) / 1e9
    bound = nw_bound(B, L, W)
    print(f"K1 {shape}: bit-identical to the {' and '.join(others)} on "
          f"{n_live}/{B} live rows, and across reruns; kernel {ms:.4f} ms "
          f"({gcells:.2f} Gcells/s, {100 * bound['bound_ms'] / ms:.1f}% of "
          f"the {bound['bound_by']} bound {bound['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


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
          f"after the timed launches {mhz:.0f} MHz)")
    record.update(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                  read_parts=parts, **bound)
    if err64:
        record.update(max_abs_err_f64=err64["kernel"],
                      plain_max_abs_err_f64=err64["plain"])


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


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
    and read just after it.  Launches made in worker processes are read
    from the run's summed statistics ("worker_launches")."""
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
            "worker_launches": {
                k: int(n) for k, n in
                re.findall(r"worker_launches_(K\d): (\d+)", text)},
            "decoy_dropped_pairs": int(dropped.group(1)) if dropped else 0,
            "workers_ready": [
                tuple(float(x) for x in m) for m in re.findall(
                    r"alignment worker \d+ ready on \S+ ([0-9.]+) s after "
                    r"the pool was made: process start and imports "
                    r"([0-9.]+) s, package and aligner ([0-9.]+) s, device "
                    r"context ([0-9.]+) s", text)],
            "bestguess": read_table(os.path.join(hla, "R1_bestguess.txt")),
            "align_s": float(m_al.group(5)),
            "reads_per_s": float(m_al.group(6)),
            "pairs": int(m_al.group(2)), "unpaired": int(m_al.group(4)),
            "nw_jobs": nw_jobs, "type_s": float(m_ty.group(2)),
            "loci": {lc: (int(c), int(r)) for lc, c, r in loci}}


def run_action(action: str, device: str, world, out_dir: str) -> dict:
    """Run `action` (KIR or ASM) of the port's CLI on `world` and `device`;
    the kernels' launch counters are zeroed just before the run and read
    just after it.  Every NW job the typer made must have run on
    `device`."""
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", action, *world.cli_args(), "--sampleID", "S1",
            "--outputDirectory", out_dir, "--device", device]
    if action == "ASM":
        argv += ["--graph", world.graph]
    log, out = io.StringIO(), io.StringIO()
    kernels = {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
               "K3": pair_ll_diff_cuda}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, log)), \
            contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        rc = port_main(argv)
    if device == "cuda":
        sync()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    if rc != 0:
        fail(f"--action {action} on {device} failed (rc {rc})")
    m_jobs = re.search(r"n_chain_extensions: (\d+)", log.getvalue())
    m_dev = re.search(rf"nw_jobs_on_{device}: (\d+)", log.getvalue())
    if not (m_jobs and m_dev and int(m_jobs.group(1)) > 0
            and m_dev.group(1) == m_jobs.group(1)):
        fail(f"--action {action}: not every NW job ran on {device}")
    return {"dir": out_dir, "launches": launches, "wall_s": wall,
            "nw_jobs": int(m_jobs.group(1)), "stdout": out.getvalue()}


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
    a, b = got["bestguess"], want["bestguess"]
    if len(a) != len(b) or a[0] != b[0]:
        fail("bestguess tables differ in shape")
    q_err = 0.0
    for ra, rb in zip(a[1:], b[1:]):
        for i, (x, y) in enumerate(zip(ra, rb)):
            if i in (3, 4):
                q_err = max(q_err, abs(float(x) - float(y)))
            elif x != y:
                fail(f"bestguess column {a[0][i]} differs: {x} vs {y}")
    if q_err > Q_TOL:
        fail(f"Q1/Q2 differ by {q_err:.3g} > {Q_TOL}")
    return q_err


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
    workers = "short reads in 4 worker processes, phase (p)"
    ranks = "short reads on 4 ranks (--sharded 4), phase (q)"
    return {"nw": nw, "pair": pair, "nw_long": nw_long,
            "pair_long": {**pair, "path": long_},
            "nw_kir": {**nw, "path": kir}, "pair_kir": {**pair, "path": kir},
            "nw_asm": {**nw_long, "path": asm},
            "nw_workers": {**nw, "path": workers},
            "pair_workers": {**pair, "path": workers},
            "nw_sharded": {**nw, "path": ranks},
            "pair_sharded": {**pair, "path": ranks}}


def hla_phases(nw: dict, pair: dict, nw_long: dict, pair_long: dict) -> dict:
    """Phases (c)-(i): the kernels at --action HLA's shapes and its two
    main paths.  Returns the one-process cuda runs that later phases hold
    their many-process runs against: {"imgt": (world, run), "small": ...}."""
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.sim import (LONG_READ_LENGTH, long_read_world,
                                      typing_world)

    # (g) runs before (e): its plain versions' row loops take a minute of
    # the time the IMGT-scale world needs to be built
    phase("(c) K1 banded NW vs plain")
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

    phase("(e) end to end: the port's CLI on cuda, IMGT-scale world")
    world = built_world("typing_world")
    print(f"world: {world.graph}; planted {world.truth}")
    res = run_port("cuda", world, os.path.join(WORLD_DIR, "runs", "cuda"))
    check_launched(res, ("K1", "K3"))
    check_truth(res, world, C_MIN)
    print(f"calls hold the planted alleles: "
          f"{[r[:4] for r in res['bestguess'][1:]]}")
    report_run("port on cuda", res)
    nw["launches"] = res["launches"]["K1"]
    pair["launches"] = res["launches"]["K3"]
    one_process = {"imgt": (world, res)}
    sync()

    phase("(f) small world: the port's CLI on cuda vs on the CPU")
    small = typing_world(WORLD_DIR, **SMALL_WORLD)
    one_process["small"] = (small, compare_devices(small, "small")["cuda"])
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

    phase("(i) small long-read world: the port's CLI on cuda vs on the CPU")
    compare_devices(long_read_world(WORLD_DIR, **SMALL_LONG_WORLD),
                    "small long-read", exact=True)
    sync()
    return one_process


def kir_asm_phases(nw_kir: dict, pair_kir: dict, nw_asm: dict) -> None:
    """Phases (j)-(m): the kernels at the shapes of --action KIR and
    --action ASM, and those two main paths."""
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.models.asm import AssemblyTyper
    from hla_la_tpu_torch.models.kir_package import KirPackage
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
    res = run_action("KIR", "cuda", world_kir,
                     os.path.join(WORLD_DIR, "runs", "kir_cuda"))
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


def run_subprocess_cli(argv: list, tag: str) -> str:
    """The port's CLI in a process of its own (so that every rank's log is
    caught); returns its standard error."""
    proc = subprocess.run([sys.executable, "-m", "hla_la_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        fail(f"{tag}: exit code {proc.returncode}")
    return proc.stderr


def check_sharded_cli(world, one: dict, n_ranks: int, tag: str) -> dict:
    """``--sharded n_ranks`` on `world` against the one-process cuda run
    `one`: the same calls and coverage track, Q1/Q2 within Q_TOL; on every
    rank every NW job on a card and K1 and K3 launched.  Returns the
    launches of rank 0."""
    out_dir = os.path.join(WORLD_DIR, "runs", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    log = run_subprocess_cli(
        ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
         "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
         "cuda", "--sharded", str(n_ranks)], tag)
    wall = time.perf_counter() - t0
    jobs = [int(n) for n in re.findall(r"n_chain_extensions: (\d+)", log)]
    on_card = [int(n) for n in re.findall(r"nw_jobs_on_cuda: (\d+)", log)]
    if len(jobs) != n_ranks or jobs != on_card or jobs[0] != one["nw_jobs"]:
        fail(f"{tag}: NW jobs per rank {jobs}, on a card {on_card}, "
             f"one process {one['nw_jobs']}")
    launches = [dict((k, int(n)) for k, n in re.findall(r"(K\d) (\d+)", ln))
                for ln in re.findall(r"rank \d+: exit code 0, kernel "
                                     r"launches (.*)", log)]
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


def worker_phases(one_process: dict, rec: dict) -> None:
    """Phase (p): worker processes and align shards on the one card,
    against the one-process run of (e)."""
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.graph.package import GraphPackage
    from hla_la_tpu_torch.models.pipeline import (pair_up_fastq,
                                                  run_hla_typing)
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.utils.config import RunConfig, TyperConfig

    world, one = one_process["imgt"]
    runs = os.path.join(WORLD_DIR, "runs")

    phase("(p) --maxThreads 4 and align shards on cuda, IMGT-scale world")
    res = run_port("cuda", world, os.path.join(runs, "workers"),
                   ("--maxThreads", "4"))
    n = same_files(res["dir"], one["dir"], "--maxThreads 4")
    if res["worker_launches"].get("K1", 0) <= 0 or res["launches"]["K3"] <= 0:
        fail(f"--maxThreads 4: launches in the workers "
             f"{res['worker_launches']}, in the parent {res['launches']}")
    report_run("port on cuda, 4 workers", res)
    print(f"--maxThreads 4: {n} files byte-equal to the one-process run; "
          f"all {res['nw_jobs']} NW jobs on the card; K1 launches in the "
          f"workers {res['worker_launches']['K1']} (parent "
          f"{res['launches']['K1']}: the insert-size estimate); one process "
          f"vs 4 workers: align {one['align_s']:.3f} vs {res['align_s']:.3f} "
          f"s, type {one['type_s']:.3f} vs {res['type_s']:.3f} s, whole CLI "
          f"{one['wall_s']:.3f} vs {res['wall_s']:.3f} s")
    ready = res["workers_ready"]
    if len(ready) != 4:
        fail(f"--maxThreads 4: {len(ready)} workers reported ready")
    last = max(r[0] for r in ready)
    print(f"the 4 workers were ready {min(r[0] for r in ready):.1f}-"
          f"{last:.1f} s after the pool was made (process start and imports "
          f"{max(r[1] for r in ready):.1f} s, package, aligner and the "
          f"process's first CUDA call {max(r[2] for r in ready):.1f} s, "
          f"device context {max(r[3] for r in ready):.1f} s at most); the "
          f"{res['pairs']} pairs then took {res['align_s'] - last:.3f} s "
          f"({one['align_s'] / max(res['align_s'] - last, 1e-9):.2f} times "
          f"the one-process rate)")
    rec["nw_workers"]["launches"] = res["worker_launches"]["K1"]
    rec["pair_workers"].update({k: v for k, v in rec["pair"].items()
                                if k not in ("path", "launches")})
    # the workers' NW calls: a chunk of 256 pairs' jobs each
    check_nw(round(res["nw_jobs"] / res["worker_launches"]["K1"]), 101, 32,
             rec["nw_workers"])

    # the same run with the typing workers' gate lowered (two loci are
    # under its default): K3 is then launched in the workers
    log = io.StringIO()
    out_dir = os.path.join(runs, "typing_workers")
    shutil.rmtree(out_dir, ignore_errors=True)
    pair_ll_diff_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, log)):
        run_hla_typing(
            GraphPackage(world.graph),
            pairs=pair_up_fastq(world.fastq1, world.fastq2),
            output_dir=out_dir, device="cuda",
            cfg=RunConfig(max_threads=4, typer=TyperConfig(
                min_reads_for_typing_workers=1,
                min_loci_for_typing_workers=2)))
    wall = time.perf_counter() - t0
    same_files(out_dir, one["dir"], "typing workers")
    m = re.search(r"in typing workers: K3 (\d+)", log.getvalue())
    if not m or int(m.group(1)) <= 0 or pair_ll_diff_cuda.launches != 0:
        fail(f"typing workers: K3 launches in the workers "
             f"{m and m.group(1)}, in the parent {pair_ll_diff_cuda.launches}")
    rec["pair_workers"]["launches"] = int(m.group(1))
    print(f"typing workers: byte-equal to the one-process run; K3 launched "
          f"{m.group(1)} times in the workers, never in the parent; "
          f"run_hla_typing {wall:.3f} s")

    shard_dir = os.path.join(runs, "shards")
    shutil.rmtree(shard_dir, ignore_errors=True)
    walls = []
    for host in ("0", "1"):
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stderr(_Tee(sys.stderr, log)):
            rc = port_main(["--action", "HLA", *world.cli_args(), "--graph",
                            world.graph, "--sampleID", "S1",
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
    with contextlib.redirect_stderr(_Tee(sys.stderr, io.StringIO())):
        rc = port_main(["--action", "HLA", "--graph", world.graph,
                        "--sampleID", "S1", "--outputDirectory", merged,
                        "--device", "cuda", "--mergeShards", shard_dir])
    walls.append(time.perf_counter() - t0)
    if rc != 0:
        fail(f"--mergeShards: rc {rc}")
    n = same_files(merged, one["dir"], "shards + merge")
    print(f"--nHosts 2 + --mergeShards: {n} files byte-equal to the "
          f"one-process run; align shards {walls[0]:.3f} and {walls[1]:.3f} "
          f"s, merge and typing {walls[2]:.3f} s")
    sync()


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
    start_world_builds()
    try:
        one_process = hla_phases(rec["nw"], rec["pair"], rec["nw_long"],
                                 rec["pair_long"])
        kir_asm_phases(rec["nw_kir"], rec["pair_kir"], rec["nw_asm"])
    finally:
        stop_world_builds()
    flag_phases()
    worker_phases(one_process, rec)
    sharded_phases(one_process, rec)

    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rec.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
