"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero
and no result line is printed:

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
      reruns, at B x L x W = 128 x 16,384 x 256 (the long-read working
      point), 1,024 x 1,400 x 160 (W not a power of two), 256 x 500 x 100
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
      summary.txt and genePositions.tab equal, posterior within 1e-3.

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them is the kernels' JSON
record, one entry per kernel and main path (K1 and K2 run on two, K3 on
three), with the
launches of that path's run and the kernel's time beside its bound: the
larger of its bytes (inputs read once, outputs written once) over the card's
memory rate and its operations over the card's peak rate for their type.
Nothing here imports jax or the JAX package.
The worlds are cached under build/chip_smoke_world/.  One kernel alone:

    python -c "import chip_smoke as c; c.check_nw_long(128, 16384, 256, {})"
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
NW_LONG_SHAPES = ((128, 16384, 256), (1024, 1400, 160), (256, 500, 100),
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


def pair_bound(C: int, R: int, max_mhz: float) -> dict:
    """The least time the card could take for the pair reduction's
    C (C + 1) / 2 * R cells: L read and the output written once, against the
    float32 operations and against the two special-function results per
    cell at the card's top clock.  The latter is the larger by far."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cells = C * (C + 1) // 2 * R
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


def check_pair(C: int, R: int, record: dict) -> None:
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

    acc1, rpad = pair_ll_diff_cuda(Ld)
    acc2, _ = pair_ll_diff_cuda(Ld)
    sync()
    if not torch.equal(acc1, acc2):
        fail("K3 reruns are not bit-identical")
    got = full((acc1, rpad))
    plain = pair_ll_diff_plain(Ld)
    want = full(plain)
    sync()
    err = np.abs(got - want)
    if not np.allclose(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL):
        fail(f"K3 vs plain at C={C} R={R}: max abs err "
             f"{err.max():.4g} beyond rtol={PAIR_RTOL} atol={PAIR_ATOL}")
    if not np.array_equal(got, got.T):
        fail("K3 output is not symmetric")
    err64 = pair_f64_errors(L, {"kernel": (acc1, rpad), "plain": plain})
    ms = cuda_ms(lambda: pair_ll_diff_cuda(Ld), reps=5)
    mhz, max_mhz = sm_clocks_mhz()
    plain_ms = cuda_ms(lambda: pair_ll_diff_plain(Ld), reps=1)
    bound = pair_bound(C, R, max_mhz)
    gcells = C * (C + 1) // 2 * R / (ms * 1e-3) / 1e9
    # scratch floats = parts * tiles * 64 * 64 when the read range is cut
    n_tiles = -(-C // 64)
    parts = max(1, _build.library().lib.hla_pair_ll_scratch_floats(C, R)
                // (n_tiles * (n_tiles + 1) // 2 * 64 * 64))
    print(f"K3 C={C} R={R} (kernel pads to {rpad} and cuts the reads into "
          f"{parts} part(s), plain pads to {plain[1]}): within rtol={PAIR_RTOL} atol={PAIR_ATOL} of plain "
          f"(max abs err {err.max():.4g}), exactly symmetric, bit-identical "
          f"reruns; max |acc - float64| on {PAIR_F64_SAMPLES} sampled pairs: "
          f"kernel {err64['kernel']:.4g}, plain {err64['plain']:.4g}; kernel "
          f"{ms:.3f} ms ({gcells:.1f} Gcells/s over the C(C+1)/2 R live "
          f"cells), plain {plain_ms:.3f} ms; special-function bound "
          f"{bound['bound_ms']:.3f} ms at {max_mhz:.0f} MHz "
          f"({100 * bound['bound_ms'] / ms:.1f}% of it reached; SM clock "
          f"after the timed launches {mhz:.0f} MHz)")
    record.update(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                  max_abs_err_f64=err64["kernel"],
                  plain_max_abs_err_f64=err64["plain"], **bound)


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


def read_table(path: str) -> list[list[str]]:
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def run_port(device: str, world, out_dir: str) -> dict:
    """Type `world` with the port's CLI on `device`; the kernels' launch
    counters are zeroed just before the run and read just after it."""
    from hla_la_tpu_torch.cli import main as port_main
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
    from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", "HLA", *world.cli_args(), "--graph", world.graph,
            "--sampleID", "S1", "--outputDirectory", out_dir, "--device",
            device]
    log = io.StringIO()
    kernels = {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
               "K3": pair_ll_diff_cuda}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, log)):
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
    return {"dir": out_dir, "launches": launches, "wall_s": wall,
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


def compare_devices(world, tag: str, exact: bool = False) -> None:
    """The port's CLI on cuda against the port's CLI on the CPU; the cuda
    run's calls are held to the planted alleles as check_truth does."""
    runs = {dev: run_port(dev, world, os.path.join(WORLD_DIR, "runs",
                                                   f"{tag}_{dev}"))
            for dev in ("cuda", "cpu")}
    q_err = check_same_run(runs["cuda"], runs["cpu"])
    check_truth(runs["cuda"], world, 0, exact)
    print(f"{tag}: cuda and CPU runs agree (coverage track and calls "
          f"identical, max |dQ| {q_err:.3g}); cuda {runs['cuda']['wall_s']:.3f}"
          f" s, CPU {runs['cpu']['wall_s']:.3f} s")


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
    return {"nw": nw, "pair": pair, "nw_long": nw_long,
            "pair_long": {**pair, "path": long_},
            "nw_kir": {**nw, "path": kir}, "pair_kir": {**pair, "path": kir},
            "nw_asm": {**nw_long, "path": asm}}


def hla_phases(nw: dict, pair: dict, nw_long: dict, pair_long: dict) -> None:
    """Phases (c)-(i): the kernels at --action HLA's shapes and its two
    main paths."""
    from hla_la_tpu_torch.models.aligner import jobs_per_call
    from hla_la_tpu_torch.sim import (LONG_READ_LENGTH, long_read_world,
                                      typing_world)

    phase("(c) K1 banded NW vs plain")
    for shape in NW_SHAPES:
        check_nw(*shape, nw if shape == NW_SHAPES[0] else None)
    sync()

    phase("(d) K3 pair reduction vs plain")
    check_pair(PAIR_C, PAIR_R, pair)
    sync()

    phase("(e) end to end: the port's CLI on cuda, IMGT-scale world")
    t0 = time.perf_counter()
    world = typing_world(WORLD_DIR)
    print(f"world ready in {time.perf_counter() - t0:.1f} s: {world.graph}; "
          f"planted {world.truth}")
    res = run_port("cuda", world, os.path.join(WORLD_DIR, "runs", "cuda"))
    check_launched(res, ("K1", "K3"))
    check_truth(res, world, C_MIN)
    print(f"calls hold the planted alleles: "
          f"{[r[:4] for r in res['bestguess'][1:]]}")
    report_run("port on cuda", res)
    nw["launches"] = res["launches"]["K1"]
    pair["launches"] = res["launches"]["K3"]
    sync()

    phase("(f) small world: the port's CLI on cuda vs on the CPU")
    compare_devices(typing_world(WORLD_DIR, **SMALL_WORLD), "small")
    sync()

    phase("(g) K2 long-read banded NW vs plain")
    path_shape = (jobs_per_call(LONG_READ_LENGTH, LONG_W),
                  LONG_READ_LENGTH, LONG_W)
    for B, L, W in NW_LONG_SHAPES:
        check_nw_long(B, L, W, None)
    check_nw_long(*path_shape, nw_long)     # the shape (h) launches
    sync()

    phase("(h) end to end on long reads: the port's CLI on cuda")
    t0 = time.perf_counter()
    world = long_read_world(WORLD_DIR)
    print(f"world ready in {time.perf_counter() - t0:.1f} s: {world.graph}; "
          f"planted {world.truth}")
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
    t0 = time.perf_counter()
    world_kir = kir_world(WORLD_DIR)
    print(f"world ready in {time.perf_counter() - t0:.1f} s: "
          f"{world_kir.panel}; {world_kir.n_pairs} pairs from "
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
    hla_phases(rec["nw"], rec["pair"], rec["nw_long"], rec["pair_long"])
    kir_asm_phases(rec["nw_kir"], rec["pair_kir"], rec["nw_asm"])

    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rec.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
