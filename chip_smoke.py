"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure exits non-zero
and no result line is printed:

  (a) toolchain: torch, CUDA, nvcc, and the card's name and power limit;
  (b) build: compile the kernels from hla_la_tpu_torch/csrc with nvcc;
  (c) K1, the banded NW forward, against its plain PyTorch version on the
      card (and, at the smaller batch, on the CPU), bit-identical on live
      rows, at L = 101, W = 32, B = 65,536 and 4,096;
  (d) K3, the pair-likelihood difference term, against its plain version at
      C = 2,200 clusters x R = 16,460 reads (the e2e world's locus A shape,
      not a multiple of the kernel's read chunk), rtol 1e-6 and atol 1e-2 on
      the full pair log-likelihood, and bit-identical across reruns;
  (e) end to end: an IMGT-scale two-locus world (stress_imgt.py's recipe:
      2,200 alleles per locus, 1,250x targeted coverage) typed by the port's
      CLI (``--action HLA --device cuda``).  The main path must launch K1 and
      K3; the calls must hold the planted alleles with Q1 > 0.9 at C >= 2,000
      clusters per locus, and the full pair dump must be written;
  (f) reference on a small world (60 alleles per locus, 40x): the port's CLI
      on cuda against the port's CLI on the CPU, whose plain kernels the
      tests hold to the JAX package.  Identical coverage track and calls,
      Q1/Q2 within 1e-3.

The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}; the line before them is the kernels' JSON
record.  Nothing here imports jax or the JAX package.  The worlds are
cached under build/chip_smoke_world/.
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

sys.modules["jax"] = None           # any import of jax now fails loudly

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD_DIR = os.path.join(ROOT, "build", "chip_smoke_world")
NW_L, NW_W = 101, 32
NW_BATCHES = (65536, 4096)
NW_CPU_B = 4096                 # batch also held against the CPU version
PAIR_C, PAIR_R = 2200, 16460
PAIR_RTOL, PAIR_ATOL = 1e-6, 1e-2
Q_TOL = 1e-3
Q1_MIN, C_MIN = 0.9, 2000       # stress_imgt.py's checks at IMGT scale
SMALL_WORLD = {"n_alleles": 60, "coverage": 40.0}


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


def nw_world(rng, B: int, L: int, W: int):
    """Alignable reads cut from random refs with substitutions and indels,
    plus N bases in reads and refs, suffix ref pads, uneven lengths and
    one empty read."""
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
    refs[rng.random((B, L + W)) < 0.002] = 4               # N in refs
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    lens[rng.random(B) < 0.5] = L
    lens[0] = 0
    for b in range(0, B, 7):                               # suffix pads
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    reads[col >= lens[:, None]] = 4                        # pad past len
    return reads, lens, refs


def check_nw(B: int, record: dict) -> None:
    import numpy as np
    import torch
    from hla_la_tpu_torch.ops.banded_nw import DEFAULT_SCORING as sc
    from hla_la_tpu_torch.ops.banded_nw import banded_nw_plain
    from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda

    reads, lens, refs = nw_world(np.random.default_rng(B), B, NW_L, NW_W)
    host = [torch.from_numpy(a) for a in (reads, lens, refs)]
    args = tuple(t.cuda() for t in host) + (sc,)
    got = [t.cpu().numpy() for t in banded_nw_cuda(*args)]
    sync()
    others = {"plain on the card":
              [t.cpu().numpy() for t in banded_nw_plain(*args)]}
    sync()
    if B == NW_CPU_B:
        others["plain on the CPU"] = [t.numpy() for t in
                                      banded_nw_plain(*host, sc)]
    live = others["plain on the card"][0] > -1e29
    names = ("score", "end_k", "end_state", "pointers")
    for tag, other in others.items():
        for name, a, b in zip(names, got, other):
            if not np.array_equal(a[live], b[live]):
                bad = np.nonzero((a[live] != b[live]).reshape(
                    int(live.sum()), -1).any(axis=1))[0]
                fail(f"K1 vs {tag} at B={B}: {name} differs on "
                     f"{len(bad)} live rows (first {bad[:5].tolist()})")
    err = float(np.abs(got[0][live] - others["plain on the card"][0][live]
                       ).max())
    ms = cuda_ms(lambda: banded_nw_cuda(*args), reps=10)
    plain_ms = cuda_ms(lambda: banded_nw_plain(*args), reps=1)
    gcells = B * NW_L * NW_W / (ms * 1e-3) / 1e9
    print(f"K1 B={B} L={NW_L} W={NW_W}: bit-identical to the "
          f"{' and '.join(others)} on {int(live.sum())}/{B} live rows; "
          f"kernel {ms:.4f} ms ({gcells:.2f} Gcells/s), plain {plain_ms:.4f} "
          f"ms")
    if B == NW_BATCHES[0]:
        record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_pair(record: dict) -> None:
    import numpy as np
    import torch
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda
    from hla_la_tpu_torch.ops.pair_ll import LOG_HALF, pair_ll_diff_plain

    L = np.random.default_rng(0).normal(-40.0, 8.0, (PAIR_C, PAIR_R)
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
        fail(f"K3 vs plain at C={PAIR_C} R={PAIR_R}: max abs err "
             f"{err.max():.4g} beyond rtol={PAIR_RTOL} atol={PAIR_ATOL}")
    if not np.array_equal(got, got.T):
        fail("K3 output is not symmetric")
    ms = cuda_ms(lambda: pair_ll_diff_cuda(Ld), reps=3)
    plain_ms = cuda_ms(lambda: pair_ll_diff_plain(Ld), reps=1)
    gcells = PAIR_C * PAIR_C * PAIR_R / (ms * 1e-3) / 1e9
    print(f"K3 C={PAIR_C} R={PAIR_R} (kernel pads to {rpad}, plain to "
          f"{plain[1]}): within rtol={PAIR_RTOL} atol={PAIR_ATOL} of plain "
          f"(max abs err {err.max():.4g}), bit-identical reruns; kernel "
          f"{ms:.3f} ms ({gcells:.1f} Gcells/s over the full C^2 R), plain "
          f"{plain_ms:.3f} ms")
    record.update(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms)


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
    from hla_la_tpu_torch.ops.cuda_pair import pair_ll_diff_cuda

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--action", "HLA", "--FASTQ1", world.fastq1, "--FASTQ2",
            world.fastq2, "--graph", world.graph, "--sampleID", "S1",
            "--outputDirectory", out_dir, "--device", device]
    log = io.StringIO()
    banded_nw_cuda.launches = 0
    pair_ll_diff_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, log)):
        rc = port_main(argv)
    if device == "cuda":
        sync()
    wall = time.perf_counter() - t0
    launches = {"K1": banded_nw_cuda.launches, "K3": pair_ll_diff_cuda.launches}
    if rc != 0:
        fail(f"port run on {device} failed (rc {rc})")
    text = log.getvalue()
    m_al = re.search(r"aligned (\d+)/(\d+) pairs .* in ([0-9.]+) s on "
                     r"\S+ \(([0-9.]+) reads/s\)", text)
    m_ty = re.search(r"typed (\d+) loci in ([0-9.]+) s", text)
    loci = re.findall(r"  (\S+): (\d+) clusters x (\d+) reads", text)
    if not (m_al and m_ty and loci):
        fail("port log lacks the align/type timing lines")
    hla = os.path.join(out_dir, "hla")
    return {"dir": out_dir, "launches": launches, "wall_s": wall,
            "bestguess": read_table(os.path.join(hla, "R1_bestguess.txt")),
            "align_s": float(m_al.group(3)),
            "reads_per_s": float(m_al.group(4)),
            "pairs": int(m_al.group(2)), "type_s": float(m_ty.group(2)),
            "loci": {lc: (int(c), int(r)) for lc, c, r in loci}}


def check_truth(res: dict, world, c_min: int) -> None:
    """stress_imgt.py's checks: each planted allele is in a called cluster
    of its locus, Q1 > 0.9, at least `c_min` clusters, and the pair dump
    holds all C(C+1)/2 pairs."""
    rows = res["bestguess"][1:]
    for locus, planted in world.truth.items():
        mine = [r for r in rows if r[0] == locus]
        if len(mine) != 2:
            fail(f"locus {locus}: {len(mine)} bestguess rows")
        called = [set(r[2].split(";")) for r in mine]
        for allele in planted:
            if not any(allele in c for c in called):
                fail(f"locus {locus}: planted {allele} not called "
                     f"({[r[2][:40] for r in mine]})")
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
    from hla_la_tpu_torch.sim import typing_world
    resolve("cuda")

    phase("(a) toolchain")
    smi = toolchain()

    phase("(b) build")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {lib.path} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_s:.1f} s)")
    print(lib.log.strip())

    nw = {"name": "banded_nw", "route": "cuda",
          "source": "hla_la_tpu_torch/csrc/banded_nw.cu",
          "replaces": "hla_la_tpu/ops/pallas_nw.py:31"}
    pair = {"name": "pair_ll_diff", "route": "cuda",
            "source": "hla_la_tpu_torch/csrc/pair_ll.cu",
            "replaces": "hla_la_tpu/ops/pallas_pair.py:100"}

    phase("(c) K1 banded NW vs plain")
    for B in NW_BATCHES:
        check_nw(B, nw)
    sync()

    phase("(d) K3 pair reduction vs plain")
    check_pair(pair)
    sync()

    phase("(e) end to end: the port's CLI on cuda, IMGT-scale world")
    t0 = time.perf_counter()
    world = typing_world(WORLD_DIR)
    print(f"world ready in {time.perf_counter() - t0:.1f} s: {world.graph}; "
          f"planted {world.truth}")
    res = run_port("cuda", world, os.path.join(WORLD_DIR, "runs", "cuda"))
    for k, n in res["launches"].items():
        if n <= 0:
            fail(f"the main path never launched {k}")
    check_truth(res, world, C_MIN)
    print(f"calls hold the planted alleles: "
          f"{[r[:4] for r in res['bestguess'][1:]]}")
    for lc, (c, r) in res["loci"].items():
        print(f"locus {lc}: C={c} clusters x R={r} reads")
    print(f"port on cuda: align {res['align_s']:.3f} s "
          f"({res['reads_per_s']:.1f} reads/s, {res['pairs']} pairs), "
          f"type {res['type_s']:.3f} s, whole CLI {res['wall_s']:.3f} s; "
          f"launches {res['launches']}")
    nw["launches"] = res["launches"]["K1"]
    pair["launches"] = res["launches"]["K3"]
    sync()

    phase("(f) small world: the port's CLI on cuda vs on the CPU")
    small = typing_world(WORLD_DIR, **SMALL_WORLD)
    runs = {dev: run_port(dev, small, os.path.join(WORLD_DIR, "runs",
                                                   f"small_{dev}"))
            for dev in ("cuda", "cpu")}
    q_err = check_same_run(runs["cuda"], runs["cpu"])
    check_truth(runs["cuda"], small, 0)
    print(f"small world: cuda and CPU runs agree (coverage track and calls "
          f"identical, max |dQ| {q_err:.3g}); cuda {runs['cuda']['wall_s']:.3f}"
          f" s, CPU {runs['cpu']['wall_s']:.3f} s")
    sync()

    print(json.dumps({"kernels": [nw, pair]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
