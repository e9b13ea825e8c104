"""GPU health and kernel-correctness probe
(``python -m hla_la_tpu_torch.gpu_check``).

One answer to the question to settle before trusting any number of the card
or its NW path: do K1's scores and ends (the banded NW forward,
``csrc/banded_nw.cu``) bit-match its plain PyTorch version on a random ACGT
world with realistic suffix ref pads (N walls), here on the real card?  The
same contract the tests hold on the CPU.  Its rate is then measured with
CUDA events and reported beside a verdict, HEALTHY or DEGRADED.

Exit code 0 = parity (speed is reported, not asserted: a slow card is an
environment condition, not a code failure); 1 = a mismatch or no CUDA
device.  It never runs the plain version in the kernel's place.

``check`` is the comparison itself, for callers that bring their own jobs
(``chip_smoke.py`` phase (c) and the K1 checks of later phases).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .ops.banded_nw import DEFAULT_SCORING, banded_nw_plain
from .ops.cuda_nw import banded_nw_cuda

# the short-read main path's NW call: 65,536 jobs of 101 rows in a band of
# 32.  K1 took 0.391 ms there (542 Gcells/s) on an H100 80GB HBM3 at 700 W
# (PERF.md); below half of that rate the card is not computing at full speed
MAIN_SHAPE = (65536, 101, 32)
HEALTHY_GCELLS = 250.0
NAMES = ("score", "end_k", "end_state", "pointers")


def random_world(rng, B: int, L: int, W: int):
    """Random ACGT reads and refs, uneven read lengths, and a suffix N wall
    on every third ref."""
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    for b in range(0, B, 3):
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    lens = rng.integers(L // 4, L + 1, B).astype(np.int64)
    return reads, lens, refs


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches (CUDA events, after
    one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mismatch(got, others: dict) -> str | None:
    """None when `got` equals every version in `others` on the live rows
    (score > -1e29 in the first), else what differs."""
    live = next(iter(others.values()))[0] > -1e29
    for tag, other in others.items():
        for name, a, b in zip(NAMES, got, other):
            if not np.array_equal(a[live], b[live]):
                bad = np.nonzero((a[live] != b[live]).reshape(
                    int(live.sum()), -1).any(axis=1))[0]
                return (f"{name} differs from the {tag} on {len(bad)} live "
                        f"rows (first {bad[:5].tolist()})")
    return None


def check(reads: np.ndarray, lens: np.ndarray, refs: np.ndarray,
          sc: dict = DEFAULT_SCORING, cpu: bool = False,
          reps: int = 10) -> dict:
    """K1 on the card against its plain version on the card (and, with
    `cpu`, on the CPU): every output equal on the live rows, and a rerun
    bit-identical.  Returns {"parity", "why", "n_live", "max_abs_err",
    "ms", "plain_ms", "gcells"}; the times only where parity holds."""
    B, L = reads.shape
    W = refs.shape[1] - L
    host = [torch.from_numpy(a) for a in (reads, lens, refs)]
    args = tuple(t.cuda() for t in host) + (sc,)
    got = [t.cpu().numpy() for t in banded_nw_cuda(*args)]
    others = {"plain version on the card":
              [t.cpu().numpy() for t in banded_nw_plain(*args)]}
    if cpu:
        others["plain version on the CPU"] = [
            t.numpy() for t in banded_nw_plain(*host, sc)]
    first = next(iter(others.values()))
    live = first[0] > -1e29
    out = {"n_live": int(live.sum()), "others": list(others),
           "max_abs_err": float(np.abs(got[0][live] - first[0][live]).max(
               initial=0.0))}
    why = mismatch(got, others)
    if why is None:
        again = [t.cpu().numpy() for t in banded_nw_cuda(*args)]
        if not all(np.array_equal(a, b) for a, b in zip(got, again)):
            why = "a rerun is not bit-identical"
    out.update(parity=why is None, why=why)
    if why is None:
        ms = cuda_ms(lambda: banded_nw_cuda(*args), reps)
        out.update(ms=ms, gcells=B * L * W / (ms * 1e-3) / 1e9,
                   plain_ms=cuda_ms(lambda: banded_nw_plain(*args), 1))
    return out


def run(L: int = MAIN_SHAPE[1], W: int = MAIN_SHAPE[2],
        B: int = MAIN_SHAPE[0], seed: int = 7, reps: int = 10,
        stats: dict | None = None, world=random_world,
        cpu: bool = False) -> int:
    """K1 at B x L x W on `world(rng, B, L, W)`'s jobs (by default the
    main path's shape on random ACGT jobs); `stats`, if given, is filled
    with what `check` returns and, at MAIN_SHAPE, the verdict
    ("healthy")."""
    if not torch.cuda.is_available():
        print("# no CUDA device (torch.cuda.is_available() is False) — "
              "nothing to check", file=sys.stderr)
        return 1
    print(f"# device: {torch.cuda.get_device_name(0)}", file=sys.stderr,
          flush=True)
    res = check(*world(np.random.default_rng(seed), B, L, W), cpu=cpu,
                reps=reps)
    shape = f"B={B} L={L} W={W}"
    if stats is not None:
        stats.update(res)
    if not res["parity"]:
        print(f"PARITY FAIL: K1 at {shape}: {res['why']}")
        return 1
    verdict = ""
    if (B, L, W) == MAIN_SHAPE:
        healthy = res["gcells"] >= HEALTHY_GCELLS
        if stats is not None:
            stats["healthy"] = healthy
        verdict = (f" -> card {'HEALTHY' if healthy else 'DEGRADED'} "
                   f"(healthy from {HEALTHY_GCELLS:g})")
    print(f"K1 {shape}: bit-identical to the {' and '.join(res['others'])} "
          f"on {res['n_live']}/{B} live rows, and across reruns; kernel "
          f"{res['ms']:.4f} ms by CUDA events ({res['gcells']:.1f} "
          f"Gcells/s{verdict}), plain {res['plain_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(run())
