"""The banded NW path of the port on one NVIDIA GPU, this checkout beside
another: the kernels K1 and K2, and the way their pointer tensor comes back
to the host.

    python3 bench_nw.py [--parent DIR] [--walls]

Run from the root of a checkout.  `DIR` is another checkout of this
repository that has the port (e.g. the parent commit unpacked by ``git
archive``).  Each tree runs in a process of its own, in the order parent,
this tree, this tree, parent, and prints

  - K1's and K2's time at the main paths' shapes (CUDA events over several
    launches after a warm-up, inputs from ``chip_smoke.nw_world``);
  - with ``--walls``, the align wall of the port's CLI on chip_smoke's
    long-read and short-read worlds (a warm-up run, then two).

Then, in this process, three ways to bring a tensor of the pointer tensor's
size back from the card, each with its allocation time, copy time and GB/s
on a first and a second call (the first pays for the pages): a fresh
pageable array per call (``tensor.cpu()``); one page-locked buffer sized to
the call, which is what ``ReadAligner`` keeps; and two page-locked buffers
of RING_BYTES through which the tensor goes in pieces into a reused
pageable array.  The card's name and power limit come first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (B, L, W) of the main paths' NW calls (short reads; long reads under the
# aligner's pointer budget) and of the long-read working point
MAIN_SHAPES = ((65536, 101, 32), (838, 10000, 256), (128, 16384, 256))
RING_BYTES = 64 << 20

# what a tree's own process runs: chip_smoke's recipe is the same in every
# tree that has the port
_CHILD = """
import json, os, sys
import numpy as np
import torch
import chip_smoke as c
import hla_la_tpu_torch
from hla_la_tpu_torch.ops.banded_nw import DEFAULT_SCORING as sc
from hla_la_tpu_torch.ops.cuda_nw import banded_nw_cuda
from hla_la_tpu_torch.ops.cuda_nw_long import banded_nw_long_cuda
from hla_la_tpu_torch.sim import long_read_world, typing_world
shapes, walls = json.loads(sys.argv[1])
res = {"package": os.path.dirname(hla_la_tpu_torch.__file__), "ms": {},
       "align_s": {}}
for B, L, W in shapes:
    rate = 0.002 if W <= 32 else 0.27 / (L + W)
    world = c.nw_world(np.random.default_rng(B + L + W), B, L, W, rate)
    args = tuple(torch.from_numpy(a).cuda() for a in world)
    fn = banded_nw_cuda if W <= 32 else banded_nw_long_cuda
    res["ms"][f"{B}x{L}x{W}"] = c.cuda_ms(lambda: fn(*args, sc), reps=10)
    del args
if walls:
    for tag, make in (("long", long_read_world), ("short", typing_world)):
        world = make(c.WORLD_DIR)
        out = os.path.join(c.WORLD_DIR, "runs", "bench_nw_" + tag)
        runs = [c.run_port("cuda", world, out)["align_s"] for _ in range(3)]
        res["align_s"][tag] = runs[1:]
print(json.dumps(res))
"""


def run_tree(tree: str, walls: bool) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps([MAIN_SHAPES, walls])],
        cwd=tree, check=True, stdout=subprocess.PIPE, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def ring_copy(flat, dest, ring) -> None:
    """Copy the CUDA bytes `flat` into the numpy bytes `dest` through the
    two page-locked buffers of `ring`, one piece in flight while the other
    is unloaded."""
    import torch
    n = flat.numel()
    pending: list = [None, None]    # (event, lo, hi) per ring slot

    def unload(slot):
        event, lo, hi = pending[slot]
        event.synchronize()
        dest[lo:hi] = ring[slot][:hi - lo].numpy()
        pending[slot] = None

    for p, lo in enumerate(range(0, n, RING_BYTES)):
        slot, hi = p % 2, min(n, lo + RING_BYTES)
        if pending[slot] is not None:
            unload(slot)
        ring[slot][:hi - lo].copy_(flat[lo:hi], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        pending[slot] = (event, lo, hi)
    for slot in (0, 1):
        if pending[slot] is not None:
            unload(slot)


def staging(B: int, L: int, W: int) -> None:
    import numpy as np
    import torch

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = B * (L + 1) * W
    gb = n / 1e9
    src = torch.randint(0, 16, (n,), dtype=torch.uint8, device="cuda")
    print(f"staging {B} x {L + 1} x {W}: {n / 1e6:.1f} MB")
    for call in (1, 2):
        s = wall(lambda: src.cpu())
        print(f"  fresh pageable, call {call}: copy {s * 1e3:.1f} ms "
              f"({gb / s:.2f} GB/s), no allocation of its own")
    held = {}
    s = wall(lambda: held.update(buf=torch.empty(n, dtype=torch.uint8,
                                                 pin_memory=True)))
    print(f"  page-locked: allocation {s * 1e3:.1f} ms")
    for call in (1, 2):
        s = wall(lambda: held["buf"].copy_(src, non_blocking=True))
        print(f"  page-locked, call {call}: copy {s * 1e3:.1f} ms "
              f"({gb / s:.2f} GB/s)")
    if not torch.equal(held.pop("buf"), src.cpu()):
        raise SystemExit("the page-locked copy differs from the tensor")
    s = wall(lambda: held.update(ring=[torch.empty(
        RING_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(2)]))
    print(f"  ring: allocation of 2 x {RING_BYTES >> 20} MiB "
          f"{s * 1e3:.1f} ms")
    dest = np.empty(n, np.uint8)
    for call in (1, 2):
        s = wall(lambda: ring_copy(src, dest, held["ring"]))
        print(f"  ring, call {call}: copy {s * 1e3:.1f} ms "
              f"({gb / s:.2f} GB/s)")
    if not np.array_equal(dest, src.cpu().numpy()):
        raise SystemExit("the ring copy differs from the tensor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_nw.py")
    ap.add_argument("--parent", help="a checkout to time beside this one")
    ap.add_argument("--walls", action="store_true",
                    help="also the CLI's align wall on chip_smoke's worlds")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [("this tree", here)]
    if args.parent:
        parent = ("parent", os.path.abspath(args.parent))
        trees = [parent, trees[0], trees[0], parent]
    for tag, tree in trees:
        res = run_tree(tree, args.walls)
        print(f"{tag} ({res['package']}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in res["ms"].items()), flush=True)
        for world, runs in res["align_s"].items():
            print(f"{tag}: {world}-read world, align wall "
                  + ", ".join(f"{s:.3f} s" for s in runs), flush=True)
    for B, L, W in MAIN_SHAPES[:2]:
        staging(B, L, W)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
