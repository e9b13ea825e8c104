#!/usr/bin/env python
"""Weak-scaling harness of the port's sharded compute step: the twin of
bench_scaling.py.

    python3 bench_scaling_torch.py [--ranks 1,2,4,8] [--device cuda|cpu]

Measures ``parallel/mesh.py::full_step`` (banded NW scoring of a read
batch on K1, split over "data"; the cluster x read likelihood product; the
C^2 pair reduction on K3 over data x model, summed by an all-reduce) on 1,
2, 4 and 8 ranks, each rank count one start of its ranks through
``parallel/launch.run_ranks``.  The work per data rank is held constant
(B0 = 512 reads of L = 128 at a band of 32, C = 256 clusters, K = 768
columns); the model axis follows from the rank count (``mesh.model_axis``:
2 from 4 ranks up, bench_scaling.py's rule).  Each rank count's result is
held to one device: its NW scores bit for bit to the forward of the whole
batch, its pair matrix within rtol 1e-6 / atol 1e-2 of the one-device
product and reduction.

Prints the card's name and power limit first, then one JSON line per rank
count: bench_scaling.py's keys (``devices`` is the rank count), plus
``cards``, ``ranks_per_card`` and ``backend``.  Ranks take card
rank % cards; where more ranks than cards share them (gloo, the
collectives crossing the host) the line says that the number measures the
mechanics of the step, not scaling across cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

B0, L, W = 512, 128, 32
C, K = 256, 768
RANK_COUNTS = (1, 2, 4, 8)
ITERS = 5
PAIR_RTOL, PAIR_ATOL = 1e-6, 1e-2


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def step_inputs(rng, n_data: int) -> tuple:
    """bench_scaling.py's inputs for `n_data` data ranks, drawn from `rng`
    in its order: reads, lengths, refs, one-hot clusters, contributions."""
    B = B0 * n_data
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    onehot = (rng.random((C, K)) < 0.17).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (B, K)).astype(np.float32)
    return reads, lens, refs, onehot, contrib


def one_device(device, reads, lens, refs, onehot, contrib) -> tuple:
    """The step's (scores, pair) on one device: the whole batch's forward,
    and the product and reduction of all clusters and reads."""
    import torch

    from hla_la_tpu_torch.device import resolve, to_device
    from hla_la_tpu_torch.ops.banded_nw import (DEFAULT_SCORING,
                                                banded_nw_forward_torch)
    from hla_la_tpu_torch.ops.pair_ll import pair_ll_reduction
    dev = resolve(device)
    scores = banded_nw_forward_torch(reads, lens, refs, DEFAULT_SCORING,
                                     dev)[0].cpu().numpy()
    ll = torch.matmul(to_device(onehot, dev), to_device(contrib, dev).T)
    return scores, pair_ll_reduction(ll.cpu().numpy(), dev)


def scaling(device, counts=RANK_COUNTS, seed: int = 0) -> list[dict]:
    """For each rank count of `counts`: the step on that many ranks, held
    to one device.  Returns one record per count, each with its inputs and
    the ranks' (scores, pair) under "inputs" and "out"."""
    import torch

    from hla_la_tpu_torch.parallel import launch, mesh
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    base_rate = None
    runs = []
    for n in counts:
        n_model = mesh.model_axis(n)
        n_data = n // n_model
        inputs = step_inputs(rng, n_data)
        got = launch.run_ranks(launch.rank_timed_full_step, n, device,
                               (L, W, *inputs, ITERS))
        (scores, pair), _, _ = got[0]
        want_scores, want_pair = one_device(device, *inputs)
        assert np.array_equal(scores, want_scores), \
            f"{n} ranks: NW scores differ from one device"
        err = float(np.abs(pair - want_pair).max())
        assert np.allclose(pair, want_pair, rtol=PAIR_RTOL, atol=PAIR_ATOL), \
            f"{n} ranks: pair differs from one device by {err:.4g}"
        # the slowest rank's mean iteration: the collectives end together
        dt = max(sum(secs) / len(secs) for _, secs, _ in got)
        B = B0 * n_data
        rate = B / dt
        base_rate = base_rate or rate
        shared = dev.type != "cuda" or n > cards
        rec = {"devices": n, "mesh": f"{n_data}x{n_model}",
               "platform": dev.type,
               "reads_per_sec": rate,
               "scaling_efficiency": rate / (base_rate * n),
               "total_speedup_vs_1dev": rate / base_rate,
               "cards": cards,
               "ranks_per_card": -(-n // cards) if cards else None,
               "backend": "nccl" if dev.type == "cuda" and n <= cards
               else "gloo",
               "step_s": dt, "pair_max_abs_err": err,
               "launches_per_rank": [lc for _, _, lc in got]}
        if shared:
            # ranks share a card (or the host's cores): the ideal outcome
            # of weak scaling is then a flat total rate, so the line
            # measures the step's mechanics, not scaling across cards
            rec["note"] = ("ranks share " + ("one card" if cards else
                                             "the host's cores")
                           + ": mechanics of the sharded step, not scaling "
                           "across cards")
            rec["physical_cores"] = os.cpu_count()
            rec["core_bound"] = dev.type != "cuda" and \
                n > (os.cpu_count() or 1)
        runs.append({**rec, "inputs": inputs, "out": (scores, pair)})
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default=",".join(map(str, RANK_COUNTS)))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from hla_la_tpu_torch import bench_common as bc
    from hla_la_tpu_torch.models.parallel_host import spawn_safe

    bc.start(args.device)
    assert spawn_safe(), "run_ranks needs a file-backed __main__"
    counts = tuple(int(x) for x in args.ranks.split(","))
    for run in scaling(args.device, counts):
        print(json.dumps({k: v for k, v in run.items()
                          if k not in ("inputs", "out")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
