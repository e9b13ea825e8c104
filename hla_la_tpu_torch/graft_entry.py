"""Compile-check and many-device dry-run entry points of the port: the
counterparts of ``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``.

``entry(device)`` returns the flagship typing step as one function with
example arguments: the banded NW scores of a read batch (K1 on a card), the
cluster x read likelihood product, the C x C diploid pair reduction (K3 on a
card, plus the rank-1 term through ``ops.pair_ll.pair_ll_assemble``, which
``pair_ll_reduction`` calls too) and the pair posterior's per-cluster
marginal.

``dryrun_multichip(n, device)`` runs n ranks of a data x model mesh
(``parallel.launch.run_ranks``; gloo on the CPU, or every rank on the one
card) and holds three phases in that one start of the ranks: the whole
sharded step at load-bearing shapes, the sharded typing step's pair matrix
and marginal against the host formula, and a miniature end-to-end typing
run whose calls on n ranks must equal those of one rank.

    python -m hla_la_tpu_torch.graft_entry [n_ranks] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve, to_device
from .ops.banded_nw import DEFAULT_SCORING, banded_nw_forward_torch
from .ops.pair_ll import _pair_ll_diff, pair_ll_assemble

# the entry's example shapes: reads x read length x band, clusters x reads x
# typed columns (__graft_entry__.py:14-15)
ENTRY_SHAPES = {"B": 256, "L": 128, "W": 32, "C": 128, "R": 256, "K": 768}
# the dry run's miniature world: >= 2,000 pairs, 4 loci of 96 alleles, so
# that the model axis shards C non-trivially (__graft_entry__.py:122-133)
DRYRUN_GENES = {"A": (0.06, 0.14), "B": (0.30, 0.38), "C": (0.55, 0.63),
                "DQA1": (0.80, 0.88)}
DRYRUN_MIN_PAIRS = 2000
DRYRUN_MIN_CLUSTERS = 64
Q1_TOL = 1e-3
MARG_TOL = 1e-4
PAIR_TOL = 1e-3


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): fn(reads, lens, refs, onehot, contrib) -> (scores
    [B], pair [C, C], marg [C]) on `device`; the example arguments are numpy
    arrays drawn as ``__graft_entry__.entry`` draws them, and fn moves its
    arguments to `device` itself.  The marginal is the ordered formula of
    the reference entry (the full C x C posterior, diagonal once)."""
    dev = resolve(device)
    s = ENTRY_SHAPES
    B, L, W, C, R, K = (s[k] for k in "BLWCRK")

    def fn(reads, lens, refs, onehot, contrib):
        scores = banded_nw_forward_torch(reads, lens, refs, DEFAULT_SCORING,
                                         dev)[0]
        ll = torch.matmul(to_device(onehot, dev), to_device(contrib, dev).T)
        acc, rpad = _pair_ll_diff(ll.contiguous())
        pair = pair_ll_assemble(acc.to(torch.float64), rpad,
                                ll.to(torch.float64).sum(dim=1))
        post = torch.exp(pair - pair.max())
        post = post / post.sum()
        marg = post.sum(dim=1) + post.sum(dim=0) - torch.diagonal(post)
        return scores, pair, marg

    rng = np.random.default_rng(0)
    example_args = (
        rng.integers(0, 4, (B, L)).astype(np.uint8),
        np.full(B, L, dtype=np.int64),
        rng.integers(0, 4, (B, L + W)).astype(np.uint8),
        (rng.random((C, K)) < 0.17).astype(np.float32),
        rng.normal(-1.0, 0.5, (R, K)).astype(np.float32),
    )
    return fn, example_args


def host_marginal(pair: np.ndarray) -> np.ndarray:
    """The host formula (the typer's): softmax over the unordered pairs
    (upper triangle with the diagonal), a cluster's marginal the mass of
    every pair that holds it."""
    C = pair.shape[0]
    iu = np.triu_indices(C)
    P = np.exp(pair[iu] - pair[iu].max())
    P /= P.sum()
    marg = np.zeros(C)
    np.add.at(marg, iu[0], P)
    sec = iu[1] != iu[0]
    np.add.at(marg, iu[1][sec], P[sec])
    return marg


def _kernel_step_inputs(n_data: int, n_model: int) -> dict:
    """The dry run's load-bearing shapes: the model axis shards a
    non-trivial C, the data axis a non-trivial read batch."""
    B, L, W = 128 * n_data, 16, 8
    C, R, K = 32 * n_model, 64 * n_data, 96
    rng = np.random.default_rng(1)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, dtype=np.int64)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    onehot = (rng.random((C, K)) < 0.2).astype(np.float32)
    contrib = rng.normal(-1, 0.5, (R, K)).astype(np.float32)
    return {"L": L, "W": W, "reads": reads, "lens": lens, "refs": refs,
            "onehot": onehot, "contrib": contrib}


def _miniature_world(out_dir: str):
    """(package directory, read pairs) of the dry run's end-to-end phase."""
    from .sim.graph_sim import simulate_prg_package
    from .sim.read_sim import ReadSimulator
    rng = np.random.default_rng(7)
    sim = simulate_prg_package(rng, backbone_length=5000, n_haplotypes=4,
                               genes=DRYRUN_GENES, n_gene_alleles=96)
    pkg = sim.write_package(os.path.join(out_dir, "pkg"))
    rs = ReadSimulator(rng, read_length=80, fragment_mean=260,
                       fragment_sd=22, with_error=True)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 33.0,
                                               name_prefix=f"h{h}")
    assert len(pairs) >= DRYRUN_MIN_PAIRS, len(pairs)
    return pkg.dir, [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]


def _calls(res) -> list:
    return sorted((r.locus, r.allele1_id, r.allele2_id)
                  for r in res.results)


def _dryrun_rank(m, step_in: dict, pkg_dir: str, pairs: list,
                 out_dir: str) -> dict:
    """The three phases on one rank of mesh `m`; rank 0 also types the
    miniature world on one device and returns what the caller prints."""
    from .graph.package import GraphPackage
    from .models.pipeline import run_hla_typing
    from .parallel.mesh import full_step, sharded_typing_step

    out = {"mesh": dict(m.shape)}
    t0 = time.time()
    L, W = step_in["L"], step_in["W"]
    args = [step_in[k] for k in ("reads", "lens", "refs", "onehot",
                                 "contrib")]
    scores, pair = full_step(m, L, W)(*args)
    out["kernel_step_s"] = time.time() - t0
    B, C = len(args[0]), len(args[3])
    assert scores.shape == (B,), scores.shape
    assert pair.shape == (C, C), pair.shape
    assert np.isfinite(pair).all()
    out["shapes"] = (B, C, len(args[4]))

    # the marginal must match the host formula
    onehot, contrib = step_in["onehot"], step_in["contrib"]
    pair2, marg = sharded_typing_step(m)(onehot, contrib)
    ll = onehot @ contrib.T
    a, b = ll[:, None, :], ll[None, :, :]
    d = np.abs(a - b)
    pair_ref = (np.maximum(a, b) + np.log1p(np.exp(-d))
                + np.log(0.5)).sum(axis=2)
    assert np.allclose(pair2, pair_ref, atol=PAIR_TOL), \
        float(np.abs(pair2 - pair_ref).max())
    marg_ref = host_marginal(pair_ref)
    assert np.allclose(marg, marg_ref, atol=MARG_TOL), "marginal mismatch"
    out["pair_err"] = float(np.abs(pair2 - pair_ref).max())
    out["marg_err"] = float(np.abs(marg - marg_ref).max())

    # the miniature end to end: n ranks against one
    pkg = GraphPackage(pkg_dir)
    t0 = time.time()
    res_sh = run_hla_typing(pkg, pairs=pairs,
                            output_dir=os.path.join(out_dir, "sharded"),
                            sharded=m)
    out["t_sharded"] = time.time() - t0
    if m.rank != 0:
        return out
    t0 = time.time()
    res_ref = run_hla_typing(pkg, pairs=pairs,
                             output_dir=os.path.join(out_dir, "one"),
                             device=m.device)
    out["t_one"] = time.time() - t0
    calls_ref, calls_sh = _calls(res_ref), _calls(res_sh)
    assert calls_ref == calls_sh, \
        f"1-rank vs {m.shape} calls differ: {calls_ref} vs {calls_sh}"
    by_locus = {r.locus: r for r in res_ref.results}
    out["q1_err"] = 0.0
    for r in res_sh.results:
        q = by_locus[r.locus]
        for x, y in ((r.q1_allele1, q.q1_allele1),
                     (r.q1_allele2, q.q1_allele2)):
            assert abs(x - y) < Q1_TOL, (r.locus, x, y)
            out["q1_err"] = max(out["q1_err"], abs(x - y))
    n_clusters = {r.locus: r.n_clusters for r in res_sh.results}
    assert len(res_sh.results) >= len(DRYRUN_GENES), n_clusters
    assert all(c >= DRYRUN_MIN_CLUSTERS for c in n_clusters.values()), \
        n_clusters
    out.update(calls=calls_sh, n_clusters=n_clusters)
    return out


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """The three dry-run phases on `n_ranks` ranks in one start of them:
    the sharded kernel step (``parallel.mesh.full_step``), the sharded typing
    step's pair matrix within PAIR_TOL and its marginal within MARG_TOL of
    the host formula, and the miniature world typed on the n ranks with the
    calls of one rank and Q1 within Q1_TOL.  The model axis is 2 for an
    even count of at least 4, else 1 (``mesh.model_axis``).  `device`:
    "cuda" puts every rank on the one card, "cpu" runs them on gloo.
    Raises if any check fails; returns rank 0's record and prints the
    reference's ``dryrun phase`` lines."""
    from .parallel import launch
    from .parallel.mesh import model_axis

    n_model = model_axis(n_ranks)
    n_data = n_ranks // n_model
    step_in = _kernel_step_inputs(n_data, n_model)
    with tempfile.TemporaryDirectory(prefix="hla_dryrun_") as td:
        t0 = time.time()
        pkg_dir, pairs = _miniature_world(td)
        t_world = time.time() - t0
        got = launch.run_ranks(_dryrun_rank, n_ranks, device,
                               (step_in, pkg_dir, pairs, td))
    rec = got[0]
    if rec["mesh"] != {"data": n_data, "model": n_model}:
        raise AssertionError(f"mesh {rec['mesh']}, want {n_data} x "
                             f"{n_model}")
    B, C, R = rec["shapes"]
    print(f"dryrun phase kernel-step (B={B}, C={C}, R={R}, {n_data}x"
          f"{n_model} mesh): {rec['kernel_step_s']:.1f}s", flush=True)
    print(f"dryrun phase typing-step: pair within {PAIR_TOL} (max abs err "
          f"{rec['pair_err']:.3g}), marginal within {MARG_TOL} of the host "
          f"formula (max abs err {rec['marg_err']:.3g})", flush=True)
    print(f"dryrun phase e2e: one rank {rec['t_one']:.1f}s / sharded "
          f"{rec['t_sharded']:.1f}s ({len(pairs)} pairs, "
          f"{len(rec['n_clusters'])} loci, clusters {rec['n_clusters']}; "
          f"world built in {t_world:.1f}s)", flush=True)
    print(f"dryrun_multichip: e2e calls identical on 1 vs {n_ranks} ranks: "
          f"{rec['calls']}", flush=True)
    rec["n_pairs"] = len(pairs)
    return rec


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    dryrun_multichip(int(argv[0]) if argv else 2, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
