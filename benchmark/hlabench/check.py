"""The comparison that decides ``correct``, and its control.

The numbers that a cell's ``benchmark/limits/<cell>.json`` names, each
against its limit there; a named number with nothing captured to compare
fails, and so does captured work whose number the file leaves out:

- ``k1_jobs_differ``: of the K1 jobs drawn from the captured sample's
  launches, how many differ from the plain float32 forward in score, end
  cell, end state or any pointer row of the read (exact: limit 0);
- ``k2_jobs_differ``: the same for the K2 jobs drawn from the captured
  sample (one job of each of at most ``probes.K2_JOBS`` launches).  K1
  and K2 are held to one plain forward, ``reference.nw_forward_wide``,
  bit-equal in float32 to the step-by-step ``reference.nw_forward``;
- ``ll_rel_gap``: over the captured sample's cluster x read products (the
  typer's GEMM, whose output K3 reduces; clusters and reads drawn from the
  seed), the widest gap between the port's LL and mismatch entries and the
  float64 ones, over the largest magnitude of the latter; 1 where a
  one-hot row is not one-hot;
- ``k3_rel_gap``: over the captured sample's K3 launches, the widest gap
  between the port's difference term and the float64 one, over the
  largest magnitude of the latter;
- ``calls_wrong``: loci, over every sample of the window, whose called
  pair of allele clusters does not hold the two planted alleles (exact:
  limit 0).

The reference follows the port from its own state at three points: K1's
and K2's jobs are the windows the port's seeding chose, the GEMM's inputs
are the typer's per-read tensors and cluster one-hot, and K3's input is
the GEMM's output.  ``calls_wrong`` checks the whole path, from the reads
to the calls, against the planted alleles alone.
Imports nothing of the port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import reference

# each number, and the count of what it compared
COMPARED = {"k1_jobs_differ": "k1_jobs_compared",
            "k2_jobs_differ": "k2_jobs_compared",
            "ll_rel_gap": "ll_calls_compared",
            "k3_rel_gap": "k3_launches_compared",
            "calls_wrong": "loci_compared"}
NUMBERS = tuple(COMPARED)


def _k1_batches(k1: list[dict]) -> list[dict]:
    """The captured K1 jobs joined into one batch per (L, W, scoring):
    the reference's row loop costs the same for 64 jobs as for 64,000."""
    groups: dict = {}
    for cap in k1:
        key = (cap["reads"].shape[1], cap["refs"].shape[1],
               tuple(sorted(cap["scoring"].items())))
        groups.setdefault(key, []).append(cap)
    return [{k: (caps[0][k] if k == "scoring" else
                 np.concatenate([c[k] for c in caps]))
             for k in caps[0]} for caps in groups.values()]


def _k2_batches(k2: list[dict]) -> list[dict]:
    """The captured K2 jobs (live rows only) joined into one batch per (W,
    scoring), as K1's batches are: reads and refs padded with code 4 and
    pointer rows with 0 to the longest job's length.  Rows past a job's
    length change none of its outputs and are not compared."""
    groups: dict = {}
    for job in k2:
        W = len(job["refs"]) - job["len"]
        key = (W, tuple(sorted(job["scoring"].items())))
        groups.setdefault(key, []).append(job)
    out = []
    for (W, _), jobs in groups.items():
        B, L = len(jobs), max(j["len"] for j in jobs)
        cap = {"reads": np.full((B, L), 4, np.uint8),
               "refs": np.full((B, L + W), 4, np.uint8),
               "lens": np.array([j["len"] for j in jobs], np.int64),
               "scoring": jobs[0]["scoring"],
               "pointers": np.zeros((B, L + 1, W), np.uint8)}
        for k in ("score", "end_k", "end_state"):
            cap[k] = np.array([j[k] for j in jobs])
        for b, j in enumerate(jobs):
            cap["reads"][b, :j["len"]] = j["reads"]
            cap["refs"][b, :len(j["refs"])] = j["refs"]
            cap["pointers"][b, :j["len"] + 1] = j["pointers"]
        out.append(cap)
    return out


def nw_jobs_differ(batches: list[dict], judged: str | None = None
                   ) -> tuple[int, int]:
    """(jobs that differ, jobs compared) over K1's or K2's batches: the
    port's outputs against the plain forward in float32; with `judged` =
    "bfloat16" the reference in that precision is judged instead, in the
    port's place (the control)."""
    bad = total = 0
    for cap in batches:
        args = (cap["reads"], cap["lens"], cap["refs"], cap["scoring"])
        ref = reference.nw_forward_wide(*args)
        got = ((cap["score"], cap["end_k"], cap["end_state"],
                cap["pointers"]) if judged is None else
               reference.nw_forward_wide(*args, judged))
        differ = ((got[0] != ref[0]) | (got[1] != ref[1])
                  | (got[2] != ref[2]))
        rows = np.arange(ref[3].shape[1])[None, :, None]
        live = (rows >= 1) & (rows <= cap["lens"][:, None, None])
        differ |= ((got[3] != ref[3]) & live).any(axis=(1, 2))
        bad += int(differ.sum())
        total += len(differ)
    return bad, total


def k3_rel_gap(k3: list[dict], device="cpu", outputs=None) -> float:
    """The widest relative gap over the captured K3 launches; `outputs`:
    per launch the acc to judge, the port's by default."""
    gap = 0.0
    for n, cap in enumerate(k3):
        if cap["tile_range"] is not None:
            raise ValueError("a tile range is not compared")
        ref = reference.pair_diff(cap["L"], cap["rpad"], device=device)
        got = outputs[n] if outputs is not None else cap["acc"]
        scale = max(float(np.abs(ref).max()), 1e-30)
        gap = max(gap, float(np.abs(got.astype(np.float64) - ref).max())
                  / scale)
    return gap


def _onehot_ok(onehot: np.ndarray) -> bool:
    return bool(((onehot == 0) | (onehot == 1)).all()
                and (onehot.sum(axis=2) == 1).all())


def ll_rel_gap(ll: list[dict], device="cpu", outputs=None) -> float:
    """The widest relative gap over the captured GEMM calls, LL and MM
    each against its own largest magnitude; `outputs`: per call the (LL,
    MM) to judge, the port's by default."""
    gap = 0.0
    for n, cap in enumerate(ll):
        if not _onehot_ok(cap["onehot"]):
            gap = max(gap, 1.0)
        got = outputs[n] if outputs is not None else (cap["LL"], cap["MM"])
        for rows, g in zip((cap["contrib"], cap["mismatch"]), got):
            ref = reference.cluster_ll(cap["onehot"], rows, device)
            scale = max(float(np.abs(ref).max()), 1e-30)
            gap = max(gap, float(np.abs(np.asarray(g, np.float64)
                                        - ref).max()) / scale)
    return gap


def calls_wrong(calls: list[dict]) -> int:
    """`calls`: per sample {"truth": {locus: [a1, a2]}, "called": {locus:
    [cluster1, cluster2]}}, a cluster as its ';'-joined allele names."""
    wrong = 0
    for s in calls:
        for locus, (a1, a2) in s["truth"].items():
            got = s["called"].get(locus)
            if got is None:
                wrong += 1
                continue
            c1, c2 = (set(x.split(";")) for x in got)
            if not ((a1 in c1 and a2 in c2) or (a2 in c1 and a1 in c2)):
                wrong += 1
    return wrong


def numbers(k1, k3, calls, device="cpu", ll=(), k2=()) -> dict:
    """Every number and what it compared; ``k2_reference_s``: the wall
    seconds of K2's reference."""
    bad, total = nw_jobs_differ(_k1_batches(k1))
    t0 = time.perf_counter()
    bad2, total2 = nw_jobs_differ(_k2_batches(k2))
    return {"k1_jobs_differ": bad, "k1_jobs_compared": total,
            "k2_jobs_differ": bad2, "k2_jobs_compared": total2,
            "k2_reference_s": time.perf_counter() - t0,
            "ll_calls_compared": len(ll),
            "ll_rel_gap": ll_rel_gap(ll, device),
            "k3_launches_compared": len(k3),
            "k3_rel_gap": k3_rel_gap(k3, device),
            "calls_wrong": calls_wrong(calls),
            "loci_compared": sum(len(s["truth"]) for s in calls)}


def control(k1, k3, calls, device="cpu", ll=(), k2=()) -> dict:
    """The numbers that the reference reads when it is put in the port's
    place on the same captured inputs, one precision step below the
    port's: bfloat16 for K1, K2 and K3, TF32 for the GEMM.  It does not
    decode, so ``calls_wrong`` is the port's."""
    k3_out = [reference.pair_diff(c["L"], c["rpad"], device=device,
                                  dtype=torch.bfloat16) for c in k3]
    ll_out = [tuple(reference.cluster_ll(c["onehot"], rows, device, "tf32")
                    for rows in (c["contrib"], c["mismatch"])) for c in ll]
    bad, total = nw_jobs_differ(_k1_batches(k1), judged="bfloat16")
    bad2, total2 = nw_jobs_differ(_k2_batches(k2), judged="bfloat16")
    return {"k1_jobs_differ": bad, "k1_jobs_compared": total,
            "k2_jobs_differ": bad2, "k2_jobs_compared": total2,
            "ll_calls_compared": len(ll),
            "ll_rel_gap": ll_rel_gap(ll, device, outputs=ll_out),
            "k3_launches_compared": len(k3),
            "k3_rel_gap": k3_rel_gap(k3, device, outputs=k3_out),
            "calls_wrong": calls_wrong(calls),
            "loci_compared": sum(len(s["truth"]) for s in calls)}


def judge(found: dict, limits: dict) -> tuple[bool, list[tuple]]:
    """(every number that `limits` names within its limit, [(name, value,
    limit)] in NUMBERS' order).  A named number without captured work
    fails: nothing was compared.  So does captured work whose number
    `limits` leaves out: what the window ran goes unjudged."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise ValueError(f"limits name unknown numbers: {sorted(unknown)}")
    rows = [(name, found[name], limits[name]) for name in NUMBERS
            if name in limits]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    ok &= all((found[COMPARED[name]] > 0) == (name in limits)
              for name in NUMBERS)
    return ok, rows
