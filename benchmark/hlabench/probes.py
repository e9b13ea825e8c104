"""Stand-ins for the port's kernel wrappers, put where the port looks them
up; the benchmark's own span around each launch, with no program edit.

``Probes`` replaces K1's, K2's and K3's CUDA wrappers (``ops/cuda_nw.py::
banded_nw_cuda``, ``ops/cuda_nw_long.py::banded_nw_long_cuda``,
``ops/cuda_pair.py::pair_ll_diff_cuda``), their plain versions
(``ops/banded_nw.py::banded_nw_plain``, the one plain version of K1 and K2,
and ``ops/pair_ll.py::pair_ll_diff_plain``) and the typer's cluster x read
products (``ops/pair_ll.py::cluster_read_ll``, the GEMM whose output K3
reduces) in every module that names them at call time.  The device server
looks its wrappers up in their modules at each request and runs NW through
``ops/banded_nw.py``, so the probes see the launches it makes for worker
processes too.  A probe calls the original and:

- while ``timing`` is on, keeps each launch's shape and the (start, end)
  CUDA events that the wrapper's own ``.events`` hook records around the
  launch.  The wrapper reads ``.launches``, ``.largest`` and ``.events``
  off the module's name, which is now the probe, so the port's counters
  and the device server's per-request timing run as before;
- while a ``Capture`` is set, copies to the host the inputs and outputs of
  jobs drawn from the run's seed (K1, K2), of clusters and reads drawn from
  it in a sample's first calls (the GEMM) or of the whole launch (K3), for
  the comparison with the plain reference after the window.

On the CPU both NW widths go through ``banded_nw_plain``: its probe files a
call under K1 or K2 by its band, as ``banded_nw_forward_torch`` sends it to
one kernel or the other on a card.
"""

from __future__ import annotations

import numpy as np

_ABSENT = object()


# K1 jobs compared per launch: a 128th of the launch, at least 64
K1_JOBS_MIN, K1_JOBS_SHARE = 64, 128
# GEMM entries compared per call, and calls per sample: clusters x reads
# drawn from the seed, so that the copies stay small inside the window
LL_ROWS, LL_READS, LL_CALLS = 128, 64, 6
# K2 jobs compared per sample, one job of each of at most this many
# launches (a uniform draw over the sample's launches, from the seed).  A
# fixed budget: one job of a 50 kb piece has 12.8 MB of pointer rows at
# W = 256, so a share of every launch would not fit beside the window, and
# the reference's row loop costs as much for 16 jobs as for one
K2_JOBS = 16


class Capture:
    """What one sample's launches produced, drawn from the run's seed."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 7919])
        # K2's own stream: K1's and the GEMM's draws stay as they were
        self.rng_k2 = np.random.default_rng([int(seed), 7919, 2])
        self.k1: list[dict] = []
        self.k2: list[dict] = []
        self.k2_launches = 0
        self.k3: list[dict] = []
        self.ll: list[dict] = []

    def take_nw(self, args, kwargs, out) -> None:
        """A plain NW call, filed by its band as the port files it."""
        from hla_la_tpu_torch.ops.cuda_nw import MAX_W as K1_MAX_W
        W = args[2].shape[1] - args[0].shape[1]
        (self.take_k1 if W <= K1_MAX_W else self.take_k2)(args, kwargs, out)

    def take_k2(self, args, kwargs, out) -> None:
        """One job of this launch, kept with probability K2_JOBS over the
        launches seen so far (reservoir sampling): the job's live rows
        only, rows past its read's length cut."""
        n = self.k2_launches
        self.k2_launches += 1
        slot = n if n < K2_JOBS else int(self.rng_k2.integers(0, n + 1))
        if slot >= K2_JOBS:
            return
        reads, lens, refs, sc = args[:4]
        B, L = reads.shape
        b = int(self.rng_k2.integers(0, B))
        n_len = int(lens[b])
        W = refs.shape[1] - L

        def host(t, cols):
            return t[b, :cols].cpu().numpy().copy()

        job = {"reads": host(reads, n_len), "len": n_len,
               "refs": host(refs, n_len + W), "scoring": dict(sc),
               "score": float(out[0][b]), "end_k": int(out[1][b]),
               "end_state": int(out[2][b]),
               "pointers": host(out[3], n_len + 1)}
        if slot < len(self.k2):
            self.k2[slot] = job
        else:
            self.k2.append(job)

    def take_k1(self, args, kwargs, out) -> None:
        import torch
        reads, lens, refs, sc = args[:4]
        B = reads.shape[0]
        n = min(B, max(K1_JOBS_MIN, B // K1_JOBS_SHARE))
        idx = np.sort(self.rng.choice(B, n, replace=False))
        it = torch.as_tensor(idx, device=reads.device)

        def host(t):
            return t.index_select(0, it).cpu().numpy()

        self.k1.append({
            "reads": host(reads), "lens": host(lens).astype(np.int64),
            "refs": host(refs), "scoring": dict(sc),
            "score": host(out[0]), "end_k": host(out[1]),
            "end_state": host(out[2]), "pointers": host(out[3])})

    def take_k3(self, args, kwargs, out) -> None:
        L = args[0]
        acc, rpad = out
        # copies: on the CPU a tensor may share the typer's scratch array
        self.k3.append({"L": L.detach().cpu().numpy().copy(),
                        "acc": acc.detach().cpu().numpy().copy(),
                        "rpad": int(rpad),
                        "tile_range": _k3_shape(args, kwargs)[2]})


    def take_ll(self, args, kwargs, out) -> None:
        if len(self.ll) >= LL_CALLS:
            return
        onehot, contrib, mismatch = args[:3]
        C, R = onehot.shape[0], contrib.shape[0]
        rows = np.sort(self.rng.choice(C, min(C, LL_ROWS), replace=False))
        reads = np.sort(self.rng.choice(R, min(R, LL_READS), replace=False))
        at = np.ix_(rows, reads)
        # fancy indexing copies: the outputs may be the typer's scratch or
        # a worker's shared region
        self.ll.append({"onehot": onehot[rows], "contrib": contrib[reads],
                        "mismatch": mismatch[reads],
                        "LL": np.asarray(out[0])[at],
                        "MM": np.asarray(out[1])[at]})


class KernelProbe:
    def __init__(self, kernel: str, fn, shape):
        self.kernel = kernel
        self.fn = fn
        self.shape = shape
        for attr in ("launches", "largest", "events"):
            v = getattr(fn, attr, _ABSENT)
            if v is not _ABSENT:
                setattr(self, attr, v)
        self.timing = False
        self.timed: list[tuple[tuple, tuple]] = []
        self.capture: Capture | None = None

    def __call__(self, *args, **kwargs):
        hooked = hasattr(self, "events")
        own = self.timing and hooked and self.events is None
        if own:
            self.events = []
        n0 = len(self.events) if hooked and self.events is not None else 0
        try:
            out = self.fn(*args, **kwargs)
            new = (list(self.events[n0:]) if hooked
                   and self.events is not None else [])
        finally:
            if own:
                self.events = None
        if self.timing and new:
            self.timed.append((self.shape(args, kwargs), new[-1]))
        if self.capture is not None:
            {"K1": self.capture.take_k1, "K2": self.capture.take_k2,
             "NW": self.capture.take_nw, "K3": self.capture.take_k3,
             "LL": self.capture.take_ll}[self.kernel](args, kwargs, out)
        return out


def _nw_shape(args, kwargs):
    reads, refs = args[0], args[2]
    B, L = reads.shape
    return (int(B), int(L), int(refs.shape[1] - L))


def _k3_shape(args, kwargs):
    C, R = args[0].shape
    tile = kwargs.get("tile_range", args[1] if len(args) > 1 else None)
    return (int(C), int(R), tile)


def _ll_shape(args, kwargs):
    C, J, _ = args[0].shape
    return (int(C), int(args[1].shape[0]), int(J))


class Probes:
    """The six probes, and the module names they stand in."""

    def __init__(self):
        from hla_la_tpu_torch.models import typer
        from hla_la_tpu_torch.ops import (banded_nw, cuda_nw, cuda_nw_long,
                                          cuda_pair, pair_ll)
        self.k1 = KernelProbe("K1", cuda_nw.banded_nw_cuda, _nw_shape)
        self.k2 = KernelProbe("K2", cuda_nw_long.banded_nw_long_cuda,
                              _nw_shape)
        self.k3 = KernelProbe("K3", cuda_pair.pair_ll_diff_cuda, _k3_shape)
        self.nw_plain = KernelProbe("NW", banded_nw.banded_nw_plain,
                                    _nw_shape)
        self.k3_plain = KernelProbe("K3", pair_ll.pair_ll_diff_plain,
                                    _k3_shape)
        self.ll = KernelProbe("LL", pair_ll.cluster_read_ll, _ll_shape)
        self._names = [(cuda_nw, "banded_nw_cuda", self.k1),
                       (banded_nw, "banded_nw_cuda", self.k1),
                       (cuda_nw_long, "banded_nw_long_cuda", self.k2),
                       (banded_nw, "banded_nw_long_cuda", self.k2),
                       (cuda_pair, "pair_ll_diff_cuda", self.k3),
                       (pair_ll, "pair_ll_diff_cuda", self.k3),
                       (banded_nw, "banded_nw_plain", self.nw_plain),
                       (pair_ll, "pair_ll_diff_plain", self.k3_plain),
                       (pair_ll, "cluster_read_ll", self.ll),
                       (typer, "cluster_read_ll", self.ll)]
        self._saved = [(m, n, getattr(m, n)) for m, n, _ in self._names]
        for m, n, p in self._names:
            setattr(m, n, p)

    @property
    def all(self) -> list[KernelProbe]:
        return [self.k1, self.k2, self.k3, self.nw_plain, self.k3_plain,
                self.ll]

    def set_capture(self, cap: Capture | None) -> None:
        for p in self.all:
            p.capture = cap

    def set_timing(self, on: bool) -> None:
        for p in self.all:
            p.timing = on

    def remove(self) -> None:
        for m, n, fn in self._saved:
            setattr(m, n, fn)
