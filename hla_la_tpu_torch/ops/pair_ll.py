"""The typing likelihood model: the port's counterpart of
``hla_la_tpu/ops/pair_ll.py``.

Host half (numpy, the reference's text): the channel one-hot of the cluster
columns (``cluster_onehot``), the sparse-delta form of ``cluster_read_ll``
(``cluster_channel_codes``, ``cluster_delta_plan``, ``cluster_read_ll_delta``
and its numpy reference), the float64 numpy pair reduction
``pair_ll_reduction_numpy`` and ``pair_min_mismatch_row``.

Device half:

- ``cluster_read_ll``: LL[c, r] and mismatches[c, r] as two float32
  matrix products of the cluster one-hot [C, J*6] with the read tensors,
  TF32 off.  A plain product, left to ``torch.matmul`` as the reference
  leaves it to XLA.
- ``pair_ll_reduction``: the diploid pair log-likelihoods
  LL[c1, c2] = sum_r log((exp(L[c1,r]) + exp(L[c2,r])) / 2), decomposed as
  logavg(a, b) = (a+b)/2 + |a-b|/2 + log1p(exp(-|a-b|)) + log(1/2).  The
  device computes the bounded difference term (K3 on a CUDA tensor,
  ``pair_ll_diff_plain`` on a CPU tensor); the rank-1 term and the per-read
  constant are added on the host in float64.
- ``pair_epilogue``: the typer's pair step after K3, up to the pair dump's
  columns in the dump's order.  Where the process owns its card, K3's
  output stays there to be assembled, packed into the upper triangle and
  ordered (``_pair_epilogue_card``); a CPU device, a served typer and a
  mesh's ranks take the host's numpy.  ``pair_posterior`` is the float64
  posterior that follows, on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from .._lazy import torch
from ..device import on_card, resolve, to_device
from .cuda_pair import pair_ll_diff_cuda

LOG_HALF = float(np.log(0.5))

# channel order for the one-hot encoding of cluster columns
CH_A, CH_C, CH_G, CH_T, CH_GAP, CH_OTHER = range(6)
_CHANNEL = np.full(256, CH_OTHER, dtype=np.int8)
for ch, b in ((CH_A, "A"), (CH_C, "C"), (CH_G, "G"), (CH_T, "T"),
              (CH_GAP, "_")):
    _CHANNEL[ord(b)] = ch


def cluster_onehot(cluster_seqs: list[str]) -> np.ndarray:
    """[C, J, 6] float32 one-hot of cluster column characters."""
    C = len(cluster_seqs)
    J = len(cluster_seqs[0])
    codes = np.frombuffer("".join(cluster_seqs).encode(), dtype=np.uint8
                          ).reshape(C, J)
    onehot = np.zeros((C, J, 6), dtype=np.float32)
    ch = _CHANNEL[codes]
    for c in range(6):
        onehot[:, :, c] = ch == c
    return onehot


def cluster_channel_codes(cluster_seqs: list[str]) -> np.ndarray:
    """[C, J] int8 channel code (CH_*) of each cluster column."""
    C = len(cluster_seqs)
    J = len(cluster_seqs[0])
    codes = np.frombuffer("".join(cluster_seqs).encode(), dtype=np.uint8
                          ).reshape(C, J)
    return _CHANNEL[codes]


def cluster_delta_plan(ch: np.ndarray):
    """Sparse-delta evaluation plan for cluster_read_ll.

    Exploits that allele clusters of one locus are near-identical (the
    reference's segment matrices differ in a few % of columns,
    HLATyper.cpp:1198-1299): pick the per-column consensus channel as a
    reference row, so LL[c] = LL_ref + sum over the cluster's few
    differing columns.  Returns (ref[J] consensus channel,
    base_cols[J] = j*6+ref, plus_cols/minus_cols[ndiff] flat [J*6]
    indices, starts[C+1] per-cluster diff ranges)."""
    C, J = ch.shape
    hist = np.zeros((J, 6), dtype=np.int32)
    for c in range(6):
        hist[:, c] = (ch == c).sum(axis=0, dtype=np.int32)
    ref = hist.argmax(axis=1).astype(np.int8)
    base_cols = (np.arange(J, dtype=np.int64) * 6 + ref)
    dc, dj = np.nonzero(ch != ref[None, :])
    plus_cols = dj * 6 + ch[dc, dj]
    minus_cols = dj * 6 + ref[dj]
    starts = np.searchsorted(dc, np.arange(C + 1)).astype(np.int64)
    return ref, base_cols, plus_cols.astype(np.int64), \
        minus_cols.astype(np.int64), starts


def cluster_read_ll_delta_numpy(ch: np.ndarray, contrib_T: np.ndarray,
                                mismatch_T: np.ndarray, plan=None,
                                out_ll=None, out_mm=None
                                ) -> tuple[np.ndarray, np.ndarray]:
    """Reference (numpy) sparse-delta cluster_read_ll.

    contrib_T / mismatch_T are the TRANSPOSED [J*6, R] tensors (rows
    contiguous over reads).  Same math as the dense matmul up to f32
    summation order (parity locked by tests/test_imgt_scale.py); base
    rows accumulate in f64."""
    C, J = ch.shape
    R = contrib_T.shape[1]
    ref, base_cols, plus_cols, minus_cols, starts = \
        plan if plan is not None else cluster_delta_plan(ch)
    out = []
    for T, M in ((contrib_T, out_ll), (mismatch_T, out_mm)):
        base = T[base_cols].sum(axis=0, dtype=np.float64)       # [R]
        if M is None:
            M = np.empty((C, R), dtype=np.float32)
        acc = np.empty(R, dtype=np.float64)
        for c in range(C):
            k0, k1 = starts[c], starts[c + 1]
            if k1 > k0:
                # accumulate per-k (plus - minus) deltas onto base IN THE
                # NATIVE KERNEL'S ORDER (acc += p_k - m_k), so the f64
                # rounding sequence — and therefore the f32 result — is
                # bit-identical to hla_cluster_ll_delta for any k-count
                # (a sum(plus) - sum(minus) form rounds differently)
                np.copyto(acc, base)
                for k in range(int(k0), int(k1)):
                    acc += (T[plus_cols[k]].astype(np.float64)
                            - T[minus_cols[k]].astype(np.float64))
                M[c] = acc.astype(np.float32)
            else:
                M[c] = base.astype(np.float32)
        out.append(M)
    return out[0], out[1]


def cluster_read_ll_delta(ch: np.ndarray, contrib_T: np.ndarray,
                          mismatch_T: np.ndarray, plan=None,
                          out_ll=None, out_mm=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Sparse-delta cluster_read_ll: native threaded kernel when available,
    numpy reference otherwise.  See cluster_delta_plan.  out_ll/out_mm:
    optional preallocated [C, R] f32 outputs (column slices of a wider
    matrix are fine)."""
    from .. import native
    if plan is None:
        plan = cluster_delta_plan(ch)
    ref, base_cols, plus_cols, minus_cols, starts = plan
    out = native.cluster_ll_delta(contrib_T, mismatch_T, base_cols,
                                  plus_cols, minus_cols, starts,
                                  out_ll=out_ll, out_mm=out_mm)
    if out is not None:
        return out
    return cluster_read_ll_delta_numpy(ch, contrib_T, mismatch_T, plan,
                                       out_ll=out_ll, out_mm=out_mm)



def pair_ll_reduction_numpy(L: np.ndarray, chunk: int = 256) -> np.ndarray:
    """LL[c1, c2] = sum_r log((exp(L[c1,r]) + exp(L[c2,r])) / 2), computed in
    read chunks.  Returns the full [C, C] matrix (symmetric)."""
    C, R = L.shape
    out = np.zeros((C, C), dtype=np.float64)
    L = L.astype(np.float64)
    for lo in range(0, R, chunk):
        chunk_L = L[:, lo:lo + chunk]                    # [C, Rc]
        a = chunk_L[:, None, :]                          # [C, 1, Rc]
        b = chunk_L[None, :, :]                          # [1, C, Rc]
        hi = np.maximum(a, b)
        lo_ = np.minimum(a, b)
        out += (LOG_HALF + hi + np.log1p(np.exp(lo_ - hi))).sum(axis=2)
    return out


def pair_min_mismatch_row(mm: np.ndarray, c1: int) -> np.ndarray:
    """Mismatches_min for pairs (c1, *): sum_r min(m[c1,r], m[c,r])
    (HLATyper.cpp:2337-2340, needed only for the best-guess row).

    Chunked over clusters with a small reused temp: the naive broadcast
    allocates a full [C, R] copy (~150 MB at IMGT scale).  Row sums are
    computed per row either way, so the result is bit-identical to the
    one-shot form."""
    C, R = mm.shape
    out = np.empty(C, dtype=mm.dtype)
    row = mm[c1][None, :]
    chunk = max(1, int(4e6 // max(R, 1)))
    buf = np.empty((min(chunk, C), R), dtype=mm.dtype)
    for lo in range(0, C, chunk):
        hi = min(lo + chunk, C)
        b = buf[:hi - lo]
        np.minimum(row, mm[lo:hi], out=b)
        out[lo:hi] = b.sum(axis=1)
    return out



# ------------------------------------------------------------ device half
# bound on the [C, C, chunk] float32 intermediate of the plain version
# (~0.5 GB)
PLAIN_CELLS = 1.3e8


def cluster_read_ll(onehot: np.ndarray, contrib: np.ndarray,
                    mismatch: np.ndarray, device: str | torch.device,
                    out=None) -> tuple[np.ndarray, np.ndarray]:
    """onehot [C, J, 6], contrib / mismatch [R, J, 6] -> (LL, MM) [C, R]
    float32 numpy, computed on `device`; into the two arrays of `out` when
    given (the device server passes a worker's region)."""
    dev = resolve(device)
    C, J, _ = onehot.shape
    R = contrib.shape[0]
    A = to_device(onehot.reshape(C, J * 6), dev)
    Bc = to_device(contrib.reshape(R, J * 6), dev)
    Bm = to_device(mismatch.reshape(R, J * 6), dev)
    ll = torch.matmul(A, Bc.T)
    mm = torch.matmul(A, Bm.T)
    if out is None:
        return ll.cpu().numpy(), mm.cpu().numpy()
    for dst, t in zip(out, (ll, mm)):
        torch.from_numpy(dst).copy_(t)
    return out[0], out[1]


def plain_chunk(C: int, R: int, chunk: int = 256) -> int:
    """Reads per block of the plain version: at most `chunk` and R, and
    small enough that [C, C, chunk] stays within PLAIN_CELLS."""
    return min(chunk, max(R, 1), max(1, int(PLAIN_CELLS // max(C * C, 1))))


PAIR_TILE = 64      # edge of K3's output tiles (csrc/pair_ll.cu: TC)


def pair_tiles(C: int) -> int:
    """Length of K3's tile list: the PAIR_TILE-square tiles with c1 <= c2
    of a C x C matrix, row-major over the upper triangle of tiles."""
    n = -(-C // PAIR_TILE)
    return n * (n + 1) // 2


def _tile_rows(C: int, first: int, count: int):
    """Tiles first .. first + count - 1 of the tile list as (ti, tj_lo,
    tj_hi) runs, one per tile row the range touches."""
    n = -(-C // PAIR_TILE)
    t, ti = 0, 0
    while ti < n and count > 0:
        row_len = n - ti
        if first < t + row_len:
            a = max(first, t) - t
            b = min(first + count, t + row_len) - t
            if b > a:
                yield ti, ti + a, ti + b - 1
        t += row_len
        ti += 1
        if t >= first + count:
            break


def pair_ll_diff_plain(L: torch.Tensor, chunk: int = 256,
                       tile_range: tuple[int, int] | None = None
                       ) -> tuple[torch.Tensor, int]:
    """Plain PyTorch difference term, the reference's XLA scan
    (``make_pair_ll_jax``) written out: zero-pad R to a chunk multiple and
    sum [C, C, chunk] blocks.  Returns (acc [C, C] f32, Rpad).

    With `tile_range` = (first, count), as K3's wrapper takes it: only the
    cells of those tiles of the tile list (and their mirrors) are computed,
    every other cell is zero, so the ranges of a partition of the list sum
    to the whole list's matrix exactly."""
    C, R = L.shape
    chunk = plain_chunk(C, R, chunk)
    n_chunks = -(-R // chunk)
    Rpad = n_chunks * chunk
    Lp = torch.nn.functional.pad(L, (0, Rpad - R))
    acc = torch.zeros((C, C), dtype=L.dtype, device=L.device)
    if tile_range is not None:
        first, count = tile_range
        if not (0 <= first and 0 <= count
                and first + count <= pair_tiles(C)):
            raise ValueError(f"tile range {tile_range} outside the "
                             f"{pair_tiles(C)} tiles of C = {C}")
        T = PAIR_TILE
        for ti, tj_lo, tj_hi in _tile_rows(C, first, count):
            r0, r1 = ti * T, min((ti + 1) * T, C)
            c0, c1 = tj_lo * T, min((tj_hi + 1) * T, C)
            part = torch.zeros((r1 - r0, c1 - c0), dtype=L.dtype,
                               device=L.device)
            for lo in range(0, Rpad, chunk):
                a = Lp[r0:r1, lo:lo + chunk]
                b = Lp[c0:c1, lo:lo + chunk]
                d = (a[:, None, :] - b[None, :, :]).abs()
                part = part + (0.5 * d
                               + torch.log1p(torch.exp(-d))).sum(dim=2)
            mirror = part
            if tj_lo == ti:
                # the diagonal tile holds both cells of a pair: keep its
                # c1 <= c2 cells, and mirror those off the diagonal
                k = r1 - r0
                part[:, :k] = torch.triu(part[:, :k])
                mirror = part.clone()
                mirror[:, :k] = torch.triu(part[:, :k], 1)
            acc[r0:r1, c0:c1] += part
            acc[c0:c1, r0:r1] += mirror.T
        return acc, Rpad
    for lo in range(0, Rpad, chunk):
        blk = Lp[:, lo:lo + chunk]
        d = (blk[:, None, :] - blk[None, :, :]).abs()
        acc = acc + (0.5 * d + torch.log1p(torch.exp(-d))).sum(dim=2)
    return acc, Rpad


def pair_ll_reduction(L: np.ndarray, device: str | torch.device,
                      sharded=None) -> np.ndarray:
    """[C, R] per-cluster read log-likelihoods -> [C, C] float64 pair
    log-likelihoods (symmetric).  `sharded`: a parallel.mesh.Mesh; the
    reduction is then split over its ranks (every rank calls this with the
    same L and gets the same matrix)."""
    C, R = L.shape
    if C == 0 or R == 0:
        return np.zeros((C, C), dtype=np.float64)
    if sharded is not None:
        from ..parallel.mesh import pair_ll_reduction_sharded
        return pair_ll_reduction_sharded(L, sharded)
    acc, Rpad = _pair_ll_diff(
        to_device(np.asarray(L, dtype=np.float32), resolve(device)))
    return pair_ll_assemble(acc.cpu().numpy().astype(np.float64), Rpad,
                            L.astype(np.float64).sum(axis=1))


def pair_ll_assemble(acc, rpad: int, rowsum):
    """The [C, C] pair log-likelihoods from the difference term `acc` over
    `rpad` (padded) reads and the per-cluster row sums `rowsum` [C]: the
    rank-1 term 0.5 (rowsum_a + rowsum_b), plus acc, plus LOG_HALF per
    read.  float64 numpy arrays or torch tensors, on any device."""
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    # padded reads (value 0) add log 2 each to acc and LOG_HALF each to the
    # per-read constant: log 2 + LOG_HALF = 0, so using Rpad cancels
    return base + acc + LOG_HALF * rpad


def _pair_ll_diff(L: torch.Tensor, tile_range=None
                  ) -> tuple[torch.Tensor, int]:
    if on_card(L):
        return pair_ll_diff_cuda(L, tile_range)
    return pair_ll_diff_plain(L, tile_range=tile_range)


# ------------------------------------------------------------ pair epilogue
# What the typer makes of the [C, C] pair log-likelihoods before its
# posterior: the upper triangle (c1 <= c2, row-major) and the pair dump's
# columns in the dump's order.  A process that owns its card keeps K3's
# output there for all of it; every other caller takes the host's numpy.

@functools.lru_cache(maxsize=4)
def triangle(C: int) -> tuple[np.ndarray, np.ndarray]:
    """np.triu_indices(C), read-only: the pairs c1 <= c2, row-major."""
    iu = np.triu_indices(C)
    for a in iu:
        a.setflags(write=False)
    return iu


@functools.lru_cache(maxsize=4)
def _triangle_on(C: int, dev: torch.device):
    iu = torch.triu_indices(C, C, device=dev)     # row-major, as numpy's
    return iu[0], iu[1]


def epilogue_on_card(device, sharded=None, reduce=None) -> bool:
    """Whether pair_epilogue keeps K3's output on the card: only where this
    process owns a CUDA device, so not for a served typer (`reduce` given:
    the device server's reduction) nor on a mesh's ranks (`sharded`)."""
    return (reduce is None and sharded is None
            and torch.device(device).type == "cuda")


def pair_epilogue(L: np.ndarray, mm_rowsum: np.ndarray, device,
                  sharded=None, reduce=None):
    """From the [C, R] per-cluster read log-likelihoods `L` and the
    per-cluster mismatch row sums `mm_rowsum` [C] (float32), the pair dump's
    columns in its order and the triangle's pair log-likelihoods:
    (a, b) int32 cluster indices, LL_o float64, MM_o float32 (the pair's
    Mismatches_avg), pair_vals float64 in triangle order.

    The dump's order is LL descending, ties by ascending Mismatches_avg
    (the reference's sort comparator, HLATyper.cpp:2382-2404), deeper ties
    by triangle index: np.lexsort's.  Both routes give the same bits: the
    same float64 and float32 operations, element for element, and the same
    permutation.  `reduce`: the pair reduction of a typer that does not own
    its device (a served typing worker's); `sharded`: a parallel.mesh.Mesh.
    """
    if epilogue_on_card(device, sharded, reduce):
        pair_epilogue.card_calls += 1
        return _pair_epilogue_card(L, mm_rowsum, resolve(device))
    pair_LL = (reduce or pair_ll_reduction)(L, device=device,
                                            sharded=sharded)
    iu0, iu1 = triangle(L.shape[0])
    pair_vals = pair_LL[iu0, iu1]
    mism_avg = 0.5 * (mm_rowsum[iu0] + mm_rowsum[iu1])
    # lexsort is stable and far faster than a structured argsort on the
    # 2.4M pairs of an IMGT-scale locus
    order = np.lexsort((mism_avg, -pair_vals))
    return (iu0[order].astype(np.int32), iu1[order].astype(np.int32),
            pair_vals[order], mism_avg[order], pair_vals)


# card routes taken by pair_epilogue in this process
pair_epilogue.card_calls = 0


def _pair_epilogue_card(L: np.ndarray, mm_rowsum: np.ndarray,
                        dev: torch.device):
    """pair_epilogue on `dev` (a CPU device runs the same steps with K3's
    plain version): K3's output assembled, packed, ordered and gathered
    where it is, then copied into pinned host memory with one
    synchronisation.  The row sums come from the host, as the host route
    computes them, so that every float64 value is the host's."""
    C = L.shape[0]
    Lt = to_device(np.asarray(L, dtype=np.float32), dev)
    rowsum = to_device(L.astype(np.float64).sum(axis=1), dev)
    mrs = to_device(np.asarray(mm_rowsum), dev)
    iu0, iu1 = _triangle_on(C, dev)
    if Lt.numel():
        acc, rpad = _pair_ll_diff(Lt)
        pair_vals = pair_ll_assemble(acc.to(torch.float64), rpad,
                                     rowsum)[iu0, iu1]
    else:
        pair_vals = torch.zeros(len(iu0), dtype=torch.float64, device=dev)
    mism_avg = 0.5 * (mrs[iu0] + mrs[iu1])
    # np.lexsort((mism_avg, -pair_vals)) as two stable sorts, the minor key
    # first; 0.0 - x and x + 0.0 turn -0.0 into 0.0, which numpy's sort
    # holds equal and a radix sort would not
    by_mm = torch.sort(mism_avg + 0.0, stable=True).indices
    order = by_mm[torch.sort((0.0 - pair_vals)[by_mm], stable=True).indices]
    cols = (iu0[order].to(torch.int32), iu1[order].to(torch.int32),
            pair_vals[order], mism_avg[order], pair_vals)
    card = on_card(Lt)
    host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=card)
            for c in cols]
    for h, c in zip(host, cols):
        h.copy_(c, non_blocking=True)
    if card:
        torch.cuda.current_stream(dev).synchronize()
    return tuple(h.numpy() for h in host)


class PairPosterior(NamedTuple):
    marg: np.ndarray        # [C] marginal posterior of each cluster
    best1: int              # the best marginal
    best2: int              # the best partner of best1
    best2_p: float          # the posterior of (best1, best2)
    mm_min_row: np.ndarray  # [C] Mismatches_min of (best1, c)
    P_o: np.ndarray         # the dump's P, in the dump's order


def pair_posterior(pair_vals: np.ndarray, LL_o: np.ndarray,
                   mm: np.ndarray) -> PairPosterior:
    """The float64 pair posterior on the host, from pair_epilogue's
    triangle-order pair log-likelihoods `pair_vals` and its dump-order LL
    column `LL_o`, with the [C, R] mismatches `mm` for best2's tie-break."""
    C = mm.shape[0]
    iu = triangle(C)
    max_ll = float(pair_vals.max()) if len(pair_vals) else 0.0
    P = np.exp(pair_vals - max_ll)
    s = P.sum()
    P = P / s if s > 0 else np.full_like(P, 1.0 / len(P))

    # marginal per-cluster posterior (HLATyper.cpp:2489-2517)
    marg = np.zeros(C)
    np.add.at(marg, iu[0], P)
    sec = iu[1] != iu[0]
    np.add.at(marg, iu[1][sec], P[sec])
    best1 = int(np.argmax(marg))

    # conditional second allele (2519-2538); triangular index of the
    # (a<=b) pair in row-major upper-triangle order
    def tri_idx(a, b):
        return a * C - (a * (a - 1)) // 2 + (b - a)
    c2s = np.arange(C)
    a_arr = np.minimum(best1, c2s)
    b_arr = np.maximum(best1, c2s)
    cand_P = P[tri_idx(a_arr, b_arr)]
    best2_p = float(cand_P.max())
    mm_min_row = pair_min_mismatch_row(mm, best1)
    tie = np.nonzero(cand_P == best2_p)[0]
    best2 = int(tie[np.argmax(-mm_min_row[tie])])

    # elementwise, so P[order] bit for bit without the gather
    P_o = np.exp(LL_o - max_ll) / s if s > 0 else \
        np.full_like(LL_o, 1.0 / len(LL_o))
    return PairPosterior(marg, best1, best2, best2_p, mm_min_row, P_o)
