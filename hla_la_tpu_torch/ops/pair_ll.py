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
"""

from __future__ import annotations

import numpy as np
import torch

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
                    mismatch: np.ndarray, device: str | torch.device
                    ) -> tuple[np.ndarray, np.ndarray]:
    """onehot [C, J, 6], contrib / mismatch [R, J, 6] -> (LL, MM) [C, R]
    float32 numpy, computed on `device`."""
    dev = resolve(device)
    C, J, _ = onehot.shape
    R = contrib.shape[0]
    A = to_device(onehot.reshape(C, J * 6), dev)
    Bc = to_device(contrib.reshape(R, J * 6), dev)
    Bm = to_device(mismatch.reshape(R, J * 6), dev)
    ll = torch.matmul(A, Bc.T)
    mm = torch.matmul(A, Bm.T)
    return ll.cpu().numpy(), mm.cpu().numpy()


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
    acc = acc.cpu().numpy().astype(np.float64)
    rowsum = L.astype(np.float64).sum(axis=1)
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    # padded reads (value 0) add log 2 each to acc and LOG_HALF each to the
    # per-read constant: log 2 + LOG_HALF = 0, so using Rpad cancels
    return base + acc + LOG_HALF * Rpad


def _pair_ll_diff(L: torch.Tensor, tile_range=None
                  ) -> tuple[torch.Tensor, int]:
    if on_card(L):
        return pair_ll_diff_cuda(L, tile_range)
    return pair_ll_diff_plain(L, tile_range=tile_range)
