"""The typing likelihood model on the device: the port's counterpart of
``hla_la_tpu/ops/pair_ll.py``.

- ``cluster_read_ll``: LL[c, r] and mismatches[c, r] as two float32
  matrix products of the cluster one-hot [C, J*6] with the read tensors,
  TF32 off (``pair_ll.py:139-163``).  A plain product, left to
  ``torch.matmul`` as the reference leaves it to XLA.
- ``pair_ll_reduction``: the diploid pair log-likelihoods
  LL[c1, c2] = sum_r log((exp(L[c1,r]) + exp(L[c2,r])) / 2).  The device
  computes the bounded difference term (K3 on a CUDA tensor,
  ``pair_ll_diff_plain`` on a CPU tensor); the rank-1 term and the per-read
  constant are added on the host in float64, as ``pair_ll.py:252-257``.

The one-hot encoding, the numpy references and the mismatch row helper are
the reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from hla_la_tpu.ops.pair_ll import LOG_HALF

from ..device import on_card, resolve, to_device
from .cuda_pair import pair_ll_diff_cuda

# bound on the [C, C, chunk] float32 intermediate of the plain version
# (~0.5 GB), as at hla_la_tpu/ops/pair_ll.py:247-248
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


def pair_ll_diff_plain(L: torch.Tensor, chunk: int = 256
                       ) -> tuple[torch.Tensor, int]:
    """Plain PyTorch difference term, the reference's XLA scan
    (``make_pair_ll_jax``) written out: zero-pad R to a chunk multiple and
    sum [C, C, chunk] blocks.  Returns (acc [C, C] f32, Rpad)."""
    C, R = L.shape
    chunk = plain_chunk(C, R, chunk)
    n_chunks = -(-R // chunk)
    Rpad = n_chunks * chunk
    Lp = torch.nn.functional.pad(L, (0, Rpad - R))
    acc = torch.zeros((C, C), dtype=L.dtype, device=L.device)
    for lo in range(0, Rpad, chunk):
        blk = Lp[:, lo:lo + chunk]
        d = (blk[:, None, :] - blk[None, :, :]).abs()
        acc = acc + (0.5 * d + torch.log1p(torch.exp(-d))).sum(dim=2)
    return acc, Rpad


def pair_ll_reduction(L: np.ndarray, device: str | torch.device
                      ) -> np.ndarray:
    """[C, R] per-cluster read log-likelihoods -> [C, C] float64 pair
    log-likelihoods (symmetric)."""
    C, R = L.shape
    if C == 0 or R == 0:
        return np.zeros((C, C), dtype=np.float64)
    acc, Rpad = _pair_ll_diff(
        to_device(np.asarray(L, dtype=np.float32), resolve(device)))
    acc = acc.cpu().numpy().astype(np.float64)
    rowsum = L.astype(np.float64).sum(axis=1)
    base = 0.5 * (rowsum[:, None] + rowsum[None, :])
    # padded reads (value 0) add log 2 each to acc and LOG_HALF each to the
    # per-read constant: log 2 + LOG_HALF = 0, so using Rpad cancels
    return base + acc + LOG_HALF * Rpad


def _pair_ll_diff(L: torch.Tensor) -> tuple[torch.Tensor, int]:
    if on_card(L):
        return pair_ll_diff_cuda(L)
    return pair_ll_diff_plain(L)
