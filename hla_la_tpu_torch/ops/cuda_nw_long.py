"""Wrapper of K2, the hand-written CUDA banded NW forward for bands wider
than a warp (``csrc/banded_nw_long.cu``), the port's replacement for the
TPU kernel ``hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw_long``.

K2 keeps K1's I/O contract (``ops/cuda_nw.py``) for 33 <= W <= 1024 and any
L >= 1: one thread block per job, the band offset on the threads.  Takes
CUDA tensors only and launches on the current stream; the plain PyTorch
version, shared with K1, is ``ops/banded_nw.py::banded_nw_plain``.
"""

from __future__ import annotations

import torch

from .. import _build
from .cuda_nw import MAX_W as K1_MAX_W

MIN_W = K1_MAX_W + 1
MAX_W = 1024    # one thread per band offset, at most 32 warps per block


def banded_nw_long_cuda(reads: torch.Tensor, read_lens: torch.Tensor,
                        refs: torch.Tensor, sc: dict
                        ) -> tuple[torch.Tensor, ...]:
    """reads [B, L] u8, read_lens [B] int, refs [B, L + W] u8 (all on one
    CUDA device) -> (score [B] f32, end_k [B] i32, end_state [B] i32,
    pointers [B, L + 1, W] u8)."""
    if not (reads.is_cuda and read_lens.is_cuda and refs.is_cuda):
        raise ValueError("banded_nw_long_cuda takes CUDA tensors")
    if reads.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError("reads and refs must be uint8")
    if reads.dim() != 2 or refs.dim() != 2 or read_lens.dim() != 1:
        raise ValueError("reads [B, L], read_lens [B], refs [B, L + W]")
    B, L = reads.shape
    W = refs.shape[1] - L
    if refs.shape[0] != B or read_lens.shape[0] != B:
        raise ValueError("batch sizes differ")
    if L < 1:
        raise ValueError(f"read length L={L} < 1")
    if not MIN_W <= W <= MAX_W:
        raise ValueError(f"band W={W} outside {MIN_W}..{MAX_W}")
    reads = reads.contiguous()
    refs = refs.contiguous()
    lens = read_lens.to(torch.int32).contiguous()
    dev = reads.device
    score = torch.empty(B, dtype=torch.float32, device=dev)
    end_k = torch.empty(B, dtype=torch.int32, device=dev)
    end_state = torch.empty(B, dtype=torch.int32, device=dev)
    pointers = torch.empty((B, L + 1, W), dtype=torch.uint8, device=dev)
    lib = _build.library()
    rc = lib.lib.hla_banded_nw_long_forward(
        reads.data_ptr(), lens.data_ptr(), refs.data_ptr(), B, L, W,
        sc["match"], sc["mismatch"], sc["gap_open"], sc["gap_extend"],
        score.data_ptr(), end_k.data_ptr(), end_state.data_ptr(),
        pointers.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    lib.check("hla_banded_nw_long_forward", rc)
    banded_nw_long_cuda.launches += 1
    return score, end_k, end_state, pointers


banded_nw_long_cuda.launches = 0
