"""Wrapper of K2, the hand-written CUDA banded NW forward for bands wider
than K1's (``csrc/banded_nw_long.cu``), the port's replacement for the TPU
kernel ``hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw_long``.

K2 keeps K1's I/O contract (``ops/cuda_nw.py``) for 33 <= W <= 1024 and any
L >= 1, and runs the same row step (``csrc/banded_nw_row.cuh``): one warp
per job up to W = 256, up to four above.  ``ops/cuda_nw.py::nw_launch_plan`` makes that choice.
Takes CUDA tensors only and launches on the current stream; the plain
PyTorch version, shared with K1, is ``ops/banded_nw.py::banded_nw_plain``.
"""

from __future__ import annotations

from .._lazy import torch
from .cuda_nw import MAX_W as K1_MAX_W
from .cuda_nw import MAX_W_LONG as MAX_W
from .cuda_nw import check_nw_args, launch_nw

MIN_W = K1_MAX_W + 1


def banded_nw_long_cuda(reads: torch.Tensor, read_lens: torch.Tensor,
                        refs: torch.Tensor, sc: dict
                        ) -> tuple[torch.Tensor, ...]:
    """reads [B, L] u8, read_lens [B] int, refs [B, L + W] u8 (all on one
    CUDA device) -> (score [B] f32, end_k [B] i32, end_state [B] i32,
    pointers [B, L + 1, W] u8)."""
    B, L, W = check_nw_args("banded_nw_long_cuda", reads, read_lens, refs,
                            MIN_W, MAX_W)
    if L < 1:
        raise ValueError(f"read length L={L} < 1")
    out = launch_nw("hla_banded_nw_long_forward", reads, read_lens, refs,
                    sc, B, L, W, banded_nw_long_cuda.events)
    banded_nw_long_cuda.launches += 1
    banded_nw_long_cuda.largest = max(banded_nw_long_cuda.largest,
                                      (B * L * W, B, L, W))
    return out


banded_nw_long_cuda.launches = 0
# the launch with the most cells since the count was last zeroed:
# (cells, B, L, W)
banded_nw_long_cuda.largest = (0, 0, 0, 0)
# a list, while a caller wants each launch timed (see banded_nw_cuda)
banded_nw_long_cuda.events = None
