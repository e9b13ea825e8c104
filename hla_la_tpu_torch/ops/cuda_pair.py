"""Wrapper of K3, the hand-written CUDA pair-likelihood difference term
(``csrc/pair_ll.cu``), the port's replacement for the TPU kernels
``hla_la_tpu/ops/pallas_pair.py::_make_kernel`` / ``_make_kernel_v2`` and
for the XLA scan ``hla_la_tpu/ops/pair_ll.py::make_pair_ll_jax``.

Takes a CUDA tensor only and launches on the current stream; the plain
PyTorch version lives in ``ops/pair_ll.py``.
"""

from __future__ import annotations

import torch

from .. import _build


def pair_ll_diff_cuda(L: torch.Tensor,
                      tile_range: tuple[int, int] | None = None
                      ) -> tuple[torch.Tensor, int]:
    """L [C, R] f32 on a CUDA device -> (acc [C, C] f32, Rpad) with
    acc[c1, c2] = sum over Rpad reads of 0.5*|a-b| + log1p(exp(-|a-b|));
    reads R..Rpad-1 are zero padding (each adds log 2).  The kernel may
    cut the read range into parts to fill the card's block slots; it says
    how much scratch memory that takes and gets it from here.

    `tile_range` = (first, count) computes those tiles of the kernel's tile
    list alone (64 x 64 tiles with c1 <= c2, row-major; ``pair_tiles(C)`` of
    them) and leaves every other cell zero: the ranges of a partition of
    the list sum to the one-call matrix, bit for bit."""
    if not L.is_cuda:
        raise ValueError("pair_ll_diff_cuda takes a CUDA tensor")
    if L.dtype != torch.float32 or L.dim() != 2:
        raise TypeError("L must be a 2-D float32 tensor")
    L = L.contiguous()
    C, R = L.shape
    lib = _build.library()
    rk = lib.lib.hla_pair_ll_read_chunk()
    rpad = -(-R // rk) * rk
    n_all = lib.lib.hla_pair_ll_tiles(C)
    if tile_range is None:
        lo, count = 0, n_all
        out = torch.empty((C, C), dtype=torch.float32, device=L.device)
    else:
        lo, count = tile_range
        if not (0 <= lo and 0 <= count and lo + count <= n_all):
            raise ValueError(f"tile range {tile_range} outside the "
                             f"{n_all} tiles of C = {C}")
        # ranges are summed, so what a range does not cover must be zero
        out = torch.zeros((C, C), dtype=torch.float32, device=L.device)
    if count == 0 or R == 0:
        return out.zero_(), rpad
    n_scratch = lib.lib.hla_pair_ll_scratch_floats(C, R, count)
    lib.check("hla_pair_ll_scratch_floats", max(0, -n_scratch))
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=L.device)
    rc = lib.lib.hla_pair_ll_diff(
        L.data_ptr(), C, R, out.data_ptr(), scratch.data_ptr(), n_scratch,
        lo, count, torch.cuda.current_stream(L.device).cuda_stream)
    lib.check("hla_pair_ll_diff", rc)
    pair_ll_diff_cuda.launches += 1
    return out, rpad


pair_ll_diff_cuda.launches = 0
