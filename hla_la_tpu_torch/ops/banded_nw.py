"""Batched banded glocal affine NW forward: the port's counterpart of
``hla_la_tpu/ops/banded_nw.py``'s device half.

``banded_nw_forward_torch`` keeps the reference's I/O contract
(``banded_nw_forward`` / ``make_jax_banded_nw``): reads [B, L] u8 codes 0-3
(>= 4 is N or pad), read_lens [B], refs [B, L + W] u8 window codes ->
(score [B] f32, end_k [B] i32, end_state [B] i32, pointers [B, L + 1, W] u8).
A CUDA tensor goes to a kernel by its band: W <= 32 to K1 (``ops/cuda_nw.py``,
one warp per job), W > 32 to K2 (``ops/cuda_nw_long.py``, one block per job,
for long reads); each raises outside its range.  A CPU tensor goes to
``banded_nw_plain``, a PyTorch transcription of ``make_jax_banded_nw``
(``hla_la_tpu/ops/banded_nw.py:183-284``).  K1 and K2 have one contract, so
``banded_nw_plain`` is the plain version of both, for every W.  The numpy
backtrace, the native host code and the scoring dataclass are the
reference's own.
"""

from __future__ import annotations

import torch

from hla_la_tpu.ops.banded_nw import NWScoring

from ..device import on_card, resolve, to_device
from .cuda_nw import MAX_W as K1_MAX_W
from .cuda_nw import banded_nw_cuda
from .cuda_nw_long import banded_nw_long_cuda

NEG = -1e30


def scoring_from_reference(sc: NWScoring) -> dict:
    """The reference's scoring as the plain dict the port passes around."""
    return {"match": float(sc.match), "mismatch": float(sc.mismatch),
            "gap_open": float(sc.gap_open),
            "gap_extend": float(sc.gap_extend)}


# the reference aligner's scoring, which the port's aligner runs with
DEFAULT_SCORING = scoring_from_reference(NWScoring())


def banded_nw_plain(reads: torch.Tensor, read_lens: torch.Tensor,
                    refs: torch.Tensor, sc: dict
                    ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch forward, op for op the XLA scan of the reference: a row
    loop, the IX state in closed form as a max-scan over k segmented at
    masked ref codes, and the first argmax over state-major [D, IY, IX] x k
    at row read_len."""
    B, L = reads.shape
    W = refs.shape[1] - L
    dev = reads.device
    f32 = torch.float32
    open_, ext = sc["gap_open"], sc["gap_extend"]
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    karange = torch.arange(W, dtype=f32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=f32, device=dev)
    lens = read_lens.to(torch.int64)

    D = torch.zeros((B, W), dtype=f32, device=dev)
    IY = torch.full((B, W), NEG, dtype=f32, device=dev)
    IX = torch.full((B, W), NEG, dtype=f32, device=dev)
    best_s = torch.full((B,), NEG, dtype=f32, device=dev)
    best_k = torch.zeros(B, dtype=torch.int32, device=dev)
    best_st = torch.zeros(B, dtype=torch.int32, device=dev)
    pointers = torch.zeros((B, L + 1, W), dtype=torch.uint8, device=dev)

    def harvest(i, D, IY, IX):
        at_end = lens == i
        flat = torch.stack([D, IY, IX], dim=1).reshape(B, 3 * W)
        arg = torch.argmax(flat, dim=1)            # first maximum
        val = torch.gather(flat, 1, arg[:, None])[:, 0]
        best_s.copy_(torch.where(at_end, val, best_s))
        best_k.copy_(torch.where(at_end, (arg % W).to(torch.int32), best_k))
        best_st.copy_(torch.where(at_end, (arg // W).to(torch.int32),
                                  best_st))

    # banded ref view: ref_band[b, i, k] = refs[b, i + k]
    idx = (torch.arange(L, device=dev)[:, None]
           + torch.arange(W, device=dev)[None, :])
    ref_band = refs[:, idx]                                  # [B, L, W]
    harvest(0, D, IY, IX)
    for i in range(1, L + 1):
        read_col = reads[:, i - 1, None]
        ref_col = ref_band[:, i - 1]
        ok = (read_col == ref_col) & (read_col < 4)
        sub = torch.where(ref_col >= 4, neg,
                          torch.where(ok, sc["match"], sc["mismatch"]
                                      ).to(f32))
        prev_best = torch.maximum(torch.maximum(D, IY), IX)
        m_src = torch.where(D >= torch.maximum(IY, IX), 0,
                            torch.where(IY >= IX, 1, 2)).to(torch.uint8)
        nD = prev_best + sub
        D_sh = torch.cat([D[:, 1:], neg_col], dim=1)
        IY_sh = torch.cat([IY[:, 1:], neg_col], dim=1)
        oc = D_sh + open_
        ec = IY_sh + ext
        nIY = torch.maximum(oc, ec)
        iy_src = (ec > oc).to(torch.uint8)

        ref_ok = ref_col < 4
        g = torch.where(ref_ok, nD - karange * ext, neg)
        seg = torch.cumsum((~ref_ok).to(torch.int32), dim=1)
        gmax = g
        sh = 1
        while sh < W:
            rolled = torch.cat(
                [torch.full((B, sh), NEG, dtype=f32, device=dev),
                 gmax[:, :W - sh]], dim=1)
            rolled_seg = torch.cat(
                [torch.full((B, sh), -1, dtype=torch.int32, device=dev),
                 seg[:, :W - sh]], dim=1)
            gmax = torch.maximum(gmax,
                                 torch.where(rolled_seg == seg, rolled, neg))
            sh *= 2
        nIX = torch.cat([neg_col,
                         open_ + karange[1:] * ext - ext + gmax[:, :-1]],
                        dim=1)
        nIX = torch.where(ref_ok, nIX, neg)
        oc2 = torch.cat([neg_col, nD[:, :-1] + open_], dim=1)
        ec2 = torch.cat([neg_col, nIX[:, :-1] + ext], dim=1)
        ix_src = (ec2 > oc2).to(torch.uint8)

        pointers[:, i] = m_src | (iy_src << 2) | (ix_src << 3)
        D, IY, IX = nD, nIY, nIX
        harvest(i, D, IY, IX)
    return best_s, best_k, best_st, pointers


def banded_nw_forward_torch(reads, read_lens, refs, sc: dict,
                            device: str | torch.device
                            ) -> tuple[torch.Tensor, ...]:
    """Forward DP on `device`: numpy arrays are copied there, tensors must
    already be there; the results stay there."""
    dev = resolve(device)
    return _forward(to_device(reads, dev), to_device(read_lens, dev),
                    to_device(refs, dev), sc)


def _forward(reads, read_lens, refs, sc):
    if on_card(reads):
        if refs.shape[1] - reads.shape[1] <= K1_MAX_W:
            return banded_nw_cuda(reads, read_lens, refs, sc)
        return banded_nw_long_cuda(reads, read_lens, refs, sc)
    return banded_nw_plain(reads, read_lens, refs, sc)
