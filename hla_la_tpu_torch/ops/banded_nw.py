"""Batched banded glocal affine-gap Needleman-Wunsch (read vs haplotype
window): the port's counterpart of ``hla_la_tpu/ops/banded_nw.py``.

Cell space: (i, k) with i = read prefix length 0..L, k = band offset 0..W-1,
ref prefix j = i + k.  The window is built as ref[anchor - W//2 ...] so the
expected diagonal sits at k = W//2.  Row 0 is free (glocal: leading ref
skipped); trailing ref is skipped by taking the max over k at row L.
States: D (match/mismatch), IY (insertion in read: consumes read, ref gap),
IX (deletion: consumes ref, read gap).  IX has a within-row scan over k.
Scoring mirrors alignerBase.cpp:19-25: match +2, mismatch -5, gap open -4 +
extend -2 charged together on the first gap character, -2 per extension.

Host half (numpy, the reference's text): ``NWScoring``, the numpy / native
forward ``banded_nw_forward`` and the backtrace ``banded_nw_backtrace``.

Device half: ``banded_nw_forward_torch`` keeps the same I/O contract: reads
[B, L] u8 codes 0-3 (>= 4 is N or pad), read_lens [B], refs [B, L + W] u8
window codes -> (score [B] f32, end_k [B] i32, end_state [B] i32, pointers
[B, L + 1, W] u8).  A CUDA tensor goes to a kernel by its band: W <= 32 to K1
(``ops/cuda_nw.py``, several jobs per warp), W > 32 to K2
(``ops/cuda_nw_long.py``, a warp or more per job, for long reads); each
raises outside its range.  A CPU
tensor goes to ``banded_nw_plain``, a PyTorch transcription of the
reference's XLA scan ``make_jax_banded_nw``.  K1 and K2 have one contract, so
``banded_nw_plain`` is the plain version of both, for every W.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from .._lazy import torch
from ..device import on_card, resolve, to_device
from .cuda_nw import MAX_W as K1_MAX_W
from .cuda_nw import banded_nw_cuda
from .cuda_nw_long import banded_nw_long_cuda

NEG = np.float32(-1e30)

# pointer bit layout per cell (uint8):
#   bits 0-1: D came from state {0=D,1=IY,2=IX} at (i-1, k)
#   bit 2:    IY came from IY (else D) at (i-1, k+1)
#   bit 3:    IX came from IX (else D) at (i,   k-1)


@dataclass(frozen=True)
class NWScoring:
    match: float = 2.0
    mismatch: float = -5.0
    gap_open: float = -6.0     # S_openGap + S_extendGap for the first gap char
    gap_extend: float = -2.0


def _substitution(read_col: np.ndarray, ref_col: np.ndarray,
                  sc: NWScoring) -> np.ndarray:
    """[B, W] substitution scores; padding code 4+ never matches and ref pad
    (code >= 4) is unalignable."""
    ok = (read_col[:, None] == ref_col) & (read_col[:, None] < 4)
    s = np.where(ok, np.float32(sc.match), np.float32(sc.mismatch))
    return np.where(ref_col >= 4, NEG, s).astype(np.float32)


def banded_nw_forward(reads: np.ndarray, read_lens: np.ndarray,
                      refs: np.ndarray, sc: NWScoring = NWScoring(),
                      use_native: bool = True, scratch: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Forward DP.

    reads: [B, L] uint8 base codes 0-3 (>=4 pad)
    read_lens: [B] actual lengths
    refs: [B, L + W] uint8 window codes (>=4 pad); W inferred as refs.shape[1]-L
    Returns (final_scores [B], final_k [B], final_state [B],
             pointers [B, L+1, W] uint8).
    Dispatches to the C++ kernel (native/hla_native.cpp) when built.
    scratch: optional reuse pool for the native outputs (the ~150 MB
    pointer tensor dominates wrapper time when freshly allocated) —
    callers passing it must consume the results before the next call.
    """
    if use_native:
        from .. import native
        out = native.nw_forward(reads, read_lens, refs, sc.match,
                                sc.mismatch, sc.gap_open, sc.gap_extend,
                                scratch=scratch) \
            if native.available() else None
        if out is not None:
            return out
    B, L = reads.shape
    W = refs.shape[1] - L
    assert W >= 2
    open_, ext = np.float32(sc.gap_open), np.float32(sc.gap_extend)

    D = np.zeros((B, W), dtype=np.float32)
    IY = np.full((B, W), NEG, dtype=np.float32)
    IX = np.full((B, W), NEG, dtype=np.float32)
    pointers = np.zeros((B, L + 1, W), dtype=np.uint8)

    best_score = np.full(B, NEG, dtype=np.float32)
    best_k = np.zeros(B, dtype=np.int32)
    best_state = np.zeros(B, dtype=np.int32)

    def harvest(i, D, IY, IX):
        nonlocal best_score, best_k, best_state
        at_end = read_lens == i
        if not at_end.any():
            return
        stacked = np.stack([D, IY, IX])          # [3, B, W]
        flat = stacked.transpose(1, 0, 2).reshape(B, 3 * W)
        arg = np.argmax(flat, axis=1)
        sc_ = flat[np.arange(B), arg]
        best_score = np.where(at_end, sc_, best_score)
        best_state = np.where(at_end, arg // W, best_state)
        best_k = np.where(at_end, arg % W, best_k)

    harvest(0, D, IY, IX)
    for i in range(1, L + 1):
        # substitution column: read char y[i-1] vs ref chars x[i-1+k], k=0..W-1
        read_col = reads[:, i - 1]
        ref_col = np.stack([refs[:, i - 1 + k] for k in range(W)], axis=1)
        sub = _substitution(read_col, ref_col, sc)

        prev_best = np.maximum(np.maximum(D, IY), IX)
        m_src = np.where(D >= np.maximum(IY, IX), 0,
                         np.where(IY >= IX, 1, 2)).astype(np.uint8)
        nD = prev_best + sub                                   # [B, W]

        # IY: from (i-1, k+1)
        D_sh = np.concatenate([D[:, 1:], np.full((B, 1), NEG, np.float32)], axis=1)
        IY_sh = np.concatenate([IY[:, 1:], np.full((B, 1), NEG, np.float32)], axis=1)
        open_cand = D_sh + open_
        ext_cand = IY_sh + ext
        nIY = np.maximum(open_cand, ext_cand)
        iy_src = (ext_cand > open_cand).astype(np.uint8)

        # IX: within-row scan over k ascending; consuming ref pad is invalid
        nIX = np.full((B, W), NEG, dtype=np.float32)
        ix_src = np.zeros((B, W), dtype=np.uint8)
        ref_ok = ref_col < 4
        for k in range(1, W):
            oc = nD[:, k - 1] + open_
            ec = nIX[:, k - 1] + ext
            v = np.maximum(oc, ec)
            nIX[:, k] = np.where(ref_ok[:, k], v, NEG)
            ix_src[:, k] = (ec > oc).astype(np.uint8)

        pointers[:, i] = (m_src | (iy_src << 2) | (ix_src << 3))
        D, IY, IX = nD, nIY, nIX
        harvest(i, D, IY, IX)

    return best_score, best_k, best_state, pointers


CIGAR_M, CIGAR_I, CIGAR_D = 0, 1, 2


def banded_nw_backtrace(pointers: np.ndarray, read_len: int, end_k: int,
                        end_state: int) -> list[tuple[int, int, int]]:
    """Trace one read.  Returns ops list [(op, read_pos, ref_pos)] in forward
    order; read_pos/ref_pos are the 0-based positions consumed (op M consumes
    both, I consumes read only — ref_pos = next ref pos, D consumes ref only).
    Ref positions are window-relative (j = i + k)."""
    ops: list[tuple[int, int, int]] = []
    i, k, state = read_len, int(end_k), int(end_state)
    while i > 0 or state == 2:
        ptr = pointers[i, k]
        j = i + k
        if state == 0:
            if i == 0:
                break
            ops.append((CIGAR_M, i - 1, j - 1))
            state = int(ptr & 3)
            i -= 1
        elif state == 1:
            ops.append((CIGAR_I, i - 1, j))
            state = 1 if (ptr >> 2) & 1 else 0
            i -= 1
            k += 1
        else:
            ops.append((CIGAR_D, i, j - 1))
            state = 2 if (ptr >> 3) & 1 else 0
            k -= 1
        if k < 0 or k >= pointers.shape[1]:
            break
    ops.reverse()
    return ops


# ------------------------------------------------------------ device half
# the aligner's scoring, as the plain dict the device half passes around
DEFAULT_SCORING = {k: float(v) for k, v in asdict(NWScoring()).items()}


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
    neg = torch.tensor(float(NEG), dtype=f32, device=dev)
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
