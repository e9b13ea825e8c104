"""The plain reference: what K1, K2 and K3 compute, written out in PyTorch
and numpy.

It imports nothing of the port.  ``dtype`` is the precision it computes
in: float32 for K1 and K2, float64 for the GEMM and K3 as the reference;
for the control, the step below the port's float32: bfloat16 for K1, K2
and K3, TF32 for the GEMM (the port runs it in float32 with TF32 off).

- ``nw_forward``: the banded glocal affine-gap Needleman-Wunsch forward of
  the reference aligner (alignerBase.cpp:19-25 scoring: match +2,
  mismatch -5, a first gap character -6, each further -2), cell (i, k) for
  read prefix i and ref prefix i + k: row 0 free, the D/IY/IX recurrences,
  IX as a scan over k that a ref pad code ends, and at row read_len the
  first maximum over state-major [D, IY, IX] x k.  Pointer bits per cell:
  0-1 D's source state, 2 IY from IY, 3 IX from IX.
  Step by step, as written in the reference aligner; the tests hold
  ``nw_forward_wide`` to it.
- ``nw_forward_wide``: the same forward in numpy, the one that K1's and
  K2's jobs are compared with: K1's bands and K2's (33-1,024) and rows (a
  50 kb piece of a long read).  IX's scan over k is a max-plus prefix scan
  in log2(W) steps in place of W - 1, its values exact as the step-by-step
  scan's in float32 (every finite score an integer under 2**24; -1e30
  absorbs any such addend).  In ``"bfloat16"`` each sum is rounded to
  bfloat16; the scan adds a run of extensions before it rounds, so where
  scores pass 256 (bfloat16 no longer holds every integer) it can round
  otherwise than a step-by-step bfloat16 forward.
- ``cluster_ll``: the typer's cluster x read products, LL[c, r] = sum
  over typed columns j and channels h of onehot[c, j, h] x contrib[r, j,
  h] (and the same over the mismatch indicators), as one GEMM; ``tf32``
  rounds its inputs as TF32 tensor cores do (10 mantissa bits), for the
  control;
- ``pair_diff``: the bounded difference term of the diploid pair
  log-likelihood, acc[c1, c2] = sum over reads of 0.5 |a - b| +
  log1p(exp(-|a - b|)) with a = L[c1, r], b = L[c2, r], and log 2 for each
  zero-padded read up to rpad.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = -1e30


def nw_forward(reads: np.ndarray, lens: np.ndarray, refs: np.ndarray,
               sc: dict, dtype=torch.float32):
    """reads [B, L] u8, lens [B], refs [B, L + W] u8 -> (score [B],
    end_k [B], end_state [B], pointers [B, L + 1, W] u8) as numpy."""
    rd = torch.as_tensor(np.asarray(reads)).long()
    rf = torch.as_tensor(np.asarray(refs)).long()
    ln = torch.as_tensor(np.asarray(lens)).long()
    B, L = rd.shape
    W = rf.shape[1] - L

    def c(v):
        return torch.tensor(v, dtype=dtype)

    neg, match, mismatch = c(NEG), c(sc["match"]), c(sc["mismatch"])
    open_, ext = c(sc["gap_open"]), c(sc["gap_extend"])
    D = torch.zeros((B, W), dtype=dtype)
    IY = torch.full((B, W), NEG, dtype=dtype)
    IX = torch.full((B, W), NEG, dtype=dtype)
    neg_col = torch.full((B, 1), NEG, dtype=dtype)
    pointers = torch.zeros((B, L + 1, W), dtype=torch.uint8)
    best_s = torch.full((B,), NEG, dtype=dtype)
    best_k = torch.zeros(B, dtype=torch.int64)
    best_st = torch.zeros(B, dtype=torch.int64)
    rows = torch.arange(B)

    def harvest(i):
        at = ln == i
        if bool(at.any()):
            flat = torch.stack([D, IY, IX], dim=1).reshape(B, 3 * W)
            arg = torch.argmax(flat, dim=1)
            best_s[at] = flat[rows, arg][at]
            best_st[at] = (arg // W)[at]
            best_k[at] = (arg % W)[at]

    harvest(0)
    for i in range(1, L + 1):
        read_col = rd[:, i - 1:i]
        ref_col = rf[:, i - 1:i - 1 + W]
        ok = (read_col == ref_col) & (read_col < 4)
        sub = torch.where(ok, match, mismatch)
        sub = torch.where(ref_col >= 4, neg, sub)
        iyx = torch.maximum(IY, IX)
        m_src = torch.where(D >= iyx, 0, torch.where(IY >= IX, 1, 2))
        nD = torch.maximum(D, iyx) + sub
        open_c = torch.cat([D[:, 1:], neg_col], 1) + open_
        ext_c = torch.cat([IY[:, 1:], neg_col], 1) + ext
        nIY = torch.maximum(open_c, ext_c)
        iy_src = (ext_c > open_c).long()
        nIX = torch.full((B, W), NEG, dtype=dtype)
        ix_src = torch.zeros((B, W), dtype=torch.int64)
        ref_ok = ref_col < 4
        for k in range(1, W):
            oc = nD[:, k - 1] + open_
            ec = nIX[:, k - 1] + ext
            nIX[:, k] = torch.where(ref_ok[:, k], torch.maximum(oc, ec), neg)
            ix_src[:, k] = (ec > oc).long()
        pointers[:, i] = (m_src | (iy_src << 2) | (ix_src << 3)).to(
            torch.uint8)
        D, IY, IX = nD, nIY, nIX
        harvest(i)
    return (best_s.float().numpy(), best_k.int().numpy(),
            best_st.int().numpy(), pointers.numpy())


def nw_forward_wide(reads: np.ndarray, lens: np.ndarray, refs: np.ndarray,
                    sc: dict, dtype: str = "float32"):
    """As ``nw_forward``, in numpy, for wide bands and long rows; `dtype`
    "float32" or "bfloat16"."""
    rnd = bf16 if dtype == "bfloat16" else (lambda x: x)
    reads, refs = np.asarray(reads), np.asarray(refs)
    lens = np.asarray(lens).astype(np.int64)
    B, L = reads.shape
    W = refs.shape[1] - L
    f32 = np.float32
    neg = rnd(np.full(1, NEG, f32))[0]
    match, mismatch, open_, ext = (f32(sc[k]) for k in (
        "match", "mismatch", "gap_open", "gap_extend"))
    D = np.zeros((B, W), f32)
    IY = np.full((B, W), neg, f32)
    IX = np.full((B, W), neg, f32)
    pointers = np.zeros((B, L + 1, W), np.uint8)
    best_s = np.full(B, neg, f32)
    best_k = np.zeros(B, np.int32)
    best_st = np.zeros(B, np.int32)
    band = np.lib.stride_tricks.sliding_window_view(refs, W, axis=1)
    ends: dict[int, list[int]] = {}
    for b, n in enumerate(lens.tolist()):
        ends.setdefault(n, []).append(b)

    def harvest(i):
        at = ends.get(i)
        if at:
            flat = np.concatenate([D[at], IY[at], IX[at]], axis=1)
            arg = np.argmax(flat, axis=1)
            best_s[at] = flat[np.arange(len(at)), arg]
            best_st[at] = arg // W
            best_k[at] = arg % W

    A = np.empty((B, W), f32)
    E = np.empty((B, W), f32)
    harvest(0)
    for i in range(1, L + 1):
        read_col = reads[:, i - 1:i]
        ref_col = band[:, i - 1]
        ref_ok = ref_col < 4
        sub = np.where((read_col == ref_col) & (read_col < 4), match,
                       mismatch)
        sub[~ref_ok] = neg
        iyx = np.maximum(IY, IX)
        ptr = np.where(D >= iyx, 0, np.where(IY >= IX, 1, 2)
                       ).astype(np.uint8)
        nD = rnd(np.maximum(D, iyx) + sub)
        oc = np.full((B, W), neg, f32)
        oc[:, :-1] = rnd(D[:, 1:] + open_)
        ec = np.full((B, W), neg, f32)
        ec[:, :-1] = rnd(IY[:, 1:] + ext)
        nIY = np.maximum(oc, ec)
        ptr |= (ec > oc).view(np.uint8) << 2
        # IX[k] = ref_ok[k] ? max(nD[k-1] + open, IX[k-1] + ext) : NEG,
        # IX[0] = NEG: k's step is x -> max(A[k], x + E[k]); the scan
        # composes steps k - 2 sh .. k - sh with k - sh .. k
        d_open = rnd(nD + open_)
        A[:, 0] = neg
        A[:, 1:] = d_open[:, :-1]
        A[~ref_ok] = neg
        E[:] = ext
        E[~ref_ok] = -np.inf
        E[:, 0] = -np.inf
        sh = 1
        while sh < W:
            np.maximum(A[:, sh:], rnd(A[:, :-sh] + E[:, sh:]),
                       out=A[:, sh:])
            E[:, sh:] = E[:, :-sh] + E[:, sh:]
            sh *= 2
        nIX = np.maximum(A, rnd(neg + E))
        ptr[:, 1:] |= (rnd(nIX[:, :-1] + ext) > d_open[:, :-1]
                       ).view(np.uint8) << 3
        pointers[:, i] = ptr
        D, IY, IX = nD, nIY, nIX
        harvest(i)
    return best_s, best_k, best_st, pointers


def pair_diff(L: np.ndarray, rpad: int, device="cpu", dtype=torch.float64,
              cells: float = 2e8) -> np.ndarray:
    """acc [C, C] (float64 numpy) from L [C, R], computed in `dtype` on
    `device` in blocks of rows of at most `cells` elements."""
    Lt = torch.as_tensor(np.asarray(L)).to(device=device, dtype=dtype)
    C, R = Lt.shape
    out = torch.empty((C, C), dtype=torch.float64, device=device)
    half = torch.tensor(0.5, dtype=dtype, device=device)
    step = max(1, int(cells // max(C * R, 1)))
    for lo in range(0, C, step):
        d = (Lt[lo:lo + step, None, :] - Lt[None, :, :]).abs()
        term = half * d + torch.log1p(torch.exp(-d))
        out[lo:lo + step] = term.sum(dim=2).to(torch.float64)
    pad = torch.tensor((rpad - R) * math.log(2.0), dtype=dtype)
    return (out + pad.to(torch.float64).to(device)).cpu().numpy()


def _round_mantissa(x: np.ndarray, drop: int) -> np.ndarray:
    """float32 `x` with its `drop` lowest mantissa bits rounded off (to
    nearest, ties to even), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = b.astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    b = (b + half + ((b >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return b.astype(np.uint32).view(np.float32)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 `x` rounded to TF32's 10 mantissa bits, as float32."""
    return _round_mantissa(x, 13)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 `x` rounded to bfloat16's 7 mantissa bits, as float32."""
    return _round_mantissa(x, 16)


def cluster_ll(onehot: np.ndarray, rows: np.ndarray, device="cpu",
               dtype=torch.float64) -> np.ndarray:
    """[C, R] float64 numpy: onehot [C, J, 6] against rows [R, J, 6], in
    `dtype` on `device`; dtype "tf32": TF32-rounded inputs, float32
    products and sums."""
    C = onehot.shape[0]
    R = rows.shape[0]
    a = np.asarray(onehot, dtype=np.float32).reshape(C, -1)
    b = np.asarray(rows, dtype=np.float32).reshape(R, -1)
    if dtype == "tf32":
        a, b, dtype = tf32(a), tf32(b), torch.float32
    A = torch.as_tensor(a).to(device=device, dtype=dtype)
    B = torch.as_tensor(b).to(device=device, dtype=dtype)
    return (A @ B.T).to(torch.float64).cpu().numpy()
