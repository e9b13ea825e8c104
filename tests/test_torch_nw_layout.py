"""The lane decomposition of K1 and K2 (``csrc/banded_nw_row.cuh``), modelled
in numpy and held bit-exact to the port's plain version and to the JAX
package, and the launch plan that picks it (``ops/cuda_nw.nw_launch_plan``).

The model repeats the kernels' row step as they run it: a job's band cells
sit CPT to a lane on G lanes (32 per warp, several warps past that); read
and ref codes come from 32-bit words staged chunk by chunk, the lane's ref
window cut from them by a funnel shift; D and IY are plain per-cell code
with one value handed down from the next lane; IX is a running max inside
the lane, restarted at a masked ref code, then a segmented max-scan across
the lanes steered by the bit mask of lanes that hold a masked code, then
the carry folded back into the lane; pointer bytes are packed into words;
the harvest keeps a lane-local first argmax and reduces it at the end.
Every float32 operation is numpy's, in the kernels' order.
"""

import numpy as np
import pytest
import torch

from hla_la_tpu.ops.banded_nw import make_jax_banded_nw
from hla_la_tpu.ops.pallas_nw import make_pallas_banded_nw_long
from hla_la_tpu_torch.ops import cuda_nw
from hla_la_tpu_torch.ops.banded_nw import (DEFAULT_SCORING,
                                            banded_nw_forward_torch)
from hla_la_tpu_torch.ops.cuda_nw import nw_launch_plan

torch.set_num_threads(1)
SC = DEFAULT_SCORING
NEG = np.float32(-1e30)
f32 = np.float32


def _load4(flat: np.ndarray, off: np.ndarray) -> np.ndarray:
    """The kernels' staging load: bytes [off, off + 4) of the whole tensor
    as one little-endian word, bytes past its end read as the pad code."""
    idx = off[..., None] + np.arange(4)
    b = np.where(idx < flat.size, flat[np.minimum(idx, flat.size - 1)],
                 4).astype(np.uint32)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _funnel(lo: np.ndarray, hi: np.ndarray, sh: int) -> np.ndarray:
    """__funnelshift_r(lo, hi, sh) for sh in 0..24."""
    both = lo.astype(np.uint64) | hi.astype(np.uint64) << np.uint64(32)
    return (both >> np.uint64(sh)).astype(np.uint32)


def lane_model(reads, lens, refs, sc, cpt: int, lanes: int, chunk: int,
               masks: bool = True):
    """K1/K2's forward on `lanes` lanes per job (warps of 32 past that),
    `cpt` cells each, rows staged `chunk` at a time.  masks=False is the
    copy of the row step that a warp-row without masked codes takes."""
    B, L = reads.shape
    W = refs.shape[1] - L
    G = min(lanes, 32)                  # lanes of a job inside one warp
    NW = max(1, lanes // 32)            # warps per job
    assert lanes * cpt >= W and chunk % 4 == 0
    wpc = -(-cpt // 4)                  # words of a lane's window
    match, mismatch = f32(sc["match"]), f32(sc["mismatch"])
    open_, ext = f32(sc["gap_open"]), f32(sc["gap_extend"])
    gt = np.arange(lanes)                         # lane within the job
    gl = gt % G                                   # lane within its warp
    k = gt[:, None] * cpt + np.arange(cpt)        # [lanes, cpt]
    inband = k < W
    kext = k.astype(f32) * ext
    tk = (open_ + kext) - ext
    g_last = (W - 1) // cpt

    D = np.broadcast_to(np.where(inband, f32(0), NEG), (B, lanes, cpt)).copy()
    IY = np.full((B, lanes, cpt), NEG, f32)
    IX = np.full((B, lanes, cpt), NEG, f32)
    snap_v = np.full((B, lanes), -np.inf, f32)
    snap_i = np.full((B, lanes), 2**31 - 1, np.int64)
    pointers = np.full((B, L + 1, W), 0xEE, np.uint8)
    flat_ptr = pointers.reshape(-1)
    reads_flat, refs_flat = reads.reshape(-1), refs.reshape(-1)
    jobs = np.arange(B)

    def snapshot(i):
        at = lens == i
        v = np.stack([D, IY, IX], axis=2)                  # [B, lanes, 3, cpt]
        idx = (np.arange(3)[:, None, None] * W + k[None]).transpose(1, 0, 2)
        v = np.where(inband[None, :, None, :], v, -np.inf)
        idx = np.where(inband[:, None, :], idx, 2**31 - 1)
        vf = v.reshape(B, lanes, 3 * cpt)
        idf = np.broadcast_to(idx.reshape(lanes, 3 * cpt), vf.shape)
        best = vf.max(axis=2)
        bi = np.where(vf == best[..., None], idf, 2**31 - 1).min(axis=2)
        snap_v[at], snap_i[at] = best[at], bi[at]

    def store_row(i, bytes_):
        """bytes_ [B, lanes, cpt]: one cpt-byte piece per lane where the
        band is a multiple of cpt, else byte by byte; lanes past the band
        store nothing."""
        base = (jobs[:, None] * (L + 1) + i) * W + gt[None] * cpt
        if W % cpt == 0:
            live = np.broadcast_to(gt * cpt < W, base.shape)
            assert (base % cpt == 0).all()      # a piece never straddles
            piece = np.zeros((B, lanes), np.uint64)
            for c in range(cpt):
                piece |= bytes_[..., c].astype(np.uint64) << np.uint64(8 * c)
            for c in range(cpt):
                flat_ptr[base[live] + c] = (
                    piece[live] >> np.uint64(8 * c)) & np.uint64(0xFF)
        else:
            for c in range(cpt):
                live = np.broadcast_to(inband[:, c], base.shape)
                flat_ptr[base[live] + c] = bytes_[..., c][live]

    store_row(0, np.zeros((B, lanes, cpt), np.uint8))
    snapshot(0)
    for i0 in range(0, L, chunk):
        # staging: read words, then the ref words the lanes' windows reach
        rd_words = _load4(reads_flat, jobs[:, None] * L + i0
                          + 4 * np.arange(chunk // 4)[None])
        n_ref = chunk // 4 + -(-lanes * cpt // 4) + 1
        ref_words = _load4(refs_flat, jobs[:, None] * (L + W) + i0
                           + 4 * np.arange(n_ref)[None])
        for r in range(min(chunk, L - i0)):
            i = i0 + r + 1
            q, u = divmod(r, 4)
            rc = (rd_words[:, q] >> (8 * u)) & 0xFF                  # [B]
            fc = np.empty((B, lanes, cpt), np.uint32)
            word, shift = np.divmod(gt * cpt + r, 4)   # shift = u at cpt 4, 8
            for j in range(wpc):
                lo = ref_words[:, word + j]
                hi = ref_words[:, word + j + 1]
                w = np.stack([_funnel(lo[:, g], hi[:, g], 8 * int(shift[g]))
                              for g in range(lanes)], axis=1)
                for s in range(min(4, cpt - 4 * j)):
                    fc[..., 4 * j + s] = (w >> (8 * s)) & 0xFF
            masked = (fc > 3) & masks
            sub = np.where(masked, NEG,
                           np.where(fc == rc[:, None, None], match, mismatch)
                           ).astype(f32)

            # D and IY; the next lane's first cell comes down one lane, the
            # lane that ends the band takes NEG
            Dn = np.concatenate([D[:, 1:, 0], np.full((B, 1), NEG)], axis=1)
            IYn = np.concatenate([IY[:, 1:, 0], np.full((B, 1), NEG)], axis=1)
            edge = gt >= g_last
            Dn = np.where(edge, NEG, Dn).astype(f32)
            IYn = np.where(edge, NEG, IYn).astype(f32)
            D_src = np.concatenate([D[..., 1:], Dn[..., None]], axis=2)
            IY_src = np.concatenate([IY[..., 1:], IYn[..., None]], axis=2)
            iyix = np.maximum(IY, IX)
            pb = np.maximum(np.maximum(D, IY), IX)
            m_src = np.where(D >= iyix, 0, np.where(IY >= IX, 1, 2))
            nD = pb + sub
            oc = D_src + open_
            ec = IY_src + ext
            nIY = np.maximum(oc, ec)
            iy_src = ec > oc

            # the lane's running max of g with restart: pre[c] before cell
            # c, total over all cells
            gv = np.where(masked, NEG, nD - kext).astype(f32)
            pre = np.empty((B, lanes, cpt), f32)
            total = np.full((B, lanes), NEG, f32)
            for c in range(cpt):
                pre[..., c] = total
                total = np.where(masked[..., c], NEG,
                                 np.maximum(total, gv[..., c]))
            has = masked.any(axis=2)                        # [B, lanes]
            # the warp's ballot, one bit per lane of the warp
            hm = (has.reshape(B, NW, G).astype(np.uint64)
                  << np.arange(G, dtype=np.uint64)).sum(axis=2)
            hm = np.repeat(hm, G, axis=1)                   # [B, lanes]
            zb = hm & ((np.uint64(1) << gl.astype(np.uint64)) - np.uint64(1))
            top = np.floor(np.log2(np.maximum(zb, 1).astype(np.float64))
                           ).astype(np.int64)
            near = np.where(zb > 0, gl - top, gl).reshape(B, NW, G)
            tw = total.reshape(B, NW, G)

            def up(x, sh):      # __shfl_up_sync(x, sh, G): own value below
                return np.concatenate([x[..., :sh], x[..., :-sh]], axis=2)

            # exclusive segmented max-scan across the warp's lanes
            if G >= 16:
                o = [up(tw, m) for m in (1, 2, 3, 4)]
                e = np.full((B, NW, G), NEG, f32)
                for m in (1, 2, 3, 4):
                    e = np.where(m <= near, np.maximum(e, o[m - 1]), e)
                base = 4
                while base < G:
                    q = {m: up(e, m * base) for m in (1, 2, 3)
                         if m * base < G}
                    for m, qm in q.items():
                        take = (m * base < near) if masks else True
                        e = np.where(take, np.maximum(e, qm), e)
                    base *= 4
            elif G > 1:
                e = np.where(near < 1, NEG, up(tw, 1)).astype(f32)
                sh = 1
                while sh < G - 1:
                    take = (sh < near) if masks else True
                    e = np.where(take, np.maximum(e, up(e, sh)), e)
                    sh *= 2
            else:
                e = np.full((B, NW, G), NEG, f32)
            carry = e.reshape(B, lanes)
            if NW > 1:
                # warp tails cross the seams; a warp with a masked code
                # restarts the carry
                last = G - 1
                tail = np.where(has.reshape(B, NW, G)[..., last],
                                tw[..., last],
                                np.maximum(e[..., last], tw[..., last]))
                wflag = hm.reshape(B, NW, G)[..., 0] != 0
                C = np.full((B, NW), NEG, f32)
                acc = np.full(B, NEG, f32)
                for w in range(NW):
                    C[:, w] = acc
                    acc = np.where(wflag[:, w], tail[:, w],
                                   np.maximum(acc, tail[:, w]))
                Cl = np.repeat(C, G, axis=1)
                carry = np.where(zb == 0, np.maximum(carry, Cl), carry)
            # the carry folded into the cells up to the lane's first masked
            # one; IX and its extend bit
            nIX = np.empty_like(nD)
            open_to_carry = np.ones((B, lanes), bool)
            for c in range(cpt):
                run = np.where(open_to_carry,
                               np.maximum(carry, pre[..., c]), pre[..., c])
                nIX[..., c] = np.where(masked[..., c], NEG, tk[:, c] + run)
                open_to_carry &= ~masked[..., c]
            bit = (nIX + ext) > (nD + open_)                # [B, lanes, cpt]
            prev = np.concatenate([np.zeros((B, 1), bool),
                                   bit[:, :-1, cpt - 1]], axis=1)
            ix_src = np.concatenate([prev[..., None], bit[..., :-1]], axis=2)

            store_row(i, (m_src | iy_src << 2 | ix_src << 3).astype(np.uint8))
            D, IY, IX = nD.astype(f32), nIY.astype(f32), nIX.astype(f32)
            if W % cpt:     # the cell at k = W must hand NEG to k = W - 1
                D = np.where(inband, D, NEG)
                IY = np.where(inband, IY, NEG)
            snapshot(i)

    best = snap_v.max(axis=1)
    bi = np.where(snap_v == best[:, None], snap_i, 2**31 - 1).min(axis=1)
    never = bi == 2**31 - 1
    score = np.where(never, NEG, best).astype(f32)
    bi = np.where(never, 0, bi)
    return (score, (bi % W).astype(np.int32), (bi // W).astype(np.int32),
            pointers)


def _world(seed, B, L, W, cpt):
    """Reads cut from their refs with substitutions and an indel drift; N
    in reads and refs, suffix pads, uneven lengths, an empty read, and in
    three jobs a wall of masked codes: inside a lane, at a lane's first
    cell and at a lane's last cell, each beside the read's path."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    pos = W // 2 + rng.integers(-2, 3, B)
    steps = (rng.random((B, L)) < 0.04) * rng.choice([-1, 1], (B, L))
    src = np.clip(pos[:, None] + np.arange(L)[None] + np.cumsum(steps, 1),
                  0, L + W - 1)
    reads = np.take_along_axis(refs, src, axis=1)
    sub = rng.random((B, L)) < 0.05
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    reads[rng.random((B, L)) < 0.01] = 4
    refs[rng.random((B, L + W)) < 0.004] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    lens[rng.random(B) < 0.4] = L
    lens[1] = 0
    for b in range(0, B, 5):
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    # walls: at row 1 the ref byte at column j sits in cell k = j
    lane0 = (W // 2 // cpt) * cpt
    for b, j in ((2, lane0 + 1), (3, lane0), (4, lane0 + cpt - 1)):
        if j + 2 < W:
            refs[b, j + 4:j + 6] = 4
    refs[6, 3:5] = 7        # a wall low in the band, another code
    reads[np.arange(L)[None] >= lens[:, None]] = 4
    return reads, lens, refs


def _plain(reads, lens, refs, sc=SC):
    return [t.numpy() for t in
            banded_nw_forward_torch(reads, lens, refs, sc, "cpu")]


def _assert_live_equal(got, want, min_live):
    live = np.asarray(want[0]) > -1e29
    assert live.sum() >= min_live
    for name, a, b in zip(("score", "end_k", "end_state", "pointers"),
                          got, want):
        np.testing.assert_array_equal(np.asarray(a)[live],
                                      np.asarray(b)[live], err_msg=name)


# the kernels are built for 4 and 8 cells per lane; 2 shows that the
# decomposition does not hang on it
LAYOUTS = [(4, 8, 32), (4, 8, 31), (4, 4, 10), (2, 16, 32), (4, 1, 3),
           (4, 2, 5),
           (4, 16, 64), (4, 32, 100), (8, 32, 256), (8, 32, 160),
           (8, 32, 100), (8, 32, 33), (8, 96, 600), (4, 64, 256),
           (8, 64, 257), (4, 96, 330), (8, 128, 1024)]


@pytest.mark.parametrize("cpt,lanes,W", LAYOUTS)
@pytest.mark.parametrize("chunk", [8, 1024])
def test_lane_model_matches_plain(cpt, lanes, W, chunk):
    B, L = 24, 37 if W < 300 else 21
    reads, lens, refs = _world(W * 31 + cpt + lanes, B, L, W, cpt)
    got = lane_model(reads, lens, refs, SC, cpt, lanes, chunk)
    want = _plain(reads, lens, refs)
    _assert_live_equal(got, want, B // 3)
    # every pointer byte of every job was written
    assert not (got[3] == 0xEE).any()
    assert not got[3][:, 0].any()
    assert (got[0][1], got[1][1], got[2][1]) == (0.0, 0, 0)


@pytest.mark.parametrize("cpt,lanes,W", [(4, 8, 32), (4, 8, 31)])
def test_lane_model_matches_jax_scan(cpt, lanes, W):
    B, L = 24, 37
    reads, lens, refs = _world(5 + W, B, L, W, cpt)
    got = lane_model(reads, lens, refs, SC, cpt, lanes, 16)
    want = [np.asarray(x) for x in make_jax_banded_nw(L, W)(reads, lens, refs)]
    _assert_live_equal(got, want, B // 3)


@pytest.mark.parametrize("cpt,lanes,W", [(4, 16, 48), (8, 32, 64)])
def test_lane_model_matches_pallas_long_interpret(cpt, lanes, W):
    B, L = 8, 64
    reads, lens, refs = _world(9 + W, B, L, W, cpt)
    got = lane_model(reads, lens, refs, SC, cpt, lanes, 16)
    fwd = make_pallas_banded_nw_long(L, W, rc=16, interpret=True)
    want = [np.asarray(x) for x in fwd(reads, lens, refs)]
    _assert_live_equal(got, want, 3)


@pytest.mark.parametrize("cpt,lanes,W", [(4, 8, 32), (8, 32, 256),
                                         (4, 32, 100), (4, 16, 50)])
def test_the_path_without_masks_equals_the_one_with(cpt, lanes, W):
    """A warp-row in which no lane's window holds a masked code takes the
    row step without restarts and segments (cells past the band read
    whatever follows the window and feed nothing)."""
    B, L = 16, 29
    rng = np.random.default_rng(W)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = refs[:, W // 2:W // 2 + L].copy()
    reads[rng.random((B, L)) < 0.1] = 2
    reads[3, 5] = 4                     # an N in a read masks nothing
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    got = lane_model(reads, lens, refs, SC, cpt, lanes, 8, masks=False)
    want = lane_model(reads, lens, refs, SC, cpt, lanes, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _assert_live_equal(got, _plain(reads, lens, refs), B)


def test_walls_cut_the_carry_where_they_stand():
    """A wall inside a lane stops the carry for the cells after it and not
    for those before it: the model still equals the plain version when
    every job has walls at every position of one lane."""
    cpt, lanes, W, L = 8, 32, 256, 12
    rng = np.random.default_rng(0)
    B = 3 * cpt
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = refs[:, W // 2:W // 2 + L].copy()
    for b in range(B):
        refs[b, 40 + b] = 4      # crosses lanes 5..7 cell by cell, off path
    lens = np.full(B, L, np.int64)
    got = lane_model(reads, lens, refs, SC, cpt, lanes, 8)
    _assert_live_equal(got, _plain(reads, lens, refs), B)


# the assembly typer's unit scoring: match 0 and every penalty -1, so that
# almost every maximum of the row step is a tie
EDIT = {"match": 0.0, "mismatch": -1.0, "gap_open": -1.0, "gap_extend": -1.0}


def _exon_world(seed, B, L, W):
    """The assembly typer's jobs: allele sequences of ragged lengths, padded
    with code 4, all against ONE contig window; alleles differ from the
    window by a few substitutions and a short indel; the window ends a few
    bases short of L + W, as at a contig's end."""
    rng = np.random.default_rng(seed)
    window = rng.integers(0, 4, L + W).astype(np.uint8)
    window[L + W - 5:] = 4
    lens = rng.integers(L - 6, L + 1, B).astype(np.int64)
    lens[0] = L
    reads = np.full((B, L), 4, np.uint8)
    for b in range(B):
        a = list(window[W // 2:W // 2 + L + 4])
        for _ in range(int(rng.integers(0, 4))):
            a[int(rng.integers(0, L))] = int(rng.integers(0, 4))
        if b % 3 == 1:
            del a[int(rng.integers(1, L - 1))]
        if b % 3 == 2:
            a.insert(int(rng.integers(1, L - 1)), int(rng.integers(0, 4)))
        reads[b, :lens[b]] = a[:lens[b]]
    return reads, lens, np.repeat(window[None], B, axis=0)


@pytest.mark.parametrize("chunk", [8, 1024])
@pytest.mark.parametrize("world", ["exons", "reads"])
def test_lane_model_matches_plain_under_unit_scoring(world, chunk):
    """K2's plan for the assembly typer's band of 48 (four cells on each of
    16 lanes) under unit scoring, where D, IY and IX tie all the time: the
    pointers follow the plain version's >= and >, the harvest its first
    argmax."""
    plan = nw_launch_plan(2200, 270, 48)
    assert (plan.cpt, plan.lanes, plan.job_warps) == (4, 16, 1)
    B, L, W = 24, 37, 48
    reads, lens, refs = (_exon_world(7, B, L, W) if world == "exons"
                         else _world(11, B, L, W, plan.cpt))
    got = lane_model(reads, lens, refs, EDIT, plan.cpt, plan.lanes, chunk)
    want = _plain(reads, lens, refs, EDIT)
    _assert_live_equal(got, want, B // 3)
    if world == "exons":
        assert (want[0] > -1e29).all() and (want[0] <= 0).all()
        assert len(set(want[0].tolist())) > 2


@pytest.mark.parametrize("end", ["left", "right", "both"])
@pytest.mark.parametrize("sc", [SC, EDIT], ids=["aligner", "unit"])
def test_lane_model_matches_plain_on_windows_off_a_haplotypes_ends(end, sc):
    """The linear-ALT typer's windows at a haplotype's ends at W = 32:
    pad codes before the haplotype's first base, after its last, or both
    (a haplotype shorter than the window), so that most of the band is
    masked in every row."""
    cpt, lanes, W, B, L = 4, 8, 32, 24, 37
    rng = np.random.default_rng(W + len(end))
    hap = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = hap[:, W // 2:W // 2 + L].copy()
    reads[rng.random((B, L)) < 0.05] = 1
    refs = hap.copy()
    off = rng.integers(1, W // 2 + 1, B)
    col = np.arange(L + W)[None]
    if end in ("left", "both"):      # the haplotype starts inside the band
        refs[col < off[:, None]] = 4
    if end in ("right", "both"):     # and ends before the read does
        refs[col >= (L + W // 2 - off + 4)[:, None]] = 4
    lens = np.full(B, L, np.int64)
    lens[::4] = L - 5
    reads[np.arange(L)[None] >= lens[:, None]] = 4
    got = lane_model(reads, lens, refs, sc, cpt, lanes, 8)
    want = _plain(reads, lens, refs, sc)
    _assert_live_equal(got, want, B)


# ------------------------------------------------------------ launch plan
PLAN_B = (1, 128, 838, 65536)


@pytest.mark.parametrize("B", PLAN_B)
def test_launch_plan_covers_every_band(B):
    for W in range(2, 1025):
        for L in (1, 101, 10000, 16384):
            p = nw_launch_plan(B, L, W)
            assert p == nw_launch_plan(B, L, W)
            # an instantiation csrc/banded_nw.cu or banded_nw_long.cu has
            assert (p.cpt, p.lanes, p.job_warps > 1) in (
                [(4, g, False) for g in (1, 2, 4, 8, 16, 32)]
                + [(8, 32, False), (8, 32, True)])
            assert p.cpt * p.lanes * p.job_warps >= W
            assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
            if W <= cuda_nw.MAX_W:
                assert p.job_warps == 1 and p.lanes <= 8
            if p.job_warps > 1:
                assert p.lanes == 32 and p.block_warps == p.job_warps
                assert p.job_warps <= cuda_nw.MAX_JOB_WARPS
            assert p.threads == 32 * p.block_warps <= 1024
            assert p.chunk % 4 == 0 and 4 <= p.chunk <= cuda_nw.CHUNK_ROWS
            assert p.chunk >= min(L, 64)
            need = p.chunk // 2 + p.lanes * p.job_warps * p.cpt // 4
            assert p.job_words >= need
            assert p.smem_bytes == 4 * p.job_words * p.jobs_per_block
            assert p.smem_bytes <= cuda_nw.SMEM_BUDGET < 227 * 1024
            assert p.blocks * p.jobs_per_block >= B
            assert (p.blocks - 1) * p.jobs_per_block < B


def test_launch_plan_at_the_main_paths_shapes():
    short = nw_launch_plan(65536, 101, 32)
    assert (short.cpt, short.lanes, short.job_warps) == (4, 8, 1)
    assert short.jobs_per_block == 16
    for B in (838, 128):     # one warp per job, few jobs or many
        long_ = nw_launch_plan(B, 10000, 256)
        assert (long_.cpt, long_.lanes, long_.job_warps) == (8, 32, 1)
        assert long_.blocks == B
    wide = nw_launch_plan(64, 1000, 600)
    assert (wide.cpt, wide.lanes, wide.job_warps) == (8, 32, 3)


def test_launch_plan_refuses_what_no_kernel_covers():
    with pytest.raises(ValueError):
        nw_launch_plan(8, 100, 1)
    with pytest.raises(ValueError):
        nw_launch_plan(8, 100, 1025)
