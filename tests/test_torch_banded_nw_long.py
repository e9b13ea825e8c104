"""The port's plain PyTorch banded NW forward at bands wider than a warp
(the CPU side of K2, which shares K1's plain version) against the
reference's row-chunked long-read Pallas kernel in interpret mode, its
numpy forward and its native host forward: bit-exact scores, end cells and
pointer rows on every live row (score > -1e29), on the world of
tests/test_pallas_nw.py:79-126 (N bases in a read, a masked ref wall, an
empty read, ends spread across row chunks)."""

import numpy as np
import pytest
import torch

from hla_la_tpu import native
from hla_la_tpu.ops.banded_nw import banded_nw_backtrace, banded_nw_forward
from hla_la_tpu.ops.pallas_nw import make_pallas_banded_nw_long
from hla_la_tpu_torch.ops.banded_nw import (DEFAULT_SCORING,
                                            banded_nw_forward_torch)

torch.set_num_threads(1)
SC = DEFAULT_SCORING
L, B, RC = 64, 7, 16


def _long_world(W, seed=5):
    """tests/test_pallas_nw.py's long-kernel world at band W: reads that
    follow their ref from offset W // 2 with skips, insertions and
    substitutions; N bases in read 0, a masked wall in ref 2, an empty
    read 3, lengths spread over the row chunks."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads = np.empty((B, L), np.uint8)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int64)
    for b in range(B):
        pos = W // 2
        out = []
        while len(out) < L and pos < L + W - 1:
            r = rng.random()
            if r < 0.05:
                pos += 1
                continue
            if r < 0.1:
                out.append(rng.integers(0, 4))
                continue
            c = refs[b, pos]
            if rng.random() < 0.05:
                c = (c + 1) % 4
            out.append(c)
            pos += 1
        while len(out) < L:
            out.append(0)
        reads[b] = out
    reads[0, 10:13] = 5
    # the wall crosses the read's path and, over the rows, every warp
    refs[2, W // 2 + 20:W // 2 + 24] = 4
    lens[3] = 0
    return reads, lens, refs


def _port(reads, lens, refs):
    out = banded_nw_forward_torch(reads, lens, refs, SC, "cpu")
    return [t.numpy() for t in out]


def _assert_live_equal(got, want):
    live = np.asarray(want[0]) > -1e29
    assert live.sum() >= len(live) - 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a)[live],
                                      np.asarray(b)[live])


@pytest.mark.parametrize("W", [48, 64])
def test_plain_matches_pallas_long_interpret(W):
    reads, lens, refs = _long_world(W)
    fwd = make_pallas_banded_nw_long(L, W, rc=RC, interpret=True)
    want = [np.asarray(x) for x in fwd(reads, lens, refs)]
    _assert_live_equal(_port(reads, lens, refs), want)


@pytest.mark.parametrize("W", [160, 256])
def test_plain_matches_numpy_forward(W):
    reads, lens, refs = _long_world(W)
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    got = _port(reads, lens, refs)
    _assert_live_equal(got, want)
    for b in np.nonzero(want[0] > -1e29)[0]:
        assert (banded_nw_backtrace(got[3][b], int(lens[b]), int(got[1][b]),
                                    int(got[2][b]))
                == banded_nw_backtrace(want[3][b], int(lens[b]),
                                       int(want[1][b]), int(want[2][b])))


@pytest.mark.parametrize("W", [160, 256])
def test_plain_matches_native_forward(W):
    """The C++ host forward, which the reference aligner runs on long
    reads by default."""
    assert native.available()
    reads, lens, refs = _long_world(W)
    want = native.nw_forward(reads, lens, refs, SC["match"], SC["mismatch"],
                             SC["gap_open"], SC["gap_extend"])
    _assert_live_equal(_port(reads, lens, refs), want)


def test_wall_and_empty_read():
    """The masked wall costs job 2 its alignment along the path the read
    was cut from; the empty read harvests row 0."""
    reads, lens, refs = _long_world(64)
    score, end_k, end_state, ptr = _port(reads, lens, refs)
    refs[2, refs[2] == 4] = 0
    no_wall = _port(reads, lens, refs)[0]
    assert score[2] < no_wall[2]
    assert (score[3], end_k[3], end_state[3]) == (0.0, 0, 0)
    assert not ptr[:, 0].any()
    assert (score[[0, 1, 4, 5, 6]] > 0).all()
