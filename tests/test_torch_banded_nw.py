"""The port's plain PyTorch banded NW forward (the CPU side of K1) against
the reference's XLA scan, numpy forward and Pallas kernel (interpret mode):
bit-exact scores, end cells and pointer rows on every live row
(score > -1e29; fully unalignable rows tie-break freely and production
drops them, tests/test_pallas_nw.py:71-74)."""

import numpy as np
import pytest
import torch

from hla_la_tpu import native
from hla_la_tpu.ops.banded_nw import (banded_nw_backtrace, banded_nw_forward,
                                      make_jax_banded_nw)
from hla_la_tpu.ops.pallas_nw import make_pallas_banded_nw
from hla_la_tpu_torch.ops.banded_nw import (DEFAULT_SCORING,
                                            banded_nw_forward_torch)

torch.set_num_threads(1)
# the port aligner's scoring; the reference functions run their defaults
SC = DEFAULT_SCORING


def _world(seed, B, L, W, n_rate=0.0, pad_every=3, min_len=4):
    """tests/test_pallas_nw.py's worlds: random bases with N (code 4) at
    `n_rate` in reads and refs, suffix ref pads on every `pad_every`-th
    row, uneven lengths, and one empty read."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    refs = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    refs[rng.random(refs.shape) < n_rate] = 4
    for b in range(0, B, pad_every):
        refs[b, int(rng.integers(L // 2, L + W)):] = 4
    lens = rng.integers(min_len, L + 1, B).astype(np.int64)
    lens[1] = 0
    return reads, lens, refs


WORLDS = {
    "mixed_pads": dict(seed=1, B=40, L=24, W=16),
    "uneven_batch": dict(seed=2, B=13, L=16, W=8),
    "n_bases": dict(seed=3, B=96, L=64, W=16, n_rate=0.02, min_len=20),
    "short_read_band": dict(seed=4, B=48, L=40, W=32, n_rate=0.01),
}


def _port(reads, lens, refs):
    out = banded_nw_forward_torch(reads, lens, refs, SC, "cpu")
    return [t.numpy() for t in out]


def _assert_live_equal(got, want):
    live = np.asarray(want[0]) > -1e29
    assert live.sum() >= len(live) // 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a)[live],
                                      np.asarray(b)[live])


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_plain_matches_jax_scan(name):
    w = WORLDS[name]
    reads, lens, refs = _world(**w)
    want = make_jax_banded_nw(w["L"], w["W"])(reads, lens, refs)
    _assert_live_equal(_port(reads, lens, refs),
                       [np.asarray(x) for x in want])


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_plain_matches_numpy_forward(name):
    reads, lens, refs = _world(**WORLDS[name])
    want = banded_nw_forward(reads, lens, refs, use_native=False)
    got = _port(reads, lens, refs)
    _assert_live_equal(got, want)
    # the backtraces the aligner takes agree too
    for b in np.nonzero(want[0] > -1e29)[0]:
        assert (banded_nw_backtrace(got[3][b], int(lens[b]), int(got[1][b]),
                                    int(got[2][b]))
                == banded_nw_backtrace(want[3][b], int(lens[b]),
                                       int(want[1][b]), int(want[2][b])))


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_plain_matches_native_forward(name):
    """The C++ host forward, which the reference aligner runs by default."""
    assert native.available()
    reads, lens, refs = _world(**WORLDS[name])
    want = native.nw_forward(reads, lens, refs, SC["match"], SC["mismatch"],
                             SC["gap_open"], SC["gap_extend"])
    _assert_live_equal(_port(reads, lens, refs), want)


def test_plain_matches_pallas_interpret():
    w = WORLDS["mixed_pads"]
    reads, lens, refs = _world(**w)
    fwd = make_pallas_banded_nw(w["L"], w["W"], interpret=True, tb=8)
    want = [np.asarray(x) for x in fwd(reads, lens, refs)]
    _assert_live_equal(_port(reads, lens, refs), want)


def test_empty_read_harvests_row_zero():
    reads, lens, refs = _world(**WORLDS["mixed_pads"])
    score, end_k, end_state, ptr = _port(reads, lens, refs)
    assert lens[1] == 0
    assert (score[1], end_k[1], end_state[1]) == (0.0, 0, 0)
    assert not ptr[:, 0].any()


def test_output_contract():
    w = WORLDS["uneven_batch"]
    reads, lens, refs = _world(**w)
    out = banded_nw_forward_torch(reads, lens, refs, SC, "cpu")
    assert [t.dtype for t in out] == [torch.float32, torch.int32,
                                      torch.int32, torch.uint8]
    assert out[3].shape == (w["B"], w["L"] + 1, w["W"])
    assert out[3].is_contiguous()
    assert all(t.device.type == "cpu" for t in out)
