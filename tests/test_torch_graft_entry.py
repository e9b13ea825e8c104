"""The port's twin of ``__graft_entry__.py`` (``hla_la_tpu_torch/
graft_entry.py``) on the CPU against the reference.

``entry("cpu")`` runs the plain versions of K1 and K3; the reference entry
runs on the JAX CPU backend, where it takes ``make_jax_banded_nw``, its
plain NW.  Tolerances are those chip_smoke (u) holds cuda to: NW scores
exact, the pair matrix rtol 1e-6 / atol 1e-2 (measured: max abs 7.0e-3 on
values of -40,031 to -25,718, the reference summing its float32 terms in
float32), the marginal atol 1e-4 (measured: 3.2e-65).  The top two cluster
pairs of this seed are 148.5 log units apart: no near tie, so the marginal
is one-hot and the bar does not bind.  ``dryrun_multichip(2)`` runs on two
gloo ranks in its one spawn (measured: 23 s)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from hla_la_tpu_torch import graft_entry
from hla_la_tpu_torch.models.parallel_host import spawn_safe

torch.set_num_threads(1)
PAIR_RTOL, PAIR_ATOL, MARG_ATOL = 1e-6, 1e-2, 1e-4


def test_entry_matches_the_reference_entry():
    fn, args = graft_entry.entry("cpu")
    ref_fn, ref_args = ref_entry.entry()
    assert len(args) == len(ref_args) == 5
    for a, b in zip(args, ref_args):        # the same draws, in order
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = [t.numpy() for t in fn(*args)]
    want = [np.asarray(x) for x in jax.jit(ref_fn)(*ref_args)]
    s = graft_entry.ENTRY_SHAPES
    assert got[0].shape == (s["B"],) and got[1].shape == (s["C"], s["C"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=PAIR_RTOL,
                               atol=PAIR_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=MARG_ATOL)
    assert abs(got[2].sum() - want[2].sum()) < MARG_ATOL
    # the ordered formula: the full posterior, the diagonal once
    pair = got[1]
    post = np.exp(pair - pair.max())
    post /= post.sum()
    np.testing.assert_allclose(
        got[2], post.sum(1) + post.sum(0) - np.diag(post), atol=1e-12)


def test_entry_moves_numpy_arguments_and_refuses_a_missing_card(
        monkeypatch):
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.entry("cuda")


def test_host_marginal_is_the_triu_softmax():
    rng = np.random.default_rng(4)
    pair = rng.normal(-50, 3, (9, 9))
    pair = pair + pair.T
    C = len(pair)
    post = np.exp(pair - pair.max()) * np.triu(np.ones((C, C)))
    post /= post.sum()
    want = post.sum(1) + post.sum(0) - np.diag(post)
    np.testing.assert_allclose(graft_entry.host_marginal(pair), want,
                               atol=1e-12)


@pytest.mark.skipif(not spawn_safe(), reason="no file-backed __main__ to "
                                             "spawn from")
def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    """The three phases in one start of two ranks: the sharded kernel step,
    the typing step against the host formula, and the miniature world on
    two ranks with the calls of one."""
    rec = graft_entry.dryrun_multichip(2, "cpu")
    out = capsys.readouterr().out
    assert "dryrun phase kernel-step (B=256, C=32, R=128, 2x1 mesh)" in out
    assert "dryrun_multichip: e2e calls identical on 1 vs 2 ranks" in out
    assert rec["mesh"] == {"data": 2, "model": 1}
    assert rec["n_pairs"] >= graft_entry.DRYRUN_MIN_PAIRS
    assert sorted(rec["n_clusters"]) == sorted(graft_entry.DRYRUN_GENES)
    assert min(rec["n_clusters"].values()) >= graft_entry.DRYRUN_MIN_CLUSTERS
    assert rec["pair_err"] <= graft_entry.PAIR_TOL
    assert rec["marg_err"] <= graft_entry.MARG_TOL
    assert rec["q1_err"] < graft_entry.Q1_TOL
