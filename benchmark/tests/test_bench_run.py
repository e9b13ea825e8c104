"""A tiny cell driven through the harness on the CPU (the look for a card
skipped): correct on the port as it is, false with the timed path broken
underneath, and no process left behind."""

import numpy as np
import pytest
import torch

from hlabench import harness, reference
from tiny import cell_limits, cells, tiny_checkout

SEED = 2**31 + 99


def run(tmp_path, max_threads=1, traced=False, limits_of=None):
    bench = tiny_checkout(str(tmp_path), max_threads=max_threads,
                          **({"limits_of": limits_of} if limits_of else {}))
    return harness.run("tiny", SEED, 2.0, traced, str(tmp_path),
                       device="cpu", bench_dir=bench)


def test_pooled_traced_run_is_correct_and_leaves_no_process(tmp_path):
    res = run(tmp_path, max_threads=2, traced=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {"pipeline.rest_s", "aligner.align_s",
            "typer.type_s"} <= set(res["metrics"])
    assert res["checks"]["k1_jobs_differ"]["value"] == 0
    assert harness.reap() == []
    assert harness.children() == []


def test_one_process_run_reports_the_end_to_end_metrics(tmp_path):
    res = run(tmp_path)
    assert res["correct"]
    assert set(res["metrics"]) == {"sample_s", "setup_s"}
    assert res["metrics"]["sample_s"]["value"] > 0


def _nw_zeroed(fn):          # a step that returns its state unchanged
    def f(*a, **k):
        return tuple(torch.zeros_like(t) for t in fn(*a, **k))
    return f


def _nw_half(fn):            # half of the batch left out
    def f(reads, lens, refs, sc):
        n = (len(reads) + 1) // 2
        out = fn(reads[:n], lens[:n], refs[:n], sc)
        return tuple(torch.cat([t, t[:len(reads) - n]]) for t in out)
    return f


def _nw_altered(fn):         # answers altered where they are produced:
    def f(*a, **k):          # one job in 16, as a broken lane would
        out = list(fn(*a, **k))
        out[0] = out[0].clone()
        out[0][::16] += 2.0
        return tuple(out)
    return f


def _k3_half(fn):            # half of the reads, the mean taken over them
    def f(L, **k):
        R = L.shape[1]
        acc, rpad = fn(L[:, :R // 2].contiguous(), **k)
        return acc * (R / (R // 2)), rpad
    return f


def _k3_altered(fn):
    def f(L, **k):
        acc, rpad = fn(L, **k)
        acc = acc.clone()
        acc[0, 1] += 1.0
        return acc, rpad
    return f


FAULTS = {"nw_state_unchanged": ("banded_nw", "banded_nw_plain", _nw_zeroed),
          "nw_half_batch": ("banded_nw", "banded_nw_plain", _nw_half),
          "nw_answer_altered": ("banded_nw", "banded_nw_plain", _nw_altered),
          "k3_half_reads": ("pair_ll", "pair_ll_diff_plain", _k3_half),
          "k3_answer_altered": ("pair_ll", "pair_ll_diff_plain",
                                _k3_altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from hla_la_tpu_torch.ops import banded_nw, pair_ll
    mod = {"banded_nw": banded_nw, "pair_ll": pair_ll}[FAULTS[fault][0]]
    name, wrap = FAULTS[fault][1:]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res = run(tmp_path)
    assert not res["correct"]


def _k3_bf16(fn):            # the control: K3 in bfloat16
    def f(L, *a, **k):
        acc, rpad = fn(L, *a, **k)
        low = reference.pair_diff(L.cpu().numpy(), rpad,
                                  dtype=torch.bfloat16)
        return torch.from_numpy(low).to(acc.dtype), rpad
    return f


def _ll_tf32(fn):            # the control: the GEMM in TF32
    def f(onehot, contrib, mismatch, device, out=None):
        got = [reference.cluster_ll(onehot, rows, "cpu", "tf32"
                                    ).astype(np.float32)
               for rows in (contrib, mismatch)]
        if out is None:
            return tuple(got)
        for dst, g in zip(out, got):
            dst[...] = g
        return out[0], out[1]
    return f


CONTROLS = {"k3_bfloat16": ("pair_ll_diff_plain", _k3_bf16, "k3_rel_gap"),
            "gemm_tf32": ("cluster_read_ll", _ll_tf32, "ll_rel_gap")}


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_the_control_in_the_ports_place_is_not_correct(
        tmp_path, monkeypatch, cell, control):
    from hla_la_tpu_torch.ops import pair_ll
    name, wrap, number = CONTROLS[control]
    monkeypatch.setattr(pair_ll, name, wrap(getattr(pair_ll, name)))
    res = run(tmp_path, limits_of=cell)
    assert not res["correct"]
    row = res["checks"][number]
    assert row["limit"] == cell_limits(cell)[number]
    assert row["value"] > row["limit"]


def test_a_call_altered_where_it_is_produced_is_not_correct(tmp_path,
                                                             monkeypatch):
    from hla_la_tpu_torch.models.typer import HLATyper
    real = HLATyper._type_locus

    def wrong(self, *a, **k):
        res = real(self, *a, **k)
        if res is not None:
            res.allele1_id = res.allele2_id = "X*99:99"
        return res

    monkeypatch.setattr(HLATyper, "_type_locus", wrong)
    res = run(tmp_path)
    assert not res["correct"] and res["checks"]["calls_wrong"]["value"] > 0
    assert np.isfinite(res["checks"]["k3_rel_gap"]["value"])


def test_readings_the_control_fails_and_the_port_passes(tmp_path):
    import readings
    bench = tiny_checkout(str(tmp_path))
    rows = readings.read("tiny", [SEED, SEED + 1], {SEED}, str(tmp_path),
                         device="cpu", bench_dir=bench)
    limits = cell_limits("imgt2-wgs30x-pool7")
    assert all(r["program_correct"] for r in rows)
    assert all(r["program"]["k1_jobs_differ"] == 0 for r in rows)
    assert not rows[0]["control_correct"]
    for number in ("k3_rel_gap", "ll_rel_gap"):
        assert rows[0]["control"][number] > limits[number]


def test_samples_needed_and_a_window_that_uses_them_up(tmp_path,
                                                       monkeypatch):
    assert harness.samples_needed(51, 25.5) == 4
    assert harness.samples_needed(51, 6.0) == 17
    monkeypatch.setattr(harness, "HEADROOM", 1e-3)
    bench = tiny_checkout(str(tmp_path))
    with pytest.raises(harness.OutOfSamples):
        harness.run("tiny", SEED, 30.0, False, str(tmp_path),
                    device="cpu", bench_dir=bench)
    from hla_la_tpu_torch.ops import pair_ll
    assert not hasattr(pair_ll.pair_ll_diff_plain, "capture")
    assert harness.reap() == []
