"""A tiny cell driven through the harness on the CPU (the look for a card
skipped): correct on the port as it is, false with the timed path broken
underneath, and no process left behind; the same on long reads, whose NW
jobs all go to K2's band."""

import contextlib
import time

import numpy as np
import pytest
import torch

from hlabench import harness, probes, reference
from tiny import SPLIT_CALLS, cell_limits, cells, tiny_checkout, tiny_split

SEED = 2**31 + 99


def run(tmp_path, max_threads=1, traced=False, limits_of=None,
        long_reads=False, limits=None):
    bench = tiny_checkout(str(tmp_path), max_threads=max_threads,
                          long_reads=long_reads, limits=limits,
                          **({"limits_of": limits_of} if limits_of else {}))
    with tiny_split() if long_reads else contextlib.nullcontext():
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


def _k2_altered(fn):         # a K2 answer altered where it is produced:
    def f(reads, lens, refs, sc):   # every wide-band job's score
        from hla_la_tpu_torch.ops.cuda_nw import MAX_W
        out = list(fn(reads, lens, refs, sc))
        if refs.shape[1] - reads.shape[1] > MAX_W:
            out[0] = out[0] + 2.0
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
          "k2_answer_altered": ("banded_nw", "banded_nw_plain", _k2_altered),
          "k3_half_reads": ("pair_ll", "pair_ll_diff_plain", _k3_half),
          "k3_answer_altered": ("pair_ll", "pair_ll_diff_plain",
                                _k3_altered)}
# faults of the long-read path: run on the tiny long-read cell
LONG_FAULTS = {"k2_answer_altered"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from hla_la_tpu_torch.ops import banded_nw, pair_ll
    mod = {"banded_nw": banded_nw, "pair_ll": pair_ll}[FAULTS[fault][0]]
    name, wrap = FAULTS[fault][1:]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res = run(tmp_path, long_reads=fault in LONG_FAULTS)
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
    assert harness.samples_needed(51, 25.5) == 6
    assert harness.samples_needed(51, 6.0) == 26
    # a warm-up at 3.6 s, a window of 1.6 s samples: 33 and more
    assert harness.samples_needed(51, 3.6) > 51 / 1.6 + 1
    monkeypatch.setattr(harness, "HEADROOM", 1e-3)
    bench = tiny_checkout(str(tmp_path))
    with pytest.raises(harness.OutOfSamples):
        harness.run("tiny", SEED, 30.0, False, str(tmp_path),
                    device="cpu", bench_dir=bench)
    from hla_la_tpu_torch.ops import pair_ll
    assert not hasattr(pair_ll.pair_ll_diff_plain, "capture")
    assert harness.reap() == []


def test_the_host_library_is_built_before_the_warm_up(tmp_path,
                                                      monkeypatch):
    """A checkout's first run builds the port's host library: that build
    is set-up, outside the warm-up sample whose wall sizes the draw."""
    from hla_la_tpu_torch import native
    from hla_la_tpu_torch.models import pipeline
    events, walls, drawn = [], [], []
    build, type_ = native._ensure_built, pipeline.run_hla_typing

    def slow_build(*a, **k):
        events.append("build")
        time.sleep(1.0)
        return build(*a, **k)

    def run_hla_typing(*a, **k):
        events.append("type")
        t0 = time.perf_counter()
        out = type_(*a, **k)
        walls.append(time.perf_counter() - t0)
        return out

    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ensure_built", slow_build)
    monkeypatch.setattr(pipeline, "run_hla_typing", run_hla_typing)
    needed = harness.samples_needed
    monkeypatch.setattr(harness, "samples_needed",
                        lambda s, w: drawn.append(w) or needed(s, w))
    res = run(tmp_path)
    assert res["correct"]
    assert events[:2] == ["build", "type"]
    # the draw is sized from the warm-up's typing, without the build
    assert drawn[0] < walls[0] + 0.5
    assert harness.reap() == []


def test_a_long_read_run_types_split_reads_and_compares_k2(tmp_path,
                                                           monkeypatch):
    from hla_la_tpu_torch.models import pipeline
    from hlabench import check, reads
    drawn, typed, found = [], [], []
    draw, type_, numbers = (reads.draw_sample, pipeline.run_hla_typing,
                            check.numbers)

    def draw_sample(*a, **k):
        s = draw(*a, **k)
        drawn.append(s.n_unpaired)
        return s

    def run_hla_typing(pkg, pairs, unpaired, *a, **k):
        typed.append((len(pairs), len(unpaired), a[1].long_reads))
        return type_(pkg, pairs, unpaired, *a, **k)

    def numbers_(*a, **k):
        found.append(numbers(*a, **k))
        return found[-1]

    monkeypatch.setattr(reads, "draw_sample", draw_sample)
    monkeypatch.setattr(pipeline, "run_hla_typing", run_hla_typing)
    monkeypatch.setattr(check, "numbers", numbers_)
    res = run(tmp_path, long_reads=True)
    assert res["correct"] and res["failed"] == 0
    assert list(res["checks"]) == ["k2_jobs_differ", "ll_rel_gap",
                                   "k3_rel_gap", "calls_wrong"]
    assert found[0]["k2_jobs_compared"] > 0
    assert found[0]["k1_jobs_compared"] == 0
    # the warm-up sample: its extra long reads cut, in long-read mode, by
    # the CLI's cut at the CLI's own length: the harness gives it none
    assert typed[0][0] == 0 and typed[0][1] > drawn[0] > 0
    assert typed[0][2] == "ont2d"
    assert SPLIT_CALLS and all(c == ((), {}) for c in SPLIT_CALLS)
    assert harness.reap() == []


def test_a_limits_file_naming_k2_with_nothing_captured_is_not_correct(
        tmp_path):
    res = run(tmp_path, limits={**cell_limits("imgt2-wgs30x-pool7"),
                                "k2_jobs_differ": 0})
    assert not res["correct"]
    assert res["checks"]["k2_jobs_differ"] == {"value": 0, "limit": 0}
    assert res["checks"]["k1_jobs_differ"]["value"] == 0


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_the_k2_probe_stands_where_the_port_looks_k2_up(monkeypatch):
    """At each name the port calls K2 by (the device server's too), the
    probe times each launch through the wrapper's own events hook."""
    from hla_la_tpu_torch.models import device_server
    from hla_la_tpu_torch.ops import banded_nw, cuda_nw_long

    def wrapper(reads, lens, refs, sc):     # as banded_nw_long_cuda does
        me = cuda_nw_long.banded_nw_long_cuda
        me.launches += 1
        if me.events is not None:
            me.events.append((_Event(1.0), _Event(3.5)))
        return "out"

    wrapper.launches, wrapper.largest, wrapper.events = 0, (0,) * 4, None
    monkeypatch.setattr(cuda_nw_long, "banded_nw_long_cuda", wrapper)
    monkeypatch.setattr(banded_nw, "banded_nw_long_cuda", wrapper)
    p = probes.Probes()
    try:
        assert device_server._wrappers()["K2"] is p.k2
        assert banded_nw.banded_nw_long_cuda is p.k2
        p.set_timing(True)
        args = (torch.zeros((3, 50), dtype=torch.uint8), torch.full((3,), 50),
                torch.zeros((3, 306), dtype=torch.uint8), {})
        assert banded_nw.banded_nw_long_cuda(*args) == "out"
        (shape, (s, e)), = p.k2.timed
        assert shape == (3, 50, 256) and s.elapsed_time(e) == 2.5
        assert p.k2.launches == 1 and p.k2.events is None
    finally:
        p.remove()
    assert cuda_nw_long.banded_nw_long_cuda is wrapper


def test_k2_capture_keeps_one_job_of_each_of_k2_jobs_launches():
    def launch(n):
        B, L, W = 4, 30 + n, 40
        reads = torch.full((B, L), n % 4, dtype=torch.uint8)
        lens = torch.tensor([L, L - 1, L - 2, L - 3])
        refs = torch.zeros((B, L + W), dtype=torch.uint8)
        out = (torch.full((B,), float(n)), torch.zeros(B, dtype=torch.int32),
               torch.zeros(B, dtype=torch.int32),
               torch.zeros((B, L + 1, W), dtype=torch.uint8))
        return (reads, lens, refs, {}), out

    taken = []
    for seed in (5, 5, 6):
        cap = probes.Capture(seed)
        for n in range(40):
            args, out = launch(n)
            cap.take_nw(args, {}, out)
        assert cap.k2_launches == 40 and cap.k1 == []
        assert len(cap.k2) == probes.K2_JOBS
        launches = [j["score"] for j in cap.k2]
        assert len(set(launches)) == probes.K2_JOBS
        for j in cap.k2:
            assert len(j["reads"]) == j["len"] <= 30 + j["score"]
            assert j["refs"].shape == (j["len"] + 40,)
            assert j["pointers"].shape == (j["len"] + 1, 40)
        taken.append(launches)
    assert taken[0] == taken[1] != taken[2]
    assert max(taken[0]) >= probes.K2_JOBS     # later launches too
