"""The readers of the port's spans (hlabench/spans.py and the nine
metrics on it) on a synthetic span list, and a traced tiny cell that
reports all nine."""

from collections import namedtuple

import pytest

from hlabench import harness, spans, spec
from test_bench_run import SEED
from tiny import REPO, tiny_checkout

Span = namedtuple("Span", "name t0 t1 id parent sample pid tid attrs")
S = 1_000_000_000       # a second in nanoseconds
SPAN_METRICS = ("pool.ready_s", "server.wait_s", "aligner.host_s",
                "typer.pileup_s", "typer.tensors_s", "typer.gemm_s",
                "typer.pairs_s", "typer.qc_s", "typer.write_wait_s")


def sample(k, t, pool=True):
    """One sample's spans, `k` its id, starting at second `t`: a root of
    10 s, the pool started at 1 s with two workers ready at 3 s and 4 s,
    two server requests that waited 0.25 s and 0.5 s, seeding and
    selection in two processes, and one traced locus."""
    out = [Span("run_hla_typing", t * S, (t + 10) * S, 1, None, k, 1, 1, {})]
    if pool:
        out += [Span("pool.start", (t + 1) * S, int((t + 1.1) * S), 2, 1, k,
                     1, 1, {}),
                Span("worker.init", (t + 1) * S, (t + 3) * S, 3, 1, k, 2, 2,
                     {}),
                Span("worker.init", (t + 1) * S, (t + 4) * S, 4, 1, k, 3, 3,
                     {}),
                Span("server.request", 0, 1, 5, 9, k, 1, 5,
                     {"wait_ns": S // 4}),
                Span("server.request", 0, 1, 6, 9, k, 1, 5,
                     {"wait_ns": S // 2})]
    out += [Span("align.seed", 0, S, 7, 1, k, 2, 2, {}),
            Span("align.select", 0, 2 * S, 8, 1, k, 3, 3, {}),
            Span("align.nw", 0, 5 * S, 9, 1, k, 3, 3, {})]
    for j, name in enumerate(("typer.pileup", "typer.tensors",
                              "typer.gemm", "typer.pairs", "typer.qc",
                              "typer.write_wait")):
        out.append(Span(name, 0, (j + 1) * S // 10, 10 + j, 1, k, 1, 1, {}))
    return out


EXPECTED = {"pool.ready_s": 3.0, "server.wait_s": 0.75,
            "aligner.host_s": 3.0, "typer.pileup_s": 0.1,
            "typer.tensors_s": 0.2, "typer.gemm_s": 0.3,
            "typer.pairs_s": 0.4, "typer.qc_s": 0.5,
            "typer.write_wait_s": 0.6}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_reader_means_over_the_windows_samples(metric):
    reader = spec.Bench(REPO).reader(metric)
    # two samples alike, and a span of no window sample, which is left out
    rec = {"spans": sample(1, 0) + sample(2, 20)
           + [Span("align.seed", 0, 99 * S, 99, None, 7, 1, 1, {})]}
    assert reader.read(rec) == pytest.approx(EXPECTED[metric])
    assert reader.read({"spans": []}) is None
    # a window whose roots hold no such span (one process: no pool, no
    # server) reads None for the pool's metrics, the others as before
    one = reader.read({"spans": sample(1, 0, pool=False)})
    if metric in ("pool.ready_s", "server.wait_s"):
        assert one is None
    else:
        assert one == pytest.approx(EXPECTED[metric])


def test_spans_of_a_program_without_a_recorder_read_none(monkeypatch):
    from hla_la_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "spans")
    assert spans.records({}) == []
    assert spans.mean_seconds({}, ("typer.gemm",)) is None
    assert spans.pool_ready({}) is None


def test_traced_tiny_cell_reports_every_span_metric(tmp_path):
    bench = tiny_checkout(str(tmp_path), max_threads=2)
    res = harness.run("tiny", SEED, 2.0, True, str(tmp_path), device="cpu",
                      bench_dir=bench)
    assert res["correct"] and res["failed"] == 0
    got = res["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert all(got[m]["value"] >= 0 and got[m]["unit"] == "s"
               for m in SPAN_METRICS)
    # typing in the parent: the typer's own spans lie inside its Timer
    typer = sum(got[m]["value"] for m in SPAN_METRICS
                if m.startswith("typer."))
    assert typer <= got["typer.type_s"]["value"]
    assert harness.reap() == []
