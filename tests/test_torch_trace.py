"""The port's spans (hla_la_tpu_torch/utils/timing.py) on the CPU: the span
tree of one run_hla_typing in one process and with two worker processes,
tracing off (nothing recorded, the same files), the count of spans against
the count of reads, the anchor that puts the spans' clock on the
profiler's, and profile_e2e's span report and Chrome trace."""

import collections
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hla_la_tpu_torch import profile_e2e
from hla_la_tpu_torch.cli import main as port_main
from hla_la_tpu_torch.io.fastq import write_fastq
from hla_la_tpu_torch.models.pipeline import run_hla_typing
from hla_la_tpu_torch.sim import ReadSimulator, simulate_prg_package
from hla_la_tpu_torch.utils import timing
from hla_la_tpu_torch.utils.config import RunConfig, TyperConfig
from test_torch_host_layers import _read, _tree

# the harness's regexes over the align and type Timer lines
ALIGNED = re.compile(r"aligned \d+/\d+ pairs .* in ([0-9.]+) s on ")
TYPED = re.compile(r"typed \d+ loci in ([0-9.]+) s on ")

SERIAL = {"run_hla_typing", "pipeline.prepare", "pipeline.insert_size",
          "align", "align.seed", "align.nw", "align.select", "align.stats",
          "type", "typer.prepare", "typer.locus", "typer.pileup",
          "typer.tensors", "typer.gemm", "typer.pairs", "typer.pairs.host",
          "typer.qc", "typer.kmers", "typer.dump", "typer.write_wait"}
POOLED = SERIAL | {"pool.start", "worker.init", "worker.imports",
                   "worker.connect", "worker.package", "align.chunk",
                   "server.request", "typer.fanout", "pool.close"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Four loci, so that the typing fan-out's gate can pass, and more than
    512 pairs, so that --maxThreads starts its workers."""
    root = tmp_path_factory.mktemp("trace_world")
    rng = np.random.default_rng(31)
    sim = simulate_prg_package(
        rng, backbone_length=5000, n_haplotypes=6,
        genes={"A": (0.08, 0.26), "B": (0.30, 0.48), "C": (0.52, 0.70),
               "DQA1": (0.74, 0.92)})
    pkg = sim.write_package(str(root / "g"))
    rs = ReadSimulator(rng, read_length=90, fragment_mean=260, fragment_sd=25)
    pairs = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        pairs += rs.simulate_pairs_from_string(seq, levels, 12.0,
                                               name_prefix=f"h{h}")
    fq = [(p.r1.to_fastq(), p.r2.to_fastq()) for p in pairs]
    assert len(fq) > 512
    write_fastq(str(root / "R_1.fq"), [a for a, _ in fq])
    write_fastq(str(root / "R_2.fq"), [b for _, b in fq])
    return root, pkg, fq


def _cfg(max_threads):
    # the typing workers' gate lowered, so that two workers type the loci
    return RunConfig(max_threads=max_threads,
                     typer=TyperConfig(min_reads_for_typing_workers=1))


def _typed(world, out, max_threads=1, pairs=None, traced=True):
    _, pkg, fq = world
    timing.clear()
    if traced:
        with timing.tracing():
            run_hla_typing(pkg, pairs or fq, [], str(out),
                           _cfg(max_threads), device="cpu")
    else:
        run_hla_typing(pkg, pairs or fq, [], str(out), _cfg(max_threads),
                       device="cpu")
    return timing.spans()


def _inside(child, parent):
    return parent.t0 <= child.t0 and child.t1 <= parent.t1


@pytest.mark.parametrize("max_threads", [1, 2])
def test_the_span_tree_of_one_sample(world, tmp_path, capfd, max_threads):
    rec = _typed(world, tmp_path / "out", max_threads)
    log = capfd.readouterr().err
    assert ALIGNED.search(log) and TYPED.search(log)
    names = {r.name for r in rec}
    assert names == (POOLED if max_threads > 1 else SERIAL)
    (root,) = [r for r in rec if r.name == "run_hla_typing"]
    assert root.attrs == {"pairs": len(world[2]), "unpaired": 0,
                          "max_threads": max_threads}
    assert root.parent is None
    by_id = {r.id: r for r in rec}
    assert len(by_id) == len(rec)
    align = next(r for r in rec if r.name == "align")
    typ = next(r for r in rec if r.name == "type")
    for r in rec:
        assert r.sample == root.sample, r
        assert r.t0 <= r.t1
        if r.name == "typer.dump":
            # an output thread outlives its locus, not the type Timer,
            # whose flush joins it
            assert _inside(r, typ)
        elif r is not root:
            assert _inside(r, by_id[r.parent]), (r, by_id[r.parent])
    loci = [r for r in rec if r.name == "typer.locus"]
    assert sorted(r.attrs["locus"] for r in loci) == ["A", "B", "C", "DQA1"]
    assert all(r.attrs["C"] > 0 and r.attrs["R"] > 0 for r in loci)
    assert all(r.attrs["bytes_in"] > 0 and r.attrs["bytes_out"] > 0
               for r in rec if r.name == "typer.gemm")
    assert all(by_id[r.parent].name == "typer.locus"
               for r in rec if r.name == "typer.dump")
    # a CPU device and the served workers: the pair epilogue on the host
    assert {r.attrs["route"] for r in rec if r.name == "typer.pairs"} == \
        {"host"}
    assert all(by_id[r.parent].name == "typer.pairs"
               for r in rec if r.name == "typer.pairs.host")
    here = os.getpid()
    if max_threads == 1:
        assert {r.pid for r in rec} == {here}
        return
    workers = {r.pid for r in rec} - {here}
    assert 1 <= len(workers) <= 2
    for r in rec:
        if r.name == "align.chunk":
            assert r.pid != here and r.parent == align.id
        if r.name == "typer.locus":
            assert r.pid != here and _inside(r, typ)
        if r.name == "worker.init":
            assert r.pid != here and r.parent == root.id
    requests = [r for r in rec if r.name == "server.request"]
    assert {r.attrs["kind"] for r in requests} == {
        "nw", "cluster_read_ll", "pair_ll_reduction"}
    for r in requests:
        assert r.pid == here and r.attrs["pid"] in workers
        assert r.attrs["wait_ns"] >= 0
        assert r.attrs["bytes_in"] > 0 and r.attrs["bytes_out"] > 0
        assert _inside(r, align) or _inside(r, typ)
        assert by_id[r.parent].pid == r.attrs["pid"]
    assert sum(r.attrs["jobs"] for r in requests if r.attrs["kind"] == "nw") \
        == sum(r.attrs["jobs"] for r in rec if r.name == "align.nw"
               and r.pid != here)
    # the worker's start: its three parts, end to end
    for init in (r for r in rec if r.name == "worker.init"):
        parts = sorted((r for r in rec if r.parent == init.id),
                       key=lambda r: r.t0)
        assert [r.name for r in parts] == ["worker.imports",
                                           "worker.connect", "worker.package"]
        assert parts[0].t0 == init.t0 and parts[-1].t1 == init.t1
        assert parts[0].t1 == parts[1].t0 and parts[1].t1 == parts[2].t0


def test_tracing_off_records_nothing_and_writes_the_same_files(
        world, tmp_path, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def counted(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    assert timing.span("a") is timing.span("b") is timing.NOOP
    assert timing.context() is None and timing.carry() == ()
    off = _typed(world, tmp_path / "off", traced=False)
    assert off == [] and timing.spans() == [] and entered == []
    on = _typed(world, tmp_path / "on")
    assert on and entered == []         # no profiler: no range entered
    names = _tree(str(tmp_path / "off"))
    assert names == _tree(str(tmp_path / "on")) and len(names) >= 10
    for name in sorted(names):
        assert _read(str(tmp_path / "off" / name)) == \
            _read(str(tmp_path / "on" / name)), name
    timing.clear()


def test_the_card_route_of_the_pair_epilogue_writes_the_same_files(
        world, tmp_path, monkeypatch):
    """The pair epilogue's card route, made to run its PyTorch steps on
    CPU tensors, types the sample into the same bytes as the host route:
    every pair dump, the best guesses with Q1 and Q2; its spans say so."""
    from hla_la_tpu_torch.models import typer as port_typer
    from hla_la_tpu_torch.ops import pair_ll as port_pair
    host = _typed(world, tmp_path / "host")
    calls = port_pair.pair_epilogue.card_calls
    for mod in (port_pair, port_typer):
        monkeypatch.setattr(mod, "epilogue_on_card", lambda *a, **k: True)
    card = _typed(world, tmp_path / "card")
    assert port_pair.pair_epilogue.card_calls == calls + 4
    for rec, route in ((host, "host"), (card, "card")):
        pairs = [r for r in rec if r.name == "typer.pairs"]
        assert len(pairs) == 4
        assert {r.attrs["route"] for r in pairs} == {route}
        kids = collections.Counter(r.name for r in rec
                                   if r.parent in {p.id for p in pairs})
        assert kids == ({"typer.pairs.card": 4, "typer.pairs.host": 4}
                        if route == "card" else {"typer.pairs.host": 4})
    names = _tree(str(tmp_path / "host"))
    assert names == _tree(str(tmp_path / "card"))
    assert {"hla/R1_PP_A_pairs.txt", "hla/R1_bestguess.txt"} <= names
    for name in sorted(names):
        assert _read(str(tmp_path / "host" / name)) == \
            _read(str(tmp_path / "card" / name)), name
    timing.clear()


def test_the_span_count_does_not_grow_with_the_reads(world, tmp_path):
    """One process, one batch: the same spans for 300 pairs as for all."""
    few = _typed(world, tmp_path / "few", pairs=world[2][:300])
    every = _typed(world, tmp_path / "all")
    assert collections.Counter(r.name for r in few) == \
        collections.Counter(r.name for r in every)
    timing.clear()


def test_the_anchor_puts_the_clock_on_the_profilers_time_base():
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.root("run_hla_typing"):
            with timing.span("inner"):
                with record_function("probe"):
                    stamp = timing.clock()
    rec = timing.spans()
    assert [r.name for r in rec] == [timing.ANCHOR, "inner",
                                     "run_hla_typing"]
    events = {e.name: e for e in prof.events()}
    # spans are no profiler ranges (a range around launches would be a
    # device event): the anchor alone puts them on the profiler's clock
    assert {"probe", timing.ANCHOR} <= set(events)
    assert not {"run_hla_typing", "inner"} & set(events)
    offset, width = profile_e2e.clock_offset(prof, rec)
    assert 0 <= width < 0.01
    probe = events["probe"].time_range
    on_profiler = stamp / 1e9 - offset
    assert probe.start / 1e6 - width <= on_profiler <= probe.end / 1e6 + width
    timing.clear()


def test_idle_seconds_go_to_the_innermost_open_span():
    R = timing.Record
    s = 1_000_000_000
    rec = [R("run_hla_typing", 0, 10 * s, 1, None, 1, 1, 1, {}),
           R("align", 1 * s, 4 * s, 2, 1, 1, 1, 1, {}),
           R("align.nw", 2 * s, 3 * s, 3, 2, 1, 1, 1, {}),
           R("align.chunk", int(2.5 * s), 6 * s, 4, 2, 1, 2, 2, {})]
    got = timing.idle_by_span([(3.5, 5.0, "kernel")], rec, 0.0, 10.0)
    assert dict(got["by_span"]) == pytest.approx(
        {"run_hla_typing": 5.0, "align": 1.0, "align.nw": 0.5,
         "align.chunk": 2.0})
    assert got["gaps"] == [["run_hla_typing", 5.0], ["align", 3.5]]
    table = {n: (c, t, own) for n, c, t, own in timing.span_table(rec)}
    # the worker's chunk is no child of align's own time
    assert table["align"] == (1, 3.0, 2.0)
    assert table["run_hla_typing"] == (1, 10.0, 7.0)


def test_the_cli_traced_under_the_profiler(world, tmp_path):
    """The CLI's input and package spans, and profile_e2e's report and
    Chrome trace with the workers' spans, on a CPU profile."""
    root, pkg, _ = world
    argv = ["--action", "HLA", "--graph", pkg.dir, "--sampleID", "S1",
            "--FASTQ1", str(root / "R_1.fq"), "--FASTQ2",
            str(root / "R_2.fq"), "--device", "cpu", "--maxThreads", "2",
            "--outputDirectory", str(tmp_path / "cli")]
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = timing.clock() / 1e9
        assert port_main(argv) == 0
        t1 = timing.clock() / 1e9
    rec = timing.spans()
    tops = [r.name for r in rec if r.parent is None]
    assert tops == [timing.ANCHOR, "pkg.load", "io.fastq", "run_hla_typing"]
    offset = profile_e2e.clock_offset(prof, rec)
    assert offset is not None
    lines = profile_e2e.span_report([], rec, t0, t1)
    assert any(line.endswith("  align.chunk") for line in lines)
    assert "device idle s by innermost open span" in lines
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    n = profile_e2e.add_spans_to_trace(path, rec)
    workers = {r.pid for r in rec} - {os.getpid()}
    assert n > 0 and workers
    with open(path) as fh:
        trace = json.load(fh)
    ev = trace["traceEvents"] if isinstance(trace, dict) else trace
    added = [e for e in ev if e.get("cat") == "hla_span"]
    assert len(added) == n and {e["pid"] for e in added} >= workers
    timing.clear()
