"""The worlds of stress_imgt.py's twin against the JAX script.

``typing_world(genes=IMGT4_GENES)`` (``--loci4``) and ``imgt_long_reads``
(``--long``) are held to ``stress_imgt.build_cache`` and to
``run_long_mode``'s draw, with the script's CACHE, N_ALLELES, GENES and
BACKBONE patched (24 alleles; the four loci on a backbone of 3,000, the two
of the long reads on 2,000) and its ``log`` patched to stop each function
once its draw is written: the package byte for byte, the long reads by
name, sequence and quality.  The script draws its pairs at 1,250x (minutes
at any backbone), so the pairs are held to its recipe drawn through
``hla_la_tpu.sim`` at a cut coverage."""

import os
import pickle

import numpy as np
import pytest
import torch

from hla_la_tpu_torch import sim as port_sim
from hla_la_tpu_torch.sim import worlds as port_worlds
from test_torch_real_scale import _same_package

torch.set_num_threads(1)
N_ALLELES, BACKBONE = 24, 2000


class _Drawn(Exception):
    """Raised by the patched log once a draw of stress_imgt.py is written."""


def _stop_after_draws(monkeypatch, stress_imgt, ref, genes, backbone):
    """stress_imgt.py's module attributes patched: its cache in `ref`, 24
    alleles, `genes` on `backbone`, and a log that stops each of its
    functions once its draw is written."""
    monkeypatch.setattr(stress_imgt, "CACHE", str(ref))
    monkeypatch.setattr(stress_imgt, "N_ALLELES", N_ALLELES)
    monkeypatch.setattr(stress_imgt, "GENES", genes)
    monkeypatch.setattr(stress_imgt, "BACKBONE", backbone)

    def log(msg):
        if msg.startswith("package written") or "long reads simulated" in msg:
            raise _Drawn(msg)
    monkeypatch.setattr(stress_imgt, "log", log)


def test_imgt4_world_is_stress_imgt_recipe(tmp_path, monkeypatch):
    """--loci4's world: the package of build_cache byte for byte; its
    pairs, drawn at 1,250x there, held to the same recipe at 3x."""
    import stress_imgt
    from hla_la_tpu.sim.graph_sim import simulate_prg_package
    from hla_la_tpu.sim.read_sim import ReadSimulator
    backbone, coverage = 3000, 3.0
    genes = port_worlds.IMGT4_GENES
    assert genes == {"A": (0.05, 0.185), "B": (0.29, 0.425),
                     "C": (0.53, 0.665), "DQB1": (0.76, 0.895)}
    assert port_worlds.IMGT4_BACKBONE == 8000
    ref = tmp_path / "ref"
    _stop_after_draws(monkeypatch, stress_imgt, ref, genes, backbone)
    with pytest.raises(_Drawn):
        stress_imgt.build_cache()

    world = port_sim.typing_world(str(tmp_path / "port"), N_ALLELES,
                                  coverage, backbone, genes)
    assert world.graph.endswith(f"b{backbone}_a{N_ALLELES}_c3_A-B-C-DQB1"
                                f"{os.sep}pkg")
    _same_package(world.graph, str(ref / "pkg"))
    assert world.truth == {lc: [f"{lc}*02:01", f"{lc}*03:01"]
                           for lc in genes}
    # build_cache's pairs, drawn through the JAX package at `coverage`
    rng = np.random.default_rng(161803)
    sim = simulate_prg_package(rng, backbone_length=backbone, n_haplotypes=8,
                               snp_rate=0.01, genes=genes,
                               n_gene_alleles=N_ALLELES,
                               allele_snp_rate=0.02)
    rs = ReadSimulator(rng, read_length=100, fragment_mean=300,
                       fragment_sd=25, with_error=True)
    windows = []
    for locus in genes:
        cols = [i for i, n in enumerate(sim.column_names)
                if f"_gene_{locus}_" in n]
        windows.append((min(cols) - 300, max(cols) + 300))
    want = []
    for h in (1, 2):
        seq, levels = sim.linearized(h)
        for gi, (lo, hi) in enumerate(windows):
            sel = np.nonzero((levels >= lo) & (levels <= hi))[0]
            want += rs.simulate_pairs_from_string(
                seq[sel[0]:sel[-1] + 1], levels[sel[0]:sel[-1] + 1],
                coverage, name_prefix=f"h{h}g{gi}")
    got = list(zip(port_worlds.read_fastq(world.fastq1),
                   port_worlds.read_fastq(world.fastq2)))
    assert [((a.name, a.seq, a.qual), (b.name, b.seq, b.qual))
            for a, b in got] == \
        [((p.r1.name, p.r1.seq, p.r1.qual), (p.r2.name, p.r2.seq, p.r2.qual))
         for p in want]


def test_imgt_long_reads_are_stress_imgt_long_draw(tmp_path, monkeypatch):
    """--long's reads of the two-locus world (the one chip_smoke types in
    long-read mode): run_long_mode's draw, by name, sequence and quality."""
    import stress_imgt
    genes, backbone = port_worlds.IMGT_GENES, BACKBONE
    ref = tmp_path / "ref"
    _stop_after_draws(monkeypatch, stress_imgt, ref, genes, backbone)
    ref.mkdir()
    with pytest.raises(_Drawn):
        stress_imgt.run_long_mode()
    world = port_sim.typing_world(str(tmp_path / "port"), N_ALLELES, 1.0,
                                  backbone)
    long = port_sim.imgt_long_reads(world)
    assert long.graph == world.graph and long.truth == world.truth
    got = [(r.name, r.seq, r.qual)
           for r in port_worlds.read_fastq(long.fastq)]
    with open(ref / "long_reads.pkl", "rb") as fh:
        want = [tuple(r) for r in pickle.load(fh)]
    assert got == want and len(got) > 50
    # cached: a second call draws nothing
    assert port_sim.imgt_long_reads(world) == long


def test_default_typing_world_keeps_its_cache_path(tmp_path):
    """The two-locus world's directory is the one chip_smoke's phases
    share (no genes in its name)."""
    world = port_sim.typing_world(str(tmp_path), N_ALLELES, 2.0, BACKBONE)
    assert world.graph == str(tmp_path / f"b{BACKBONE}_a{N_ALLELES}_c2" /
                              "pkg")
    assert sorted(world.truth) == ["A", "B"]
