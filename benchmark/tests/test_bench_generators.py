"""The panel and sample generators: one seed, one sample; seeds differ in
what they plant and not in how much work they give."""

import json
import os

import numpy as np
import pytest

from hlabench import panel, reads
from tiny import BENCH, TINY_CONFIG

TRAFFIC = {"windows": "genes", "flank": 300, "max_threads": 1}
BIG_SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tiny_panel():
    return panel.simulate_panel(TINY_CONFIG)


def test_same_seed_same_sample(tiny_panel):
    a = reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, BIG_SEED, 1)
    b = reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, BIG_SEED, 1)
    assert a.haps == b.haps and a.names == b.names
    assert a.seq1 == b.seq1 and a.qual2 == b.qual2 and a.truth == b.truth


def test_seeds_plant_different_pairs_with_the_same_amount_of_work(tiny_panel):
    samples = [reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, s, 1)
               for s in range(BIG_SEED, BIG_SEED + 12)]
    assert len({s.haps for s in samples}) > 3
    assert len({s.n_pairs for s in samples}) == 1
    for s in samples:
        assert 1 <= s.haps[0] < s.haps[1] <= 8
        assert all(len(x) == TINY_CONFIG["read_length"] for x in s.seq1)


def test_samples_of_one_run_differ(tiny_panel):
    a = reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, BIG_SEED, 1)
    b = reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, BIG_SEED, 2)
    assert a.seq1 != b.seq1


def test_reads_come_from_the_planted_haplotypes(tiny_panel):
    s = reads.draw_sample(tiny_panel, TINY_CONFIG, TRAFFIC, BIG_SEED, 1)
    comp = str.maketrans("ACGT", "TGCA")
    haps = [tiny_panel.linearized(h)[0].tobytes().decode() for h in s.haps]
    others = [tiny_panel.linearized(h)[0].tobytes().decode()
              for h in range(1, 9) if h not in s.haps]

    def found(seq, where):
        rc = seq.translate(comp)[::-1]
        return any(seq in h or rc in h for h in where)

    mates = s.seq1 + s.seq2
    exact = sum(found(x, haps) for x in mates)
    assert exact > 0.3 * len(mates)     # about half the reads carry an error
    assert sum(found(x, others) and not found(x, haps) for x in mates) \
        < 0.01 * len(mates)


def test_panel_is_drawn_from_its_seed_alone():
    a = panel.simulate_panel(TINY_CONFIG)
    b = panel.simulate_panel(TINY_CONFIG)
    assert np.array_equal(a.rows, b.rows)
    other = panel.simulate_panel({**TINY_CONFIG, "panel_seed": 1})
    assert not np.array_equal(a.rows[:, :100], other.rows[:, :100])


def test_first_alleles_are_the_rows_exons(tiny_panel):
    for locus, exons in tiny_panel.exon_cols.items():
        own = np.concatenate([tiny_panel.rows[:, a:b] for _, a, b in exons],
                             axis=1)
        seqs = tiny_panel.allele_seqs[locus]
        assert np.array_equal(seqs[:len(own)], own)
        assert seqs.shape[0] == TINY_CONFIG["alleles_per_locus"]
        assert len({r.tobytes() for r in seqs}) > len(own)


def test_insertion_columns_keep_the_backbone_in_order(tiny_panel):
    bb = tiny_panel.rows[0]
    assert (bb != panel.GAP).sum() == TINY_CONFIG["n_levels"]
    gaps = tiny_panel.rows[1:, bb == panel.GAP]
    assert (gaps != panel.GAP).any(axis=0).all()   # a carrier per column


@pytest.mark.parametrize("name", ["hla-imgt2", "hla-prg3m"])
def test_configured_panels_have_their_loci_and_widths(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    if cfg["n_levels"] > 100_000:
        cfg = {**cfg, "n_levels": 200_000}     # the widths, not the scale
    p = panel.simulate_panel(cfg)
    assert set(p.allele_seqs) == set(cfg["genes"])
    for seqs in p.allele_seqs.values():
        assert seqs.shape[0] == cfg["alleles_per_locus"]
