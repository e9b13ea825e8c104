"""The panel and sample generators: one seed, one sample; seeds differ in
what they plant and not in how much work they give (long reads: in the
lengths that meet one target of bases); short-read samples as the harness
drew them before long reads."""

import hashlib
import json
import os

import numpy as np
import pytest

from hlabench import panel, reads
from tiny import BENCH, TINY_CONFIG, TINY_LONG_CONFIG, TINY_SPLIT

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


# samples 0-2 of two seeds of each configuration, as the harness drew them
# before it took long reads: hla-prg3m's widths on a 200,000-level panel
SHORT_READ_DIGESTS = {
    "hla-imgt2/7/0": "7cf04e622c06f91d",
    "hla-imgt2/7/1": "6154659960465bc4",
    "hla-imgt2/7/2": "6770ab10889e7d39",
    "hla-imgt2/2147483747/0": "4d6c6da34671c80f",
    "hla-imgt2/2147483747/1": "60db0e52f7b067f8",
    "hla-imgt2/2147483747/2": "1db63dd6939b085f",
    "hla-prg3m/7/0": "cb37a5630aea74f8",
    "hla-prg3m/7/1": "0ff29a749b1a8cd4",
    "hla-prg3m/7/2": "b9c9964c6bd6b0d0",
    "hla-prg3m/2147483747/0": "0b733877f5a0477a",
    "hla-prg3m/2147483747/1": "8a33f00fe12f6b5e",
    "hla-prg3m/2147483747/2": "07ea4474599a0b75"}


def sample_digest(s):
    h = hashlib.sha256()
    h.update(json.dumps([list(s.haps), s.truth]).encode())
    for part in (s.names, s.seq1, s.qual1, s.seq2, s.qual2):
        h.update("\n".join(part).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", ["hla-imgt2", "hla-prg3m"])
def test_short_read_samples_are_drawn_as_before(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    if cfg["n_levels"] > 100_000:
        cfg = {**cfg, "n_levels": 200_000}
    with open(os.path.join(BENCH, "traffic", "wgs-pool7.json")) as fh:
        traffic = json.load(fh)
    p = panel.simulate_panel(cfg)
    for seed in (7, 2**31 + 99):
        for i in range(3):
            s = reads.draw_sample(p, cfg, traffic, seed, i)
            assert s.n_unpaired == 0
            assert sample_digest(s) == SHORT_READ_DIGESTS[f"{name}/{seed}/{i}"]


LONG_TRAFFIC = {"windows": "whole", "max_threads": 1}


@pytest.fixture(scope="module")
def long_panel():
    return panel.simulate_panel(TINY_LONG_CONFIG)


def test_long_reads_are_unpaired_and_drawn_from_the_seed(long_panel):
    a = reads.draw_sample(long_panel, TINY_LONG_CONFIG, LONG_TRAFFIC,
                          BIG_SEED, 1)
    b = reads.draw_sample(long_panel, TINY_LONG_CONFIG, LONG_TRAFFIC,
                          BIG_SEED, 1)
    c = reads.draw_sample(long_panel, TINY_LONG_CONFIG, LONG_TRAFFIC,
                          BIG_SEED, 2)
    assert a.n_pairs == 0 and a.n_unpaired > 0
    assert (a.haps, a.u_names, a.u_seq, a.u_qual) == (b.haps, b.u_names,
                                                      b.u_seq, b.u_qual)
    assert a.u_seq != c.u_seq
    assert all(len(s) == len(q) for s, q in zip(a.u_seq, a.u_qual))


def test_long_read_lengths_targets_and_extra_long_reads(long_panel):
    cfg = TINY_LONG_CONFIG
    bases = []
    for seed in range(BIG_SEED, BIG_SEED + 8):
        s = reads.draw_sample(long_panel, cfg, LONG_TRAFFIC, seed, 1)
        normal = [len(x) for n, x in zip(s.u_names, s.u_seq)
                  if "xl:::" not in n]
        extra = [len(x) for n, x in zip(s.u_names, s.u_seq) if "xl:::" in n]
        assert min(normal) >= cfg["read_length_min"]
        assert max(normal) <= cfg["read_length_max"]
        assert len(extra) == 2 * cfg["extra_long_reads"]
        assert all(cfg["extra_long_min"] <= n < cfg["extra_long_max"]
                   for n in extra)
        assert max(extra) > TINY_SPLIT
        # each haplotype's reads meet its target: coverage / 2 x backbone
        target = cfg["coverage"] / 2 * cfg["n_levels"]
        assert 2 * target <= sum(normal) < 2 * (target
                                                + cfg["read_length_max"])
        bases.append(sum(normal))
    assert len(set(bases)) > 1


def test_long_reads_come_from_the_planted_haplotypes_on_both_strands(
        long_panel):
    s = reads.draw_sample(long_panel, TINY_LONG_CONFIG, LONG_TRAFFIC,
                          BIG_SEED, 1)
    comp = str.maketrans("ACGT", "TGCA")
    haps = [long_panel.linearized(h)[0].tobytes().decode() for h in s.haps]
    fwd = rev = 0
    for x in s.u_seq:
        kmers = [x[k:k + 12] for k in range(0, len(x) - 12, 50)]
        f = sum(any(km in h for h in haps) for km in kmers)
        r = sum(any(km.translate(comp)[::-1] in h for h in haps)
                for km in kmers)
        assert max(f, r) > 0.5 * len(kmers)
        fwd += f > r
        rev += r > f
    assert fwd > 0 and rev > 0


def test_the_clis_cut_is_the_reference_pipelines_50_kb():
    """The harness cuts long reads with the CLI's own length: HLA-LA.pl's
    50,000 bases (HLA-LA.pl:503-524)."""
    import inspect

    from hla_la_tpu_torch.cli import _split_long_reads
    assert inspect.signature(_split_long_reads).parameters[
        "chunk"].default == 50_000


@pytest.mark.parametrize("key", reads.LONG_KEYS)
def test_a_long_read_configuration_states_its_read_length_profile(
        long_panel, key):
    cfg = {k: v for k, v in TINY_LONG_CONFIG.items() if k != key}
    with pytest.raises(KeyError, match=key):
        reads.draw_sample(long_panel, cfg, LONG_TRAFFIC, BIG_SEED, 1)
