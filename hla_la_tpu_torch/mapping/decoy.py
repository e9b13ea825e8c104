"""Paralog defense — the mapAgainstCompleteGenome equivalent.

The reference maps input reads against the COMPLETE extended genome so that
reads from HLA paralogs/pseudogenes outside the PRG land on their true home
contigs and never reach the graph (HLA-LA.cpp:617, 742-779; the two-BAM seed
merge processBAM.cpp:241-369 keeps only reads whose best seeds fall in the
PRG's interesting intervals).

TPU-native redesign: instead of a second bwa pass, a *decoy k-mer index*
over the non-PRG genome.  At seeding time every read is scored against the
decoy index with the same chain statistic the PRG seeder uses (distinct
k-mers on one diagonal band); a read pair whose both mates seed strictly
better on decoy than on the PRG is dropped before NW.  One-sided pairs are
kept (mate rescue — matches the reference's behavior where a pair with any
seed inside the interesting intervals becomes a protoSeed).

Tie semantics (deliberate): pairs that seed EQUALLY well on the decoy and
the PRG are kept, like the reference keeps any read with a PRG-interval
seed.  Such reads match the PRG as well as their paralog of origin, so the
observations they produce agree with the true alleles — benign leakage
(verified by the randomized decoy soak: leaked tie-reads never flipped a
call across hundreds of trials; the >=94%-drop contract at 4% divergence
is tests/test_decoy.py).
"""

from __future__ import annotations

import os

import numpy as np

from .kmer_index import KmerIndex
from .seeder import Seeder


class DecoyIndex:
    """K-mer index over decoy (non-PRG) sequence + best-chain scoring."""

    def __init__(self, index: KmerIndex):
        self.index = index
        self.seeder = Seeder(index, max_candidates=1)

    @classmethod
    def build(cls, seqs: dict[str, str], k: int = 20) -> "DecoyIndex":
        return cls(KmerIndex.build(seqs, k=k))

    @classmethod
    def from_fasta(cls, fasta: dict[str, str], exclude_prefixes=("PRG",),
                   k: int = 20, cache_path: str | None = None,
                   source_path: str | None = None) -> "DecoyIndex | None":
        """Build from a genome dict, excluding PRG contigs (`PRG_<id>` in
        the reference's extendedReferenceGenome, processBAM.cpp:69-86).

        `source_path`: the FASTA file the dict came from — the cache is
        keyed on its identity+mtime so switching decoy sources (or
        regenerating one) never serves a stale index."""
        decoy = {n: s for n, s in fasta.items()
                 if not n.startswith(tuple(exclude_prefixes))}
        if not decoy:
            return None
        if cache_path and source_path:
            import hashlib
            try:
                tag = hashlib.md5(
                    f"{os.path.abspath(source_path)}:"
                    f"{os.path.getmtime(source_path)}".encode()
                ).hexdigest()[:12]
                root, ext = os.path.splitext(cache_path)
                cache_path = f"{root}_{tag}{ext}"
            except OSError:
                cache_path = None
        if cache_path and os.path.exists(cache_path):
            try:
                idx = KmerIndex.load(cache_path)
                if idx.k == k and idx.seq_names == sorted(decoy):
                    return cls(idx)
            except Exception:  # noqa: BLE001 — rebuild on any cache issue
                pass
        idx = KmerIndex.build({n: decoy[n] for n in sorted(decoy)}, k=k)
        if cache_path:
            try:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                idx.save(cache_path)
            except OSError:
                pass
        return cls(idx)

    def best_chain_kmers(self, seqs: list[str]) -> np.ndarray:
        """[n_reads] distinct k-mer count of the best decoy chain per read
        (0 = no decoy hit)."""
        read_of, _seq, _rev, _start, nk, _span = \
            self.seeder.candidates_batch_arrays(seqs)
        out = np.zeros(len(seqs), dtype=np.int64)
        np.maximum.at(out, read_of, nk)
        return out


def filter_decoy_pairs(decoy: DecoyIndex,
                       pairs_seqs: list[tuple[str, str]],
                       prg_best: np.ndarray,
                       margin: int = 0) -> np.ndarray:
    """[n_pairs] bool keep-mask.  prg_best: [2*n_pairs] best PRG candidate
    chain k-mers per mate (0 = no candidate).  A pair is dropped only when
    BOTH mates seed strictly better on decoy (decoy > prg + margin)."""
    flat = [s for p in pairs_seqs for s in p]
    dec = decoy.best_chain_kmers(flat)
    worse = dec > (prg_best + margin)
    worse = worse.reshape(-1, 2)
    return ~(worse[:, 0] & worse[:, 1])
