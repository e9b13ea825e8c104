"""FASTQ I/O for read extraction outputs (the reference produces R_1/R_2/R_U
fastq via Picard SamToFastq, HLA-LA.pl:467-479)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator


@dataclass
class FastqRead:
    name: str
    seq: str
    qual: str  # ASCII phred+33


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fastq(path: str) -> Iterator[FastqRead]:
    with _open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            seq = fh.readline().rstrip("\n")
            fh.readline()
            qual = fh.readline().rstrip("\n")
            name = h.rstrip("\n")[1:].split()[0]
            # strip /1 /2 mate suffixes like Picard does
            if name.endswith("/1") or name.endswith("/2"):
                name = name[:-2]
            yield FastqRead(name, seq, qual)


def write_fastq(path: str, reads) -> None:
    with _open(path, "wt") as fh:
        for r in reads:
            fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
