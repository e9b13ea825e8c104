"""FASTA I/O (reference: Utilities::readFASTA / writeFASTA)."""

from __future__ import annotations

import gzip


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path: str, full_identifier: bool = False) -> dict[str, str]:
    out: dict[str, list[str]] = {}
    name = None
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip("\n\r")
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:]
                if not full_identifier:
                    name = name.split()[0]
                out[name] = []
            else:
                assert name is not None, "sequence before header"
                out[name].append(line)
    return {k: "".join(v) for k, v in out.items()}


def write_fasta(path: str, seqs: dict[str, str], width: int = 80) -> None:
    with _open(path, "wt") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
