"""HLA allele nomenclature: parsing, resolution-limited compatibility, and
truth evaluation.

Reference: simpleHLA.pm (allele-string parsing/compat at 2-/4-digit and G
resolution) and HLATyper truth utilities (read_true_types HLATyper.cpp:628,
read_inferred_types :583, evaluate_HLA_types :407, alleles_compatible :531).
"""

from __future__ import annotations

from dataclasses import dataclass, field


def parse_allele(a: str) -> tuple[str, list[str], str]:
    """'A*02:01:01:02N' -> ('A', ['02','01','01','02'], 'N').
    Accepts bare field lists without locus ('02:01')."""
    locus = ""
    rest = a
    if "*" in a:
        locus, rest = a.split("*", 1)
    suffix = ""
    while rest and rest[-1].isalpha():
        suffix = rest[-1] + suffix
        rest = rest[:-1]
    fields = [f for f in rest.split(":") if f]
    return locus, fields, suffix


def alleles_compatible(a: str, b: str, resolution: int = 2) -> bool:
    """True iff the two allele strings agree on the first `resolution`
    nomenclature fields (2 fields = 'four-digit' a.k.a. G-group core)."""
    la, fa, _ = parse_allele(a)
    lb, fb, _ = parse_allele(b)
    if la and lb and la != lb:
        return False
    if len(fa) < resolution or len(fb) < resolution:
        resolution = min(len(fa), len(fb), resolution)
        if resolution == 0:
            return False
    return fa[:resolution] == fb[:resolution]


def allele_list_compatible(called: str, truth: str, resolution: int = 2
                           ) -> bool:
    """called/truth may be ';'-separated ambiguity lists — compatible if any
    pair matches (the reference's compatibleStringAlleles semantics)."""
    for c in called.split(";"):
        for t in truth.split(";"):
            if alleles_compatible(c, t, resolution):
                return True
    return False


@dataclass
class TypeEvaluation:
    n_loci: int = 0
    n_alleles_total: int = 0
    n_alleles_correct: int = 0
    per_locus: dict = field(default_factory=dict)

    @property
    def accuracy(self) -> float:
        return (self.n_alleles_correct / self.n_alleles_total
                if self.n_alleles_total else 0.0)


def evaluate_types(inferred: dict[str, tuple[str, str]],
                   truth: dict[str, tuple[str, str]],
                   resolution: int = 2) -> TypeEvaluation:
    """Per-locus diploid concordance: best assignment of the two called
    alleles to the two truth alleles (evaluate_HLA_types,
    HLATyper.cpp:407-530)."""
    ev = TypeEvaluation()
    for locus, (t1, t2) in truth.items():
        if locus not in inferred:
            continue
        c1, c2 = inferred[locus]
        straight = (allele_list_compatible(c1, t1, resolution)
                    + allele_list_compatible(c2, t2, resolution))
        crossed = (allele_list_compatible(c1, t2, resolution)
                   + allele_list_compatible(c2, t1, resolution))
        correct = max(straight, crossed)
        ev.n_loci += 1
        ev.n_alleles_total += 2
        ev.n_alleles_correct += correct
        ev.per_locus[locus] = correct
    return ev


def read_truth_file(path: str) -> dict[str, dict[str, tuple[str, str]]]:
    """Truth file: TSV with header 'IndividualID <locus> <locus> ...' where
    each locus appears twice (two chromosomes) — the --trueHLA format
    (read_true_types, HLATyper.cpp:628-690)."""
    out: dict[str, dict[str, tuple[str, str]]] = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            f = line.split("\t")
            indiv = f[0]
            per_locus: dict[str, list[str]] = {}
            for col, val in zip(header[1:], f[1:]):
                per_locus.setdefault(col, []).append(val)
            out[indiv] = {loc: (v[0], v[1] if len(v) > 1 else v[0])
                          for loc, v in per_locus.items()}
    return out


def golden_g_mismatches(golden_path: str, got_path: str
                        ) -> list[tuple[str, tuple[str, str],
                                        tuple[str, str]]]:
    """Compare a bestguess_G output against a golden table: the unordered
    allele pair must match at every locus the golden table carries
    (the NA12878 conformance contract, reference README.md:119-130 +
    NA12878_example_output_G.txt).  Returns [(locus, golden_pair,
    got_pair)] for every disagreement — empty means conformant.  Shared
    by the real env-gated golden test and the in-suite dress rehearsal."""
    golden = read_inferred_bestguess(golden_path)
    got = read_inferred_bestguess(got_path)
    mismatches = []
    for locus, (g1, g2) in golden.items():
        o1, o2 = got.get(locus, ("", ""))
        if {g1, g2} != {o1, o2}:
            mismatches.append((locus, (g1, g2), (o1, o2)))
    return mismatches


def read_inferred_bestguess(path: str) -> dict[str, tuple[str, str]]:
    """Parse R1_bestguess(_G).txt into {locus: (allele1, allele2)}
    (read_inferred_types, HLATyper.cpp:583-626)."""
    out: dict[str, dict[int, str]] = {}
    with open(path) as fh:
        header = fh.readline()
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 3:
                continue
            out.setdefault(f[0], {})[int(f[1])] = f[2]
    return {loc: (d.get(1, ""), d.get(2, "")) for loc, d in out.items()}
