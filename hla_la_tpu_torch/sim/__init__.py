"""Simulators: PRG panels (``graph_sim``), reads (``read_sim``), truth
levels (``truth``) and whole typing worlds with planted alleles
(``worlds``)."""

from .graph_sim import SimulatedPRG, simulate_prg_package
from .read_sim import ReadSimulator, SimulatedPair
from .truth import TrueReadLevels
from .worlds import (LONG_READ_LENGTH, AsmWorld, CohortSample,
                     CohortWorld, DecoyWorld, KirWorld, LongBenchReads,
                     LongReadWorld, RealScaleWorld, TypingWorld,
                     ambiguous_q1, ambiguous_world, asm_world, bench_world,
                     cohort_world, decoy_world, e2e_world, imgt_long_reads,
                     kir_world, load_levels, long_bench_reads,
                     long_read_world, second_sample,
                     split_levels, typing_world, wgs_world, world_bam)
