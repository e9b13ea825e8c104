"""Simulators: PRG panels (``graph_sim``), reads (``read_sim``), truth
levels (``truth``) and whole typing worlds with planted alleles
(``worlds``)."""

from .graph_sim import SimulatedPRG, simulate_prg_package
from .read_sim import ReadSimulator, SimulatedPair
from .truth import TrueReadLevels
from .worlds import (LONG_READ_LENGTH, AsmWorld, DecoyWorld, KirWorld,
                     LongReadWorld, TypingWorld, ambiguous_q1,
                     ambiguous_world, asm_world, decoy_world, kir_world,
                     long_read_world, typing_world)
