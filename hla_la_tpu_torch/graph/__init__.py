from .prg import PRG
from .compile import CompiledPRG, compile_prg
from .package import GraphPackage
