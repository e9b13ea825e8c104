"""hla_la_tpu_torch — the PyTorch/CUDA port of hla_la_tpu.

A package of its own beside the reference JAX package: it imports ``torch``
and numpy, never ``jax`` and nothing of ``hla_la_tpu``.  It covers every
action of the reference CLI: the ``--action HLA`` path on paired short reads
and on long reads (``--longReads``), linear-ALT typing (``--action KIR``),
assembly typing (``--action ASM``), cohort validation, the remapper, the
self-tests and the tools, with the same directory layout and module names
as the reference, so each module has its counterpart there:

  cli               the entry point (``--action HLA|KIR|ASM|validate|...``,
                    ``--device cuda|cpu``)
  validation        cohort validation (``validate_cohort``) and its reports
  tools             the BAM, graph and truth tools; ``remap_and_reduce``
  gpu_check         K1 against its plain version on the card, and its rate
  models/           pipeline (run_hla_typing), aligner (ReadAligner, and
                    NWRunner, the NW forward for host callers), typer
                    (HLATyper), linear_alts (LinearALTsTyper), kir_package,
                    asm (AssemblyTyper), graph-alignment records and the
                    graph-DP fallback
  ops/banded_nw     NW forward: kernel K1 (W <= 32) or K2 (W > 32) on
                    CUDA, plain PyTorch on CPU; numpy forward and backtrace
  ops/pair_ll       likelihood model: matmul + kernel K3 / plain PyTorch
  ops/graph_dp      graph-space extension DP (fallback realigner)
  csrc/             the CUDA sources of K1, K2 and K3, built by _build.py
  device            explicit device selection, no silent fallback
  mapping/          k-mer index, seeding, global alignment, decoy index
  graph/            PRG core, dense compilation, graph package I/O
  io/               FASTA/FASTQ/BAM/CRAM host I/O, the CRAM writer
  native            ctypes binding of native/hla_native.cpp
  sim/              PRG, read and truth simulators; typing worlds with
                    planted alleles
  utils/            phred/log-space helpers, config, stats
  profile_e2e       device-time breakdown of one CLI run
"""

__version__ = "0.1.0"
