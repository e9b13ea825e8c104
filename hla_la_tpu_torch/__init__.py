"""hla_la_tpu_torch — the PyTorch/CUDA port of hla_la_tpu.

The reference JAX package stays beside it, unchanged.  The port owns only
the device seams of the ``--action HLA`` path, on paired short reads and on
long reads (``--longReads``), and imports every host layer (I/O, graph,
seeding, native code, backtrace, projection, typing model bookkeeping) from
``hla_la_tpu``:

  cli               the ``--action HLA`` entry point (``--device cuda|cpu``)
  models/pipeline   run_hla_typing over the port's aligner and typer
  models/aligner    TorchReadAligner: the NW forward on the device
  models/typer      TorchHLATyper: cluster likelihoods + pair reduction
  ops/banded_nw     NW forward: kernel K1 (W <= 32) or K2 (W > 32) on
                    CUDA, plain PyTorch on CPU
  ops/pair_ll       likelihood model: matmul + kernel K3 / plain PyTorch
  csrc/             the CUDA sources of K1, K2 and K3, built by _build.py
  device            explicit device selection, no silent fallback
  sim               simulated typing worlds with planted alleles
  profile_e2e       device-time breakdown of one CLI run

It never imports jax.
"""

__version__ = "0.1.0"
