"""End-to-end HLA typing on the port's device: the counterpart of
``hla_la_tpu/models/pipeline.py::run_hla_typing`` (lines 129-214), built on
``TorchReadAligner`` and ``TorchHLATyper``.  The decoy index, the batched
alignment loop and the coverage track are the reference's own.

The device path is the serial path, as in the reference (its worker
processes run host code only), so ``max_threads`` is forced to 1.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from hla_la_tpu.models.pipeline import (PipelineResult, _align_all,
                                        _write_reads_per_level, build_decoy)
from hla_la_tpu.utils.config import RunConfig
from hla_la_tpu.utils.timing import Timer, log_progress

from ..device import resolve
from .aligner import TorchReadAligner
from .typer import TorchHLATyper


def run_hla_typing(pkg, pairs=None, unpaired=None, output_dir: str = ".",
                   cfg: RunConfig | None = None,
                   device: str | torch.device = "cuda",
                   truth=None) -> PipelineResult:
    dev = resolve(device)
    cfg = cfg or RunConfig()
    if cfg.max_threads > 1:
        log_progress(f"device {dev}: maxThreads {cfg.max_threads} -> 1 "
                     "(the device path is serial)")
        cfg = dataclasses.replace(cfg, max_threads=1)
    pairs = pairs or []
    unpaired = unpaired or []
    os.makedirs(output_dir, exist_ok=True)

    decoy = build_decoy(pkg, cfg)
    if decoy is not None:
        log_progress("paralog defense active (decoy k-mer index, "
                     f"{len(decoy.index.seq_names)} decoy contigs)")
    aligner = TorchReadAligner(pkg, cfg, decoy=decoy, device=dev)

    insert_mean, insert_sd = 300.0, 100.0
    if pairs:
        log_progress("estimating insert size distribution")
        insert_mean, insert_sd = aligner.estimate_insert_size(pairs)
        log_progress(f"insert size estimate: mean {insert_mean}, sd {insert_sd}")

    with Timer("align") as t_align:
        (aligned_pairs, kept_pairs, aligned_unpaired, kept_unpaired,
         _kp_idx, _ku_idx) = _align_all(aligner, pairs, unpaired,
                                        insert_mean, insert_sd,
                                        cfg.batch_size, truth)
    n_reads = 2 * len(pairs) + len(unpaired)
    rps = t_align.rate(n_reads)
    log_progress(f"aligned {len(aligned_pairs)}/{len(pairs)} pairs + "
                 f"{len(aligned_unpaired)}/{len(unpaired)} unpaired "
                 f"in {t_align.elapsed:.3f} s on {dev} ({rps:.1f} reads/s)")
    aligner.stats.n_align_calls += len(aligned_pairs)
    log_progress(aligner.stats.report())

    with Timer("type") as t_type:
        _write_reads_per_level(aligned_pairs, aligned_unpaired, pkg,
                               output_dir)
        typer = TorchHLATyper(pkg, cfg.typer, device=dev)
        results = typer.type_all(kept_pairs, aligned_pairs, kept_unpaired,
                                 aligned_unpaired, insert_mean, insert_sd,
                                 os.path.join(output_dir, "hla"),
                                 long_reads_mode=cfg.long_reads,
                                 n_workers=1)
    log_progress(f"typed {len(results)} loci in {t_type.elapsed:.3f} s "
                 f"on {dev}")
    return PipelineResult(results, len(pairs), len(aligned_pairs), rps,
                          insert_mean, insert_sd)
