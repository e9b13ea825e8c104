"""Read alignment with the banded NW forward on the port's device.

``TorchReadAligner`` is the reference ``ReadAligner`` (seeding, staging,
native backtrace, projection and pair selection all inherited) with one
override: ``_run_nw`` runs the forward pass through
``banded_nw_forward_torch`` (kernel K1 on CUDA, the plain version on CPU)
and hands the native backtrace numpy arrays
(f32, i32, i32, u8 [B, L + 1, W] C-contiguous), as
``hla_la_tpu/models/aligner.py:498-506`` expects.

Long-read shapes (band W > 32) are not K1's: they run the inherited host
forward, as the reference does by default (``aligner.py:189-202``).
"""

from __future__ import annotations

import torch

from hla_la_tpu.models.aligner import ReadAligner
from hla_la_tpu.utils.timing import log_progress

from ..device import resolve
from ..ops.banded_nw import DEFAULT_SCORING, banded_nw_forward_torch
from ..ops.cuda_nw import MAX_W


class TorchReadAligner(ReadAligner):
    def __init__(self, pkg, cfg=None, *, device: str | torch.device,
                 **kwargs):
        super().__init__(pkg, cfg, use_jax=False, **kwargs)
        self.device = resolve(device)
        self.scoring = DEFAULT_SCORING
        self.host_nw_batches = 0    # long-read batches sent to host NW

    def _run_nw(self, reads_arr, lens_arr, refs_arr):
        W = refs_arr.shape[1] - reads_arr.shape[1]
        if W > MAX_W:
            if not self.host_nw_batches:
                log_progress(f"band {W} > {MAX_W}: long-read NW runs on the "
                             "host (no device kernel for it yet)")
            self.host_nw_batches += 1
            return super()._run_nw(reads_arr, lens_arr, refs_arr)
        out = banded_nw_forward_torch(reads_arr, lens_arr, refs_arr,
                                      self.scoring, self.device)
        return tuple(t.cpu().numpy() for t in out)
