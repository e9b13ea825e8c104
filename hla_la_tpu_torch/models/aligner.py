"""Read alignment with the banded NW forward on the port's device.

``TorchReadAligner`` is the reference ``ReadAligner`` (seeding, staging,
native backtrace, projection and pair selection all inherited) with two
changes:

- ``_run_nw`` runs every forward pass through ``banded_nw_forward_torch``
  (K1 for bands up to 32, K2 for the long-read band of 256; the plain
  version on the CPU) and hands the native backtrace numpy arrays
  (f32, i32, i32, u8 [B, L + 1, W] C-contiguous), as
  ``hla_la_tpu/models/aligner.py:498-506`` expects.  It counts the jobs in
  the aligner's stats as ``nw_jobs_on_<device>``.
- The jobs of one NW call are bounded by their pointer bytes, with one rule
  for short and long reads (``jobs_per_call``).  The reference's TPU gate
  for long reads (``aligner.py:178-202``) is not carried over.
"""

from __future__ import annotations

import torch

from hla_la_tpu.models.aligner import ReadAligner

from ..device import resolve
from ..ops.banded_nw import DEFAULT_SCORING, banded_nw_forward_torch

# Pointer bytes, B * (L + 1) * W, that one NW call may hold.  The u8 pointer
# tensor lives on the card and again on the host for the native backtrace,
# so this bounds both.  2 GiB keeps the reference's 65,536 jobs per call for
# short reads (3.2 KB each) and gives 838 jobs at L = 10,000 and W = 256,
# about six K2 blocks for each of an H100's 132 SMs.
NW_POINTER_BUDGET = 2 << 30


def jobs_per_call(L: int, W: int, max_jobs: int) -> int:
    """Jobs of read length up to `L` and band `W` that one NW call takes:
    at most `max_jobs`, at most NW_POINTER_BUDGET of pointers, at least 1."""
    return max(1, min(max_jobs, NW_POINTER_BUDGET // ((L + 1) * W)))


def _longest(all_reads, job_read) -> int:
    return max((len(all_reads[r].seq) for r in set(job_read.tolist())),
               default=0)


class TorchReadAligner(ReadAligner):
    def __init__(self, pkg, cfg=None, *, device: str | torch.device,
                 **kwargs):
        super().__init__(pkg, cfg, use_jax=False, **kwargs)
        self.device = resolve(device)
        self.scoring = DEFAULT_SCORING
        self._nw_len = None     # longest read of the jobs being sliced

    def _run_nw(self, reads_arr, lens_arr, refs_arr):
        out = banded_nw_forward_torch(reads_arr, lens_arr, refs_arr,
                                      self.scoring, self.device)
        self.stats.bump(f"nw_jobs_on_{self.device.type}", len(reads_arr))
        return tuple(t.cpu().numpy() for t in out)

    # The reference slices its jobs by _max_b(), which knows no read
    # length; each slicing entry point records the longest read of its jobs
    # for the length of its call.
    def _max_b(self) -> int:
        if self._nw_len is None:
            raise RuntimeError(
                "TorchReadAligner._max_b: no read length recorded; jobs are "
                "sliced only by _align_jobs_arrays, _align_jobs_soa and "
                "_jobs_to_alignments")
        return jobs_per_call(self._nw_len, self.band, super()._max_b())

    def _with_len(self, length: int, align, *args):
        self._nw_len = length
        try:
            return align(*args)
        finally:
            self._nw_len = None

    def _align_jobs_arrays(self, job_read, job_seq, job_rev, win_start,
                           all_reads, unpaired: bool = False):
        return self._with_len(_longest(all_reads, job_read),
                              super()._align_jobs_arrays, job_read, job_seq,
                              job_rev, win_start, all_reads, unpaired)

    def _align_jobs_soa(self, job_read, job_seq, job_rev, win_start,
                        all_reads, unpaired: bool = False):
        return self._with_len(_longest(all_reads, job_read),
                              super()._align_jobs_soa, job_read, job_seq,
                              job_rev, win_start, all_reads, unpaired)

    def _jobs_to_alignments(self, jobs):
        return self._with_len(max((len(j.oriented_seq) for j in jobs),
                                  default=0),
                              super()._jobs_to_alignments, jobs)
