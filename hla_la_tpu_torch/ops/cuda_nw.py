"""Wrapper of K1, the hand-written CUDA banded NW forward for bands up to a
warp's reach (``csrc/banded_nw.cu``), the port's replacement for the TPU
kernel ``hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw``, and the launch
plan that K1 and K2 (``ops/cuda_nw_long.py``) share.

Both kernels run one row step (``csrc/banded_nw_row.cuh``): a group of lanes
per job, several band cells per lane.  ``nw_launch_plan`` picks the cells per
lane, the lanes per job and the warps per job from the band alone.

Takes CUDA tensors only and launches on the current stream; the plain
PyTorch version lives in ``ops/banded_nw.py``.
"""

from __future__ import annotations

from typing import NamedTuple

from .. import _build
from .._lazy import torch

MAX_W = 32          # K1: the job's lanes fit a quarter of a warp
MAX_W_LONG = 1024   # K2
CHUNK_ROWS = 1024   # read rows staged in shared memory at a time
MAX_JOB_WARPS = 4   # csrc/banded_nw_row.cuh::MAX_JOB_WARPS
SMEM_BUDGET = 40 * 1024     # staged rows per block: several blocks fit an SM


class NWPlan(NamedTuple):
    cpt: int            # band cells per lane (4 or 8)
    lanes: int          # lanes per job inside one warp (a power of two)
    job_warps: int      # warps per job; 1: a warp holds 32 // lanes jobs
    block_warps: int    # warps per thread block
    chunk: int          # rows staged per chunk, a multiple of 4
    job_words: int      # 32-bit shared-memory words per job
    blocks: int
    threads: int        # per block
    smem_bytes: int     # dynamic shared memory per block

    @property
    def jobs_per_block(self) -> int:
        if self.job_warps > 1:
            return 1
        return self.block_warps * (32 // self.lanes)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def nw_launch_plan(B: int, L: int, W: int) -> NWPlan:
    """How K1 (W <= 32) and K2 (W <= 1024) cut a call of B jobs, read length
    L and band W over lanes, warps and blocks: a pure function of the
    shape.  The cells per lane and warps per job follow the band alone:
    on an H100 one warp per job was the fastest plan with many jobs and
    with few (PERF.md), so the batch size only sets the number of blocks.
    Four cells per lane up to W = 128, eight up to 256, and above that
    eight across as many warps as cover the band."""
    if not 2 <= W <= MAX_W_LONG:
        raise ValueError(f"band W={W} outside 2..{MAX_W_LONG}")
    cpt = 4 if W <= 128 else 8
    job_warps = -(-W // 256)
    if job_warps == 1:
        lanes = _pow2_at_least(-(-W // cpt))
        # many small jobs share a block; one warp per block spreads few
        # long jobs evenly over the SMs
        block_warps = 4 if W <= MAX_W else 1
    else:
        lanes = 32
        block_warps = job_warps
    plan = NWPlan(cpt, lanes, job_warps, block_warps, 0, 0, 0,
                  32 * block_warps, 0)
    jpb = plan.jobs_per_block
    # a job's words: the chunk's read codes, then its ref codes, which
    # reach the band (and one window) past the chunk; 32 + lanes words
    # of padding at most (below)
    band_words = lanes * job_warps * cpt // 4
    room = (SMEM_BUDGET // jpb // 4 - band_words - 32 - lanes) // 2 * 4
    chunk = max(4, min(-(-L // 4) * 4, CHUNK_ROWS, room // 4 * 4))
    job_words = chunk // 4 + chunk // 4 + band_words
    if lanes < 32:
        # the jobs of a warp start `lanes` banks apart
        job_words = -(-job_words // 32) * 32 + lanes
    return plan._replace(chunk=chunk, job_words=job_words,
                         blocks=-(-B // jpb),
                         smem_bytes=4 * job_words * jpb)


def check_nw_args(name: str, reads: torch.Tensor, read_lens: torch.Tensor,
                  refs: torch.Tensor, min_w: int, max_w: int
                  ) -> tuple[int, int, int]:
    """Raise on what the kernels do not take; (B, L, W) otherwise."""
    if not (reads.is_cuda and read_lens.is_cuda and refs.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if reads.dtype != torch.uint8 or refs.dtype != torch.uint8:
        raise TypeError("reads and refs must be uint8")
    if reads.dim() != 2 or refs.dim() != 2 or read_lens.dim() != 1:
        raise ValueError("reads [B, L], read_lens [B], refs [B, L + W]")
    B, L = reads.shape
    W = refs.shape[1] - L
    if refs.shape[0] != B or read_lens.shape[0] != B:
        raise ValueError("batch sizes differ")
    if not min_w <= W <= max_w:
        raise ValueError(f"band W={W} outside {min_w}..{max_w}")
    return B, L, W


def launch_nw(entry: str, reads: torch.Tensor, read_lens: torch.Tensor,
              refs: torch.Tensor, sc: dict, B: int, L: int, W: int,
              events: list | None = None) -> tuple[torch.Tensor, ...]:
    """Allocate the outputs and launch the C entry point `entry` with the
    plan of this shape; with an `events` list, append (start, end) CUDA
    events recorded around the launch."""
    reads = reads.contiguous()
    refs = refs.contiguous()
    lens = read_lens.to(torch.int32).contiguous()
    dev = reads.device
    score = torch.empty(B, dtype=torch.float32, device=dev)
    end_k = torch.empty(B, dtype=torch.int32, device=dev)
    end_state = torch.empty(B, dtype=torch.int32, device=dev)
    pointers = torch.empty((B, L + 1, W), dtype=torch.uint8, device=dev)
    plan = nw_launch_plan(B, L, W)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev)
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record(stream)
    rc = getattr(lib.lib, entry)(
        reads.data_ptr(), lens.data_ptr(), refs.data_ptr(), B, L, W,
        sc["match"], sc["mismatch"], sc["gap_open"], sc["gap_extend"],
        score.data_ptr(), end_k.data_ptr(), end_state.data_ptr(),
        pointers.data_ptr(), plan.cpt, plan.lanes, plan.job_warps,
        plan.block_warps, plan.chunk, plan.job_words, stream.cuda_stream)
    lib.check(entry, rc)
    if events is not None:
        end.record(stream)
        events.append((start, end))
    return score, end_k, end_state, pointers


def banded_nw_cuda(reads: torch.Tensor, read_lens: torch.Tensor,
                   refs: torch.Tensor, sc: dict
                   ) -> tuple[torch.Tensor, ...]:
    """reads [B, L] u8, read_lens [B] int, refs [B, L + W] u8 (all on one
    CUDA device) -> (score [B] f32, end_k [B] i32, end_state [B] i32,
    pointers [B, L + 1, W] u8)."""
    B, L, W = check_nw_args("banded_nw_cuda", reads, read_lens, refs, 2,
                            MAX_W)
    out = launch_nw("hla_banded_nw_forward", reads, read_lens, refs, sc,
                    B, L, W, banded_nw_cuda.events)
    banded_nw_cuda.launches += 1
    banded_nw_cuda.largest = max(banded_nw_cuda.largest,
                                 (B * L * W, B, L, W))
    return out


banded_nw_cuda.launches = 0
# the launch with the most cells since the count was last zeroed:
# (cells, B, L, W)
banded_nw_cuda.largest = (0, 0, 0, 0)
# a list, while a caller wants each launch timed: (start, end) CUDA events
# recorded around every launch are appended to it
banded_nw_cuda.events = None
