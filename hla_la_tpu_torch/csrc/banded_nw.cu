// K1: batched banded glocal affine Needleman-Wunsch forward pass for Hopper,
// bands up to 32 (the short-read band).
//
// Replaces the TPU kernel hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw.
// The row step, its design and what bounds it are in banded_nw_row.cuh; this
// file instantiates it at four band cells per lane and 1, 2, 4 or 8 lanes per
// job (32, 16, 8 or 4 jobs per warp), the narrowest group that covers the
// band.  At W = 32 a warp steps four jobs, 128 cells, per row and writes four
// whole 32-byte sectors of the pointer tensor with one store instruction.

#include "banded_nw_row.cuh"

extern "C" int hla_banded_nw_forward(const void* reads, const void* lens,
                                     const void* refs, int B, int L, int W,
                                     float match, float mismatch,
                                     float gap_open, float gap_extend,
                                     void* score, void* end_k,
                                     void* end_state, void* pointers, int cpt,
                                     int lanes, int job_warps,
                                     int block_warps, int chunk,
                                     int job_words, void* stream) {
  using namespace hla_nw;
  if (B <= 0) return (int)cudaGetLastError();
  if (cpt != 4 || job_warps != 1 || lanes * cpt < W || block_warps < 1 ||
      block_warps > MAX_BLOCK_WARPS)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)reads, (const int32_t*)lens,
               (const uint8_t*)refs, B, L, W,
               Scoring{match, mismatch, gap_open, gap_extend},
               (float*)score, (int32_t*)end_k, (int32_t*)end_state,
               (uint8_t*)pointers, chunk, job_words};
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch<4, 1, false>(a, block_warps, s);
    case 2: return launch<4, 2, false>(a, block_warps, s);
    case 4: return launch<4, 4, false>(a, block_warps, s);
    case 8: return launch<4, 8, false>(a, block_warps, s);
  }
  return (int)cudaErrorInvalidValue;
}
