// K2: batched banded glocal affine Needleman-Wunsch forward pass for long
// reads and bands wider than K1's (33 <= W <= 1024), for Hopper.
//
// Replaces the TPU kernel
// hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw_long, which chunks rows
// so that the band state fits in VMEM; here the band state lives in registers
// for the whole read and only the read and ref codes are staged chunk by
// chunk.  The row step, its design and what bounds it are in
// banded_nw_row.cuh; this file instantiates it
//   - at one warp per job: four cells per lane on 16 or 32 lanes up to
//     W = 128, eight cells per lane on 32 lanes up to W = 256 (the long-read
//     band: no block barrier, no shared-memory seam, one 8-byte pointer
//     store per lane and row);
//   - across the warps of a block, with two barriers per row, for wider
//     bands (eight cells per lane, up to four warps).

#include "banded_nw_row.cuh"

extern "C" int hla_banded_nw_long_forward(
    const void* reads, const void* lens, const void* refs, int B, int L,
    int W, float match, float mismatch, float gap_open, float gap_extend,
    void* score, void* end_k, void* end_state, void* pointers, int cpt,
    int lanes, int job_warps, int block_warps, int chunk, int job_words,
    void* stream) {
  using namespace hla_nw;
  if (B <= 0) return (int)cudaGetLastError();
  if (lanes * job_warps * cpt < W || job_warps < 1 ||
      job_warps > MAX_JOB_WARPS)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)reads, (const int32_t*)lens,
               (const uint8_t*)refs, B, L, W,
               Scoring{match, mismatch, gap_open, gap_extend},
               (float*)score, (int32_t*)end_k, (int32_t*)end_state,
               (uint8_t*)pointers, chunk, job_words};
  cudaStream_t s = (cudaStream_t)stream;
  if (job_warps > 1) {
    if (cpt != 8 || lanes != 32 || block_warps != job_warps)
      return (int)cudaErrorInvalidValue;
    return launch<8, 32, true>(a, block_warps, s);
  }
  if (block_warps < 1 || block_warps > MAX_BLOCK_WARPS)
    return (int)cudaErrorInvalidValue;
  if (cpt == 4 && lanes == 16) return launch<4, 16, false>(a, block_warps, s);
  if (cpt == 4 && lanes == 32) return launch<4, 32, false>(a, block_warps, s);
  if (cpt == 8 && lanes == 32) return launch<8, 32, false>(a, block_warps, s);
  return (int)cudaErrorInvalidValue;
}
