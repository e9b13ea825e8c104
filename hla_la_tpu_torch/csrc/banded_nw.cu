// K1: batched banded glocal affine Needleman-Wunsch forward pass for Hopper.
//
// Replaces the TPU kernel hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw
// and computes exactly what hla_la_tpu/ops/banded_nw.py::make_jax_banded_nw
// computes: the three states D / IY / IX over band offsets k (ref prefix
// j = i + k), IX in closed form as a max-scan over k segmented at ref codes
// >= 4, the first argmax over state-major [D, IY, IX] x k at row read_len,
// and one pointer byte per cell (bits 0-1 D source, bit 2 IY extend,
// bit 3 IX extend; banded_nw.py:35-38).
//
// Design: one warp per job, band offset k on the lanes (W <= 32), the three
// states in registers, rows stepped 1..L.  The IY source at (i-1, k+1) comes
// from __shfl_down_sync; the segmented IX max-scan is a Hillis-Steele scan
// of __shfl_up_sync steps whose segment id is the ballot prefix count of
// masked ref codes.  Each lane writes its pointer byte straight to
// pointers[b, i, k], so a warp stores one contiguous W-byte row per step.
//
// What bounds it on the card: the pointer tensor, B * (L + 1) * W bytes
// written once (214 MB at B = 65,536, L = 101, W = 32), plus roughly
// fifteen shuffles per row per warp.  Rows are a serial dependency inside a
// warp, so the card is filled by running many jobs (warps) at once, not by
// splitting a job.
//
// Every score is an integer-valued float32, so the order of adds is exact;
// -1e30 (NEG) plus a small integer rounds back to NEG as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

struct Scoring {
  float match, mismatch, open, ext;
};

// first argmax in (value desc, flat index asc) order
__device__ __forceinline__ void better(float v, int idx, float& bv, int& bi) {
  if (v > bv || (v == bv && idx < bi)) {
    bv = v;
    bi = idx;
  }
}

__device__ __forceinline__ void harvest(float D, float IY, float IX, int k,
                                        int W, float& score, int& end_k,
                                        int& end_state) {
  // lane-local best in state-major order: index s * W + k
  float bv = __int_as_float(0xff800000);  // -inf: loses to every band cell
  int bi = 0x7fffffff;
  if (k < W) {
    bv = D;
    bi = k;
    better(IY, W + k, bv, bi);
    better(IX, 2 * W + k, bv, bi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, bv, off);
    int oi = __shfl_xor_sync(FULL, bi, off);
    better(ov, oi, bv, bi);
  }
  score = bv;
  end_k = bi % W;
  end_state = bi / W;
}

__global__ void banded_nw_kernel(const uint8_t* __restrict__ reads,
                                 const int32_t* __restrict__ lens,
                                 const uint8_t* __restrict__ refs, int B,
                                 int L, int W, Scoring sc,
                                 float* __restrict__ out_score,
                                 int32_t* __restrict__ out_k,
                                 int32_t* __restrict__ out_state,
                                 uint8_t* __restrict__ pointers) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int k = lane;
  const bool in_band = k < W;
  const int len = lens[b];
  const uint8_t* read = reads + b * L;
  const uint8_t* ref = refs + b * (long long)(L + W);
  uint8_t* ptr = pointers + b * (long long)(L + 1) * W;
  const unsigned le_mask = (k == 31) ? FULL : ((1u << (k + 1)) - 1u);
  const float kf = (float)k;

  float D = 0.0f, IY = NEG, IX = NEG;
  float best = NEG;
  int best_k = 0, best_state = 0;
  if (in_band) ptr[k] = 0;
  if (len == 0) harvest(D, IY, IX, k, W, best, best_k, best_state);

  for (int i = 1; i <= L; ++i) {
    const uint8_t rc = read[i - 1];
    const uint8_t fc = in_band ? ref[i - 1 + k] : (uint8_t)4;
    const bool ref_ok = fc < 4;
    const float sub =
        !ref_ok ? NEG : ((rc == fc && rc < 4) ? sc.match : sc.mismatch);

    // D: from the best state at (i-1, k)
    const float iyix = fmaxf(IY, IX);
    const float prev_best = fmaxf(fmaxf(D, IY), IX);
    const unsigned m_src = (D >= iyix) ? 0u : ((IY >= IX) ? 1u : 2u);
    const float nD = __fadd_rn(prev_best, sub);

    // IY: from (i-1, k+1); past the band edge the source is NEG
    float D_sh = __shfl_down_sync(FULL, D, 1);
    float IY_sh = __shfl_down_sync(FULL, IY, 1);
    if (k + 1 >= W) {
      D_sh = NEG;
      IY_sh = NEG;
    }
    const float oc = __fadd_rn(D_sh, sc.open);
    const float ec = __fadd_rn(IY_sh, sc.ext);
    const float nIY = fmaxf(oc, ec);
    const unsigned iy_src = ec > oc ? 1u : 0u;

    // IX closed form: IX[k] = open + (k-1)*ext + segmax_{j<k} (nD[j] - j*ext)
    // with the running max segmented at masked ref codes
    const int seg = __popc(__ballot_sync(FULL, !ref_ok) & le_mask);
    float gmax = ref_ok ? __fsub_rn(nD, __fmul_rn(kf, sc.ext)) : NEG;
    for (int sh = 1; sh < W; sh <<= 1) {
      const float rg = __shfl_up_sync(FULL, gmax, sh);
      const int rs = __shfl_up_sync(FULL, seg, sh);
      gmax = fmaxf(gmax, (k >= sh && rs == seg) ? rg : NEG);
    }
    const float gprev = __shfl_up_sync(FULL, gmax, 1);
    float nIX = NEG;
    if (k >= 1) {
      float t = __fadd_rn(sc.open, __fmul_rn(kf, sc.ext));
      t = __fsub_rn(t, sc.ext);
      nIX = __fadd_rn(t, gprev);
    }
    if (!ref_ok) nIX = NEG;

    // IX pointer bit exactly as the sequential recurrence sets it:
    // IX[k-1] + ext > D[k-1] + open
    const float nD_prev = __shfl_up_sync(FULL, nD, 1);
    const float nIX_prev = __shfl_up_sync(FULL, nIX, 1);
    const float oc2 = (k >= 1) ? __fadd_rn(nD_prev, sc.open) : NEG;
    const float ec2 = (k >= 1) ? __fadd_rn(nIX_prev, sc.ext) : NEG;
    const unsigned ix_src = ec2 > oc2 ? 1u : 0u;

    if (in_band)
      ptr[(long long)i * W + k] = (uint8_t)(m_src | (iy_src << 2) | (ix_src << 3));
    D = nD;
    IY = nIY;
    IX = nIX;
    if (i == len) harvest(D, IY, IX, k, W, best, best_k, best_state);
  }
  if (lane == 0) {
    out_score[b] = best;
    out_k[b] = best_k;
    out_state[b] = best_state;
  }
}

}  // namespace

extern "C" int hla_banded_nw_forward(const void* reads, const void* lens,
                                     const void* refs, int B, int L, int W,
                                     float match, float mismatch,
                                     float gap_open, float gap_extend,
                                     void* score, void* end_k,
                                     void* end_state, void* pointers,
                                     void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Scoring sc{match, mismatch, gap_open, gap_extend};
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  banded_nw_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (const int32_t*)lens, (const uint8_t*)refs, B, L,
      W, sc, (float*)score, (int32_t*)end_k, (int32_t*)end_state,
      (uint8_t*)pointers);
  return (int)cudaGetLastError();
}
