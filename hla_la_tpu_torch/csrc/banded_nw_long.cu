// K2: batched banded glocal affine Needleman-Wunsch forward pass for long
// reads and bands wider than a warp (33 <= W <= 1024), for Hopper.
//
// Replaces the TPU kernel
// hla_la_tpu/ops/pallas_nw.py::make_pallas_banded_nw_long and computes what
// K1 (banded_nw.cu) and hla_la_tpu/ops/banded_nw.py::make_jax_banded_nw
// compute: the three states D / IY / IX over band offsets k (ref prefix
// j = i + k), IX in closed form as a max-scan over k segmented at ref codes
// >= 4, the first argmax over state-major [D, IY, IX] x k at row read_len,
// and one pointer byte per cell (bits 0-1 D source, bit 2 IY extend, bit 3 IX
// extend).  The TPU kernel chunks rows so that the band state fits in VMEM;
// here the band state lives in registers for the whole read.
//
// Design: one thread block per job, band offset k on the threads
// (ceil(W / 32) warps), the three states in registers, rows stepped 1..L.
// Each warp runs K1's row step on its 32 offsets; three things cross the
// warp seams through shared memory, with two barriers per row:
//   - the IY source at (i-1, k+1) of a warp's lane 31 is lane 0 of the next
//     warp (published before barrier 1);
//   - the segmented IX max-scan: each warp scans its lanes, publishes its
//     tail value and whether it holds a masked ref code (before barrier 1),
//     and every warp then folds the tails of the warps before it into the
//     lanes whose segment reaches back past its first lane.  The segment of
//     offset k is the block-wide count of masked codes at offsets <= k, so a
//     wall in an earlier warp ends the carry;
//   - the IX pointer bit of a warp's lane 0 compares D and IX at offset
//     k - 1, lane 31 of the warp before (published before barrier 2).
// The values published before barrier 1 are read only between the barriers,
// and those published before barrier 2 only after it, so one buffer of each
// suffices: a warp cannot overwrite a carry before every warp has read it.
// Threads with k >= W (the last warp's idle lanes) take part in every
// shuffle and barrier with masked ref codes, write no pointer and cannot win
// the harvest.
//
// What bounds it on the card: each row is a serial step of roughly twenty
// shuffles and two block barriers, so a block's time is L times the row
// latency; the card is filled by running many jobs (blocks) at once.  The
// pointer tensor, B * (L + 1) * W bytes, is written once, a W-byte row per
// step in 32-byte pieces (537 MB at B = 128, L = 16,384, W = 256).
//
// Every score is an integer-valued float32, so the order of adds is exact;
// -1e30 (NEG) plus a small integer rounds back to NEG as in the reference.
// Offsets into the job's rows are 64-bit: B * (L + 1) * W passes 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;  // W <= 1024

struct Scoring {
  float match, mismatch, open, ext;
};

// carries between the warps of one block, indexed by warp
struct Seams {
  // published before barrier 1, read between the barriers
  float D0[MAX_WARPS], IY0[MAX_WARPS];  // lane 0's D, IY of the previous row
  float tail[MAX_WARPS];                // lane 31's warp-local segmented max
  int n_masked[MAX_WARPS];              // masked ref codes in the warp
  // published before barrier 2, read after it
  float nD31[MAX_WARPS], nIX31[MAX_WARPS];  // lane 31's new D and IX
  // the harvest's per-warp bests
  float hv[MAX_WARPS];
  int hi[MAX_WARPS];
};

// first argmax in (value desc, flat index asc) order
__device__ __forceinline__ void better(float v, int idx, float& bv, int& bi) {
  if (v > bv || (v == bv && idx < bi)) {
    bv = v;
    bi = idx;
  }
}

// Block-wide first argmax over state-major [D, IY, IX] x k (flat index
// s * W + k); the result is valid in thread 0.  Called by every thread.
__device__ void harvest(float D, float IY, float IX, int k, int W, int lane,
                        int warp, int n_warps, Seams& sm, float& score,
                        int& end_k, int& end_state) {
  float bv = __int_as_float(0xff800000);  // -inf: loses to every band cell
  int bi = 0x7fffffff;
  if (k < W) {
    bv = D;
    bi = k;
    better(IY, W + k, bv, bi);
    better(IX, 2 * W + k, bv, bi);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    better(ov, oi, bv, bi);
  }
  if (lane == 0) {
    sm.hv[warp] = bv;
    sm.hi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) better(sm.hv[w], sm.hi[w], bv, bi);
    score = bv;
    end_k = bi % W;
    end_state = bi / W;
  }
}

__global__ void banded_nw_long_kernel(const uint8_t* __restrict__ reads,
                                      const int32_t* __restrict__ lens, int L,
                                      const uint8_t* __restrict__ refs, int W,
                                      Scoring sc,
                                      float* __restrict__ out_score,
                                      int32_t* __restrict__ out_k,
                                      int32_t* __restrict__ out_state,
                                      uint8_t* __restrict__ pointers) {
  __shared__ Seams sm;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const bool in_band = k < W;
  const int len = lens[b];
  const uint8_t* read = reads + b * L;
  const uint8_t* ref = refs + b * (long long)(L + W);
  uint8_t* ptr = pointers + b * (long long)(L + 1) * W;
  const unsigned le_mask = (lane == 31) ? FULL : ((1u << (lane + 1)) - 1u);
  const float kf = (float)k;

  float D = 0.0f, IY = NEG, IX = NEG;
  float best = NEG;
  int best_k = 0, best_state = 0;
  if (in_band) ptr[k] = 0;
  if (len == 0)
    harvest(D, IY, IX, k, W, lane, warp, n_warps, sm, best, best_k,
            best_state);

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

    // warp-local segmented max-scan of g[k] = nD[k] - k * ext; the segment
    // id counts the warp's masked codes at lanes <= this one
    const unsigned masked = __ballot_sync(FULL, !ref_ok);
    const int seg = __popc(masked & le_mask);
    float gmax = ref_ok ? __fsub_rn(nD, __fmul_rn(kf, sc.ext)) : NEG;
    for (int sh = 1; sh < 32; sh <<= 1) {
      const float rg = __shfl_up_sync(FULL, gmax, sh);
      const int rs = __shfl_up_sync(FULL, seg, sh);
      gmax = fmaxf(gmax, (lane >= sh && rs == seg) ? rg : NEG);
    }
    if (lane == 0) {
      sm.D0[warp] = D;
      sm.IY0[warp] = IY;
      sm.n_masked[warp] = __popc(masked);
    }
    if (lane == 31) sm.tail[warp] = gmax;
    __syncthreads();  // barrier 1

    // IY: from (i-1, k+1); past the band edge the source is NEG
    float D_sh = __shfl_down_sync(FULL, D, 1);
    float IY_sh = __shfl_down_sync(FULL, IY, 1);
    if (lane == 31 && warp + 1 < n_warps) {
      D_sh = sm.D0[warp + 1];
      IY_sh = sm.IY0[warp + 1];
    }
    if (k + 1 >= W) {
      D_sh = NEG;
      IY_sh = NEG;
    }
    const float oc = __fadd_rn(D_sh, sc.open);
    const float ec = __fadd_rn(IY_sh, sc.ext);
    const float nIY = fmaxf(oc, ec);
    const unsigned iy_src = ec > oc ? 1u : 0u;

    // carry = the block-wide scan at offset 32 * warp - 1: a warp holding a
    // masked code starts a new segment inside it
    float carry = NEG;
    for (int w = 0; w < warp; ++w)
      carry = sm.n_masked[w] ? sm.tail[w] : fmaxf(carry, sm.tail[w]);
    if (seg == 0) gmax = fmaxf(gmax, carry);

    // IX closed form: IX[k] = open + (k-1)*ext + segmax_{j<k} (nD[j] - j*ext)
    float gprev = __shfl_up_sync(FULL, gmax, 1);
    if (lane == 0) gprev = carry;
    float nIX = NEG;
    if (k >= 1) {
      float t = __fadd_rn(sc.open, __fmul_rn(kf, sc.ext));
      t = __fsub_rn(t, sc.ext);
      nIX = __fadd_rn(t, gprev);
    }
    if (!ref_ok) nIX = NEG;

    float nD_prev = __shfl_up_sync(FULL, nD, 1);
    float nIX_prev = __shfl_up_sync(FULL, nIX, 1);
    if (lane == 31) {
      sm.nD31[warp] = nD;
      sm.nIX31[warp] = nIX;
    }
    __syncthreads();  // barrier 2
    if (lane == 0 && warp > 0) {
      nD_prev = sm.nD31[warp - 1];
      nIX_prev = sm.nIX31[warp - 1];
    }

    // IX pointer bit exactly as the sequential recurrence sets it:
    // IX[k-1] + ext > D[k-1] + open
    const float oc2 = (k >= 1) ? __fadd_rn(nD_prev, sc.open) : NEG;
    const float ec2 = (k >= 1) ? __fadd_rn(nIX_prev, sc.ext) : NEG;
    const unsigned ix_src = ec2 > oc2 ? 1u : 0u;

    if (in_band)
      ptr[(long long)i * W + k] =
          (uint8_t)(m_src | (iy_src << 2) | (ix_src << 3));
    D = nD;
    IY = nIY;
    IX = nIX;
    if (i == len)  // len is the block's own, so every thread enters
      harvest(D, IY, IX, k, W, lane, warp, n_warps, sm, best, best_k,
              best_state);
  }
  if (k == 0) {
    out_score[b] = best;
    out_k[b] = best_k;
    out_state[b] = best_state;
  }
}

}  // namespace

extern "C" int hla_banded_nw_long_forward(const void* reads, const void* lens,
                                          const void* refs, int B, int L,
                                          int W, float match, float mismatch,
                                          float gap_open, float gap_extend,
                                          void* score, void* end_k,
                                          void* end_state, void* pointers,
                                          void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Scoring sc{match, mismatch, gap_open, gap_extend};
  const int threads = 32 * ((W + 31) / 32);
  banded_nw_long_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (const int32_t*)lens, L, (const uint8_t*)refs, W,
      sc, (float*)score, (int32_t*)end_k, (int32_t*)end_state,
      (uint8_t*)pointers);
  return (int)cudaGetLastError();
}
