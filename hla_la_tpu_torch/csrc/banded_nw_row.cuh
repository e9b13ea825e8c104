// The row step of K1 (banded_nw.cu) and K2 (banded_nw_long.cu): the batched
// banded glocal affine Needleman-Wunsch forward pass for Hopper.
//
// Computes exactly what hla_la_tpu/ops/banded_nw.py::make_jax_banded_nw
// computes: the three states D / IY / IX over band offsets k (ref prefix
// j = i + k), IX in closed form as a max-scan over k segmented at ref codes
// >= 4, the first argmax over state-major [D, IY, IX] x k at row read_len,
// and one pointer byte per cell (bits 0-1 D source, bit 2 IY extend, bit 3 IX
// extend), every row 1..L written.
//
// Design: a group of G lanes per job, CPT band cells per lane.  Lane g holds
// offsets k = g * CPT .. g * CPT + CPT - 1 of D, IY and IX in registers for
// the whole read.  With G < 32 a warp carries 32 / G jobs, so the shuffles of
// a row serve all of them (K1: CPT = 4, G = 8, four jobs and 128 cells per
// warp and row).  With MULTI a job spans the warps of its block, 32 lanes
// each, and three values cross the warp seams through shared memory with two
// barriers per row (bands wider than 256).
//
// Per row and lane:
//   - D and IY are plain register code over the lane's cells; only the IY
//     source of the lane's last cell comes from the next lane (two shuffles
//     per row, not per cell).
//   - IX[k] = open + (k-1)*ext + segmax_{j<k} (nD[j] - j*ext): a running max
//     over the lane's cells, restarted at a masked ref code, gives the lane's
//     total and the prefix before each cell; an exclusive max-scan over the
//     lane totals gives the carry into each lane (radix 2 up to 8 lanes;
//     radix 4 above, three dependent rounds of shuffles for 32 lanes); the
//     carry is then folded into the lane's cells up to its first masked
//     code, all cells at once.  "Lane g - m is in my segment" is read off
//     one ballot of the lanes that hold a masked code (a count of leading
//     zeros and a compare), so no segment id is shuffled.
//   - A warp-row in which no lane holds a masked code, the common one,
//     takes a copy of the row step without restarts, segments and selects.
//   - The IX pointer bit of a cell is a comparison made at the cell before
//     it; the bit of a lane's last cell reaches the next lane by a ballot.
//   - No global load: the read and the ref window are staged in shared
//     memory a chunk of rows at a time, as 32-bit words realigned to the
//     job's first byte; every four rows a lane takes CPT / 4 + 1 ref words
//     and one read word, and cuts each row's CPT codes out with a funnel
//     shift.
//   - The lane's CPT pointer bytes leave as one 4- or 8-byte store (a warp
//     writes whole 32-byte sectors); a band that is not a multiple of CPT
//     takes byte stores.
// Cells with k >= W feed no cell of the band (every dependency runs from
// lower k, except IY's, which the band edge cuts): they store nothing and
// cannot win the harvest, and the cell at k = W is held at NEG so that
// k = W - 1 sees the band edge.  Idle groups of a call's last warp repeat its last job and store
// nothing, so every shuffle runs under the full mask.
//
// What bounds it on the card: the pointer tensor, B * (L + 1) * W bytes
// written once.  The rows of a job are a serial dependency, so the card is
// filled by running many jobs at once; with few jobs the row's latency sets
// the time.
//
// Every score is an integer-valued float32, so the order of adds is exact;
// -1e30 (NEG) plus a small integer rounds back to NEG as in the reference,
// and a max is exact in any order.  Offsets into the job's rows are 64-bit:
// B * (L + 1) * W passes 2^31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hla_nw {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_JOB_WARPS = 4;     // ops/cuda_nw.py::MAX_JOB_WARPS
// warps per block: several warps of jobs, or the warps of one job
constexpr int MAX_BLOCK_WARPS = MAX_JOB_WARPS;
constexpr int NO_CELL = 0x7fffffff;  // loses every tie

struct Scoring {
  float match, mismatch, open, ext;
};

struct Args {
  const uint8_t* reads;
  const int32_t* lens;
  const uint8_t* refs;
  int B, L, W;
  Scoring sc;
  float* score;
  int32_t* end_k;
  int32_t* end_state;
  uint8_t* pointers;
  int chunk;      // rows staged at a time, a multiple of 4
  int job_words;  // staged 32-bit words per job
};

// carries between the warps of one job (MULTI), indexed by warp
struct Seams {
  // published before barrier 1, read between the barriers
  float D0[MAX_JOB_WARPS], IY0[MAX_JOB_WARPS];  // lane 0's first cell, row i-1
  float tail[MAX_JOB_WARPS];  // the warp's inclusive scan value at lane 31
  int masked[MAX_JOB_WARPS];  // the warp holds a masked ref code
  // published before barrier 2, read after it
  int bit[MAX_JOB_WARPS];  // the IX extend comparison at lane 31's last cell
  // the harvest's per-warp bests
  float hv[MAX_JOB_WARPS];
  int hi[MAX_JOB_WARPS];
};

// first argmax in (value desc, flat index asc) order
__device__ __forceinline__ void better(float v, int idx, float& bv, int& bi) {
  if (v > bv || (v == bv && idx < bi)) {
    bv = v;
    bi = idx;
  }
}

// bytes [off, off + 4) of a tensor of `total` bytes as one little-endian
// word, whatever the alignment of `p + off`; bytes past the end read as the
// pad code 4
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p,
                                          long long off, long long total) {
  const uint8_t* q = p + off;
  const unsigned s = (unsigned)((uintptr_t)q & 3u);
  const uint8_t* qa = q - s;
  if (qa >= p && qa + 8 <= p + total) {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(qa);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(qa + 4);
    return __funnelshift_r(lo, hi, 8 * s);
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t byte = (off + j < total) ? (uint32_t)q[j] : 4u;
    v |= byte << (8 * j);
  }
  return v;
}

template <int CPT, int G, bool MULTI>
__global__ void __launch_bounds__(32 * MAX_BLOCK_WARPS)
    nw_forward_kernel(const Args a) {
  static_assert(CPT == 4 || CPT == 8, "cells per lane");
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "lanes per job");
  static_assert(!MULTI || G == 32, "a job across warps takes whole warps");
  constexpr int WPC = CPT / 4;  // words of a lane's codes
  extern __shared__ uint32_t staged[];
  __shared__ Seams seams;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int gl = lane % G;                         // lane within the warp's group
  const int gt = MULTI ? (int)threadIdx.x : gl;    // lane within the job
  const int job_lanes = MULTI ? (int)blockDim.x : G;
  long long b;
  uint32_t* sjob;
  if (MULTI) {
    b = blockIdx.x;
    sjob = staged;
  } else {
    constexpr int JPW = 32 / G;
    const int slot = warp * JPW + lane / G;
    b = (long long)blockIdx.x * (n_warps * JPW) + slot;
    sjob = staged + slot * a.job_words;
  }
  const bool live = b < a.B;
  if (!live) b = a.B - 1;

  const int L = a.L, W = a.W, chunk = a.chunk;
  const float sc_match = a.sc.match, sc_mismatch = a.sc.mismatch;
  const float sc_open = a.sc.open, sc_ext = a.sc.ext;
  const int k0 = gt * CPT;
  const int len = a.lens[b];
  const bool ragged = (W % CPT) != 0;
  const bool edge = gt >= (W - 1) / CPT;  // no cell of the band after mine
  const bool stores = live && k0 < W;
  const int group_base = lane - gl;
  const unsigned below = (1u << gl) - 1u;  // the group's lanes before mine

  float kext[CPT], tk[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    kext[c] = __fmul_rn((float)(k0 + c), sc_ext);
    tk[c] = __fsub_rn(__fadd_rn(sc_open, kext[c]), sc_ext);
  }

  float D[CPT], IY[CPT], IX[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    D[c] = (k0 + c < W) ? 0.0f : NEG;
    IY[c] = NEG;
    IX[c] = NEG;
  }
  float bv = __int_as_float(0xff800000);  // -inf: loses to every band cell
  int bi = NO_CELL;

  // the lane's best cell of the current row, state-major index s * W + k
  auto snapshot = [&]() {
    bv = __int_as_float(0xff800000);
    bi = NO_CELL;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = k0 + c;
      if (k < W) {
        better(D[c], k, bv, bi);
        better(IY[c], W + k, bv, bi);
        better(IX[c], 2 * W + k, bv, bi);
      }
    }
  };

  // the lane's pointer bytes of one row; pw[] holds them packed
  uint8_t* prow = a.pointers + (b * (long long)(L + 1)) * W + k0;
  auto store_row = [&](const uint32_t* pw) {
    if (stores) {
      if (!ragged) {
        if (CPT == 4)
          *reinterpret_cast<uint32_t*>(prow) = pw[0];
        else
          *reinterpret_cast<uint2*>(prow) = make_uint2(pw[0], pw[WPC - 1]);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (k0 + c < W) prow[c] = (uint8_t)(pw[c / 4] >> (8 * (c % 4)));
      }
    }
    prow += W;
  };

  {
    uint32_t zero[WPC];
#pragma unroll
    for (int j = 0; j < WPC; ++j) zero[j] = 0;
    store_row(zero);
  }
  if (len == 0) snapshot();

  // One row: `fw` the lane's ref codes, `rc4` the read's code in every
  // byte, `hm` the warp's lanes with a masked code.  MASKS = false is the
  // path of a warp-row without any: no restart, no segment, no select.
  auto row = [&](auto masks_tag, const uint32_t* fw, uint32_t rc4,
                 unsigned hm) {
    constexpr bool MASKS = decltype(masks_tag)::value;
    uint32_t differs[WPC];
#pragma unroll
    for (int j = 0; j < WPC; ++j) differs[j] = fw[j] ^ rc4;
    auto masked_at = [&](int c) {
      return MASKS && (fw[c / 4] & (0xfcu << (8 * (c % 4)))) != 0;
    };

    // D from the best state at (i-1, k); g[k] = nD[k] - k * ext; pre[c] is
    // the max of g over the lane's cells before c, restarted at a masked
    // code, and the lane's total the same over all its cells
    float nD[CPT], pre[CPT];
    uint32_t pw[WPC];
#pragma unroll
    for (int j = 0; j < WPC; ++j) pw[j] = 0;
    float total = NEG;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const uint32_t at = 8 * (c % 4);
      const bool same = (differs[c / 4] & (0xffu << at)) == 0;
      float sub = same ? sc_match : sc_mismatch;
      if (masked_at(c)) sub = NEG;
      const float iyix = fmaxf(IY[c], IX[c]);
      // max(max(D, IY), IX), a max being exact in any order
      nD[c] = __fadd_rn(fmaxf(D[c], iyix), sub);
      if (!(D[c] >= iyix)) pw[c / 4] |= (IY[c] >= IX[c] ? 1u : 2u) << at;
      pre[c] = total;
      const float g = __fsub_rn(nD[c], kext[c]);
      total = masked_at(c) ? NEG : fmaxf(total, g);
    }

    // exclusive max-scan of the lane totals across the group.  Lane g - m
    // is in my segment when no lane in [g - m + 1, g - 1] holds a masked
    // code, that is when m <= near: the distance to the nearest such lane
    // before mine, or to the group's first lane.
    int near = gl;
    bool clear = true;  // no lane of the group before mine holds one
    if (MASKS) {
      const unsigned zb = (hm >> group_base) & below;
      if (zb) {
        near = gl - 31 + __clz(zb);
        clear = false;
      }
    }
    float carry = NEG;
    if (G >= 16) {
      // radix 4: three dependent rounds of shuffles for 32 lanes
      float o[4];
#pragma unroll
      for (int m = 1; m <= 4; ++m) o[m - 1] = __shfl_up_sync(FULL, total, m, G);
#pragma unroll
      for (int m = 1; m <= 4; ++m)
        if (m <= near) carry = fmaxf(carry, o[m - 1]);
#pragma unroll
      for (int base = 4; base < G; base *= 4) {
        float q[3];
#pragma unroll
        for (int m = 1; m <= 3; ++m)
          if (m * base < G) q[m - 1] = __shfl_up_sync(FULL, carry, m * base, G);
#pragma unroll
        for (int m = 1; m <= 3; ++m)
          if (m * base < G && (!MASKS || m * base < near))
            carry = fmaxf(carry, q[m - 1]);
      }
    } else if (G > 1) {
      carry = __shfl_up_sync(FULL, total, 1, G);
      if (near < 1) carry = NEG;
#pragma unroll
      for (int sh = 1; sh < G - 1; sh <<= 1) {
        const float o = __shfl_up_sync(FULL, carry, sh, G);
        if (!MASKS || sh < near) carry = fmaxf(carry, o);
      }
    }

    if (MULTI) {
      if (lane == 31)
        seams.tail[warp] =
            (fw[WPC - 1] | fw[0]) & 0xfcfcfcfcu ? total : fmaxf(carry, total);
      if (lane == 0) {
        seams.D0[warp] = D[0];
        seams.IY0[warp] = IY[0];
        seams.masked[warp] = hm != 0;
      }
      __syncthreads();  // barrier 1
      // the scan value at the last cell of the warp before mine: a warp
      // that holds a masked code starts a new segment inside it
      float across = NEG;
      for (int w = 0; w < warp; ++w)
        across =
            seams.masked[w] ? seams.tail[w] : fmaxf(across, seams.tail[w]);
      if (clear) carry = fmaxf(carry, across);
    }

    // IY from (i-1, k+1): the next cell of the lane, for the last cell the
    // next lane's first; past the band edge the source is NEG
    float D_next = __shfl_down_sync(FULL, D[0], 1, G);
    float IY_next = __shfl_down_sync(FULL, IY[0], 1, G);
    if (MULTI && lane == 31 && warp + 1 < n_warps) {
      D_next = seams.D0[warp + 1];
      IY_next = seams.IY0[warp + 1];
    }
    if (edge) {
      D_next = NEG;
      IY_next = NEG;
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float oc = __fadd_rn(c + 1 < CPT ? D[c + 1] : D_next, sc_open);
      const float ec = __fadd_rn(c + 1 < CPT ? IY[c + 1] : IY_next, sc_ext);
      D[c] = nD[c];
      IY[c] = fmaxf(oc, ec);
      if (ec > oc) pw[c / 4] |= 4u << (8 * (c % 4));
    }

    // the carry folded into the cells up to the lane's first masked code;
    // the IX pointer bit of cell k is the comparison
    // IX[k-1] + ext > D[k-1] + open made at cell k - 1
    bool bit = false;
    bool open_to_carry = true;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (c > 0 && bit) pw[c / 4] |= 8u << (8 * (c % 4));
      const float run = open_to_carry ? fmaxf(carry, pre[c]) : pre[c];
      IX[c] = masked_at(c) ? NEG : __fadd_rn(tk[c], run);
      if (masked_at(c)) open_to_carry = false;
      bit = __fadd_rn(IX[c], sc_ext) > __fadd_rn(nD[c], sc_open);
    }
    const unsigned bo = __ballot_sync(FULL, bit);
    unsigned prev_bit = gl > 0 ? (bo >> (lane - 1)) & 1u : 0u;
    if (MULTI) {
      if (lane == 31) seams.bit[warp] = bit;
      __syncthreads();  // barrier 2
      if (lane == 0 && warp > 0) prev_bit = seams.bit[warp - 1];
    }
    pw[0] |= prev_bit << 3;
    store_row(pw);

    if (ragged) {  // the cell at k = W hands NEG to k = W - 1
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (k0 + c >= W) {
          D[c] = NEG;
          IY[c] = NEG;
        }
    }
  };

  const long long read_base = b * L;
  const long long ref_base = b * (long long)(L + W);
  const long long reads_total = (long long)a.B * L;
  const long long refs_total = (long long)a.B * (L + W);
  uint32_t* sread = sjob;
  uint32_t* sref = sjob + chunk / 4;
  const int n_ref_words = chunk / 4 + job_lanes * WPC;

  for (int i0 = 0; i0 < L; i0 += chunk) {
    // stage the chunk's read codes and the ref codes its windows reach
    if (i0) {
      if (MULTI) __syncthreads(); else __syncwarp();
    }
    for (int w = gt; w < chunk / 4; w += job_lanes)
      sread[w] = load4(a.reads, read_base + i0 + 4 * w, reads_total);
    for (int w = gt; w < n_ref_words; w += job_lanes)
      sref[w] = load4(a.refs, ref_base + i0 + 4 * w, refs_total);
    if (MULTI) __syncthreads(); else __syncwarp();

    const int rows = min(chunk, L - i0);
    for (int r = 0; r < rows; r += 4) {
      const uint32_t rdw = sread[r >> 2];
      uint32_t rw[WPC + 1];
#pragma unroll
      for (int j = 0; j <= WPC; ++j) rw[j] = sref[(r >> 2) + gt * WPC + j];

#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r + u >= rows) break;
        // codes of the row: the lane's ref window, and which lanes of the
        // warp hold a masked code in theirs
        uint32_t fw[WPC];
        uint32_t high = 0;
#pragma unroll
        for (int j = 0; j < WPC; ++j) {
          fw[j] = __funnelshift_r(rw[j], rw[j + 1], 8 * u);
          high |= fw[j];
        }
        const unsigned hm = __ballot_sync(FULL, (high & 0xfcfcfcfcu) != 0);
        const uint32_t rc4 = __byte_perm(rdw, 0, 0x1111 * u);
        // a job across warps keeps to one path: its barriers must be met
        // by every warp of the block
        if (!MULTI && hm == 0)
          row(std::false_type{}, fw, rc4, hm);
        else
          row(std::true_type{}, fw, rc4, hm);
        if (i0 + r + u + 1 == len) snapshot();
      }
    }
  }

  // the job's first argmax over its lanes
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, off, G);
    const int oi = __shfl_xor_sync(FULL, bi, off, G);
    better(ov, oi, bv, bi);
  }
  if (MULTI) {
    if (lane == 0) {
      seams.hv[warp] = bv;
      seams.hi[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 1; w < n_warps; ++w) better(seams.hv[w], seams.hi[w], bv, bi);
  }
  if (live && gt == 0) {
    const bool none = bi == NO_CELL;  // read_len outside 0..L: no row harvested
    a.score[b] = none ? NEG : bv;
    a.end_k[b] = none ? 0 : bi % W;
    a.end_state[b] = none ? 0 : bi / W;
  }
}

// Launch one instantiation for B jobs; the block holds `block_warps` warps.
template <int CPT, int G, bool MULTI>
int launch(const Args& a, int block_warps, cudaStream_t stream) {
  const int jobs_per_block = MULTI ? 1 : block_warps * (32 / G);
  const int blocks = (a.B + jobs_per_block - 1) / jobs_per_block;
  const size_t smem = sizeof(uint32_t) * (size_t)a.job_words * jobs_per_block;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_forward_kernel<CPT, G, MULTI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nw_forward_kernel<CPT, G, MULTI>
      <<<blocks, 32 * block_warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace hla_nw
