// K3: the difference term of the diploid pair-likelihood reduction, for
// Hopper:
//
//   acc[c1, c2] = sum_r 0.5 * |a - b| + log1p(exp(-|a - b|)),
//   a = L[c1, r], b = L[c2, r],  L: [C, R] float32.
//
// Replaces the TPU kernels hla_la_tpu/ops/pallas_pair.py::_make_kernel and
// ::_make_kernel_v2, and the XLA scan hla_la_tpu/ops/pair_ll.py::
// make_pair_ll_jax that computes the same value on the TPU's main path.  The
// host wrapper adds the rank-1 term 0.5 * (rowsum[c1] + rowsum[c2]) and the
// per-read constant in float64, as pair_ll.py:252-257 does.
//
// Design: one block per 64 x 64 output tile, c1 <= c2 tiles only; the
// mirrored tile is written from the same registers, so the output is exactly
// symmetric.  256 threads, each holding a 4 x 4 register tile.  The L rows of
// both tiles are staged through shared memory in chunks of 32 reads
// (transposed, padded against bank conflicts).  Reads past R load as 0: each
// contributes log(2), which the wrapper cancels with log(1/2) per padded
// read, the padding identity of the reference.
//
// Accuracy and determinism: each chunk of 32 reads is summed into a fresh
// register partial, which is then added to the running float32 total, so the
// long sum over R takes R / 32 large adds instead of R.  The read order is
// fixed and there are no atomics: reruns are bit-identical.
//
// What bounds it on the card: the two transcendentals per cell (expf and
// log1pf, full precision, no fast-math), C^2 * R / 2 cells.  Memory traffic
// is small: each tile reads 2 * 64 * R floats for 64 * 64 * R cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;   // output tile edge (clusters)
constexpr int RK = 32;   // reads staged per chunk
constexpr int TPB = 256; // threads per block: 16 x 16, 4 x 4 cells each

__global__ void __launch_bounds__(TPB)
pair_ll_kernel(const float* __restrict__ L, int C, int R, int n_tiles,
               float* __restrict__ out) {
  // map the linear block id onto the upper-triangle tile pair (ti <= tj)
  int t = blockIdx.x;
  int ti = 0;
  while (t >= n_tiles - ti) {
    t -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * TC, j0 = tj * TC;

  __shared__ float As[RK][TC + 1];
  __shared__ float Bs[RK][TC + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;

  const int lr = tid & (RK - 1);  // read within the chunk this thread loads
  const int lc = tid >> 5;        // first tile row this thread loads

  for (int r0 = 0; r0 < R; r0 += RK) {
    const int r = r0 + lr;
#pragma unroll
    for (int q = 0; q < TC / (TPB / RK); ++q) {
      const int c = lc + q * (TPB / RK);
      const int ca = i0 + c, cb = j0 + c;
      As[lr][c] = (ca < C && r < R) ? L[(long long)ca * R + r] : 0.0f;
      Bs[lr][c] = (cb < C && r < R) ? L[(long long)cb * R + r] : 0.0f;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) part[m][n] = 0.0f;
    for (int rr = 0; rr < RK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = As[rr][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = Bs[rr][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float d = fabsf(a[m] - b[n]);
          part[m][n] += 0.5f * d + log1pf(expf(-d));
        }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] += part[m][n];
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c1 = i0 + ty + 16 * m;
    if (c1 >= C) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c2 = j0 + tx + 16 * n;
      if (c2 >= C) continue;
      out[(long long)c1 * C + c2] = acc[m][n];
      out[(long long)c2 * C + c1] = acc[m][n];
    }
  }
}

}  // namespace

// Rows past C are never stored; reads past R are padded with 0 up to the
// next multiple of hla_pair_ll_read_chunk().
extern "C" int hla_pair_ll_read_chunk() { return RK; }

extern "C" int hla_pair_ll_diff(const void* L, int C, int R, void* out,
                                void* stream) {
  if (C <= 0 || R <= 0) return (int)cudaGetLastError();
  const int n_tiles = (C + TC - 1) / TC;
  const int blocks = n_tiles * (n_tiles + 1) / 2;
  pair_ll_kernel<<<blocks, TPB, 0, (cudaStream_t)stream>>>(
      (const float*)L, C, R, n_tiles, (float*)out);
  return (int)cudaGetLastError();
}
