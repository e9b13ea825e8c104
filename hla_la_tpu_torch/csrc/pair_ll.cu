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
// per-read constant in float64.
//
// What bounds it on the card: the two transcendentals per cell.  An SM
// retires 16 special-function results per clock, so C (C + 1) / 2 * R cells
// cost at least 2 / 16 clocks each on 132 SMs; memory traffic is small (each
// 64 x 64 tile reads 2 * 64 * R floats for 64 * 64 * R cells) and there is no
// matrix product in the function, so the tensor cores have no part in it.
//
// Design, so that the special-function units and not instruction issue are
// the limit:
//
// - Seven instructions per cell: d = a - b; e = ex2(-|d| * log2 e);
//   l = lg2(1 + e); two running sums, of l and of |d|.  ex2.approx.ftz and
//   lg2.approx.ftz are one special-function instruction each (the .ftz forms
//   need no range fix-up), |.| and the sign ride on the operands, and the
//   factors ln 2 and 0.5 are applied once per 32-read partial:
//   0.5 * sum |d| + ln 2 * sum l.  1 + e lies in (1, 2], where lg2.approx
//   has a small absolute error, the error that counts in a sum.
// - One block per 64 x 64 output tile with c1 <= c2, found from the block
//   index in closed form; 256 threads, each holding a 4 x 4 register tile of
//   neighbouring rows and columns, so one 16-byte shared-memory load brings
//   the four a and one the four b of a read.
// - The rows of both tiles arrive by cp.async in stages of 32 reads, two
//   stages in flight: the copies of stage k + 1 run under the arithmetic of
//   stage k.  Every copy is 4 bytes, read-major in shared memory, which takes
//   any R and any alignment with one code path; the copies are under 1% of
//   the block's instructions.  A read past R or a row past C is zero-filled
//   by the copy itself (source size 0): such a read adds log 2 to every cell,
//   which the wrapper cancels with log(1/2) per padded read.
// - The read range is cut into n_split equal parts when that evens out the
//   last wave (630 tiles on 264 block slots are 2.4 waves, 1,260 half-tiles
//   4.8): each part's partial tile goes to scratch memory and a second
//   kernel adds the parts in a fixed order.  The host picks n_split from the
//   tile count and the occupancy the runtime reports.
//
// Accuracy and determinism: each stage of 32 reads is summed into fresh
// register partials, and the partial is added to the running total with a
// compensated (two-sum) add, so the long sum over R loses no more than the
// output's own rounding.  The read order is fixed, there are no atomics, and
// the split depends only on (C, R) and the card: reruns are bit-identical.
// The mirrored cell is written from the same register, so the output is
// exactly symmetric.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;     // output tile edge (clusters)
constexpr int RK = 32;     // reads per stage
constexpr int TPB = 256;   // threads per block: 16 x 16, 4 x 4 cells each
constexpr int LD = TC + 4; // shared-memory row stride: rows stay 16-B aligned
constexpr int MAX_SPLIT = 4;
constexpr int MIN_CHUNKS_PER_SPLIT = 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte asynchronous copy global -> shared; src_bytes = 0 writes zero
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// first linear index of tile row ti in the row-major upper triangle
__device__ __forceinline__ long long tile_row_start(int ti, int n_tiles) {
  return (long long)ti * n_tiles - (long long)ti * (ti - 1) / 2;
}

// linear block index -> (ti, tj), ti <= tj
__device__ __forceinline__ void tile_of(int t, int n_tiles, int* ti_out,
                                        int* tj_out) {
  const double b = 2.0 * n_tiles + 1.0;
  int ti = (int)((b - sqrt(b * b - 8.0 * t)) * 0.5);
  if (ti < 0) ti = 0;
  if (ti > n_tiles - 1) ti = n_tiles - 1;
  while (ti + 1 < n_tiles && tile_row_start(ti + 1, n_tiles) <= t) ++ti;
  while (tile_row_start(ti, n_tiles) > t) --ti;
  *ti_out = ti;
  *tj_out = ti + (int)(t - tile_row_start(ti, n_tiles));
}

// writes cell (c1, c2) and its mirror; a diagonal tile holds both cells of
// a pair, and only the c1 <= c2 one writes
__device__ __forceinline__ void store_pair(float* __restrict__ out, int C,
                                           int c1, int c2, bool diagonal,
                                           float v) {
  if (c1 >= C || c2 >= C || (diagonal && c1 > c2)) return;
  out[(long long)c1 * C + c2] = v;
  out[(long long)c2 * C + c1] = v;
}

__global__ void __launch_bounds__(TPB, 2)
pair_ll_kernel(const float* __restrict__ L, int C, int R, int n_tiles,
               int n_chunks, int n_split, float* __restrict__ out,
               float* __restrict__ scratch) {
  __shared__ __align__(16) float As[2][RK * LD];
  __shared__ __align__(16) float Bs[2][RK * LD];

  int ti, tj;
  tile_of(blockIdx.x, n_tiles, &ti, &tj);
  const int i0 = ti * TC, j0 = tj * TC;
  const int split = blockIdx.y;
  const int k_lo = (int)((long long)n_chunks * split / n_split);
  const int k_hi = (int)((long long)n_chunks * (split + 1) / n_split);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, wid = tid >> 5;

  // stage `st` <- reads [k * RK, (k + 1) * RK) of the rows of both tiles:
  // a warp copies 32 neighbouring reads of one row at a time
  auto load_stage = [&](int st, int k) {
    const int r = k * RK + lane;
    const bool r_ok = r < R;
#pragma unroll
    for (int q = 0; q < TC / (TPB / 32); ++q) {
      const int c = wid + q * (TPB / 32);
      const int ca = i0 + c, cb = j0 + c;
      const bool a_ok = r_ok && ca < C, b_ok = r_ok && cb < C;
      cp_async4(&As[st][lane * LD + c],
                a_ok ? L + (long long)ca * R + r : L, a_ok ? 4 : 0);
      cp_async4(&Bs[st][lane * LD + c],
                b_ok ? L + (long long)cb * R + r : L, b_ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float hi[4][4], lo[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) hi[m][n] = lo[m][n] = 0.0f;

  if (k_lo < k_hi) load_stage(0, k_lo);
  for (int k = k_lo; k < k_hi; ++k) {
    const int st = (k - k_lo) & 1;
    if (k + 1 < k_hi) {
      load_stage(st ^ 1, k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float pl[4][4], pd[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) pl[m][n] = pd[m][n] = 0.0f;
    const float* as = &As[st][4 * ty];
    const float* bs = &Bs[st][4 * tx];
#pragma unroll 2
    for (int rr = 0; rr < RK; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(as + rr * LD);
      const float4 bv = *reinterpret_cast<const float4*>(bs + rr * LD);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float d = fabsf(a[m] - b[n]);
          pl[m][n] += lg2_approx(1.0f + ex2_approx(d * -LOG2E));
          pd[m][n] += d;
        }
    }
    // total += 0.5 * sum |d| + ln 2 * sum l, as a two-sum: `lo` keeps what
    // the float32 add to `hi` rounds away
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float v = fmaf(LN2, pl[m][n], 0.5f * pd[m][n]);
        const float s = hi[m][n] + v;
        const float bb = s - hi[m][n];
        lo[m][n] += (hi[m][n] - (s - bb)) + (v - bb);
        hi[m][n] = s;
      }
    __syncthreads();
  }

  if (n_split == 1) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        store_pair(out, C, i0 + 4 * ty + m, j0 + 4 * tx + n, ti == tj,
                   hi[m][n] + lo[m][n]);
  } else {
    // partial tile of this read range, [split][tile][row][col]
    float* part = scratch +
        ((long long)split * gridDim.x + blockIdx.x) * (TC * TC);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float4 v;
      v.x = hi[m][0] + lo[m][0];
      v.y = hi[m][1] + lo[m][1];
      v.z = hi[m][2] + lo[m][2];
      v.w = hi[m][3] + lo[m][3];
      *reinterpret_cast<float4*>(part + (4 * ty + m) * TC + 4 * tx) = v;
    }
  }
}

// out tile = the partial tiles of the n_split read ranges, added in order
__global__ void __launch_bounds__(TPB)
pair_ll_join_kernel(const float* __restrict__ scratch, int C, int n_tiles,
                    int n_split, float* __restrict__ out) {
  int ti, tj;
  tile_of(blockIdx.x, n_tiles, &ti, &tj);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long split_stride = (long long)gridDim.x * (TC * TC);
  const float* part = scratch + (long long)blockIdx.x * (TC * TC);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int cell = (4 * ty + m) * TC + 4 * tx + n;
      double sum = 0.0;
      for (int s = 0; s < n_split; ++s)
        sum += (double)part[s * split_stride + cell];
      store_pair(out, C, ti * TC + 4 * ty + m, tj * TC + 4 * tx + n,
                 ti == tj, (float)sum);
    }
}

// Parts the read range is cut into: the count, up to MAX_SPLIT, that fills
// the last wave of blocks best (the smallest such count), with at least
// MIN_CHUNKS_PER_SPLIT stages of RK reads in each part.
int choose_split(long long tiles, int n_chunks, int* err) {
  static int slots = 0;   // blocks the card holds at once
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pair_ll_kernel, TPB, 0);
    if (e != cudaSuccess || sms * per_sm <= 0) {
      *err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidValue;
      return 1;
    }
    slots = sms * per_sm;
  }
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= MAX_SPLIT && n_chunks / s >= MIN_CHUNKS_PER_SPLIT;
       ++s) {
    const long long units = tiles * s;
    const long long waves = (units + slots - 1) / slots;
    const double fill = (double)units / (double)(waves * slots);
    if (fill > best_fill + 0.02) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

long long tile_count(int C) {
  const long long n_tiles = (C + TC - 1) / TC;
  return n_tiles * (n_tiles + 1) / 2;
}

}  // namespace

// Rows past C are never stored; reads past R are padded with 0 up to the
// next multiple of hla_pair_ll_read_chunk().
extern "C" int hla_pair_ll_read_chunk() { return RK; }

// float32 elements of scratch memory hla_pair_ll_diff needs for (C, R);
// negative: a CUDA error code, negated
extern "C" long long hla_pair_ll_scratch_floats(int C, int R) {
  if (C <= 0 || R <= 0) return 0;
  int err = 0;
  const int n_split = choose_split(tile_count(C), (R + RK - 1) / RK, &err);
  if (err != 0) return -(long long)err;
  return n_split > 1 ? (long long)n_split * tile_count(C) * (TC * TC) : 0;
}

extern "C" int hla_pair_ll_diff(const void* L, int C, int R, void* out,
                                void* scratch, long long scratch_floats,
                                void* stream) {
  if (C <= 0 || R <= 0) return (int)cudaGetLastError();
  const int n_tiles = (C + TC - 1) / TC;
  const long long tiles = tile_count(C);
  const int n_chunks = (R + RK - 1) / RK;
  int err = 0;
  const int n_split = choose_split(tiles, n_chunks, &err);
  if (err != 0) return err;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_split > 1 &&
      (scratch == nullptr || scratch_floats < n_split * tiles * (TC * TC)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  pair_ll_kernel<<<dim3((unsigned)tiles, n_split), TPB, 0, st>>>(
      (const float*)L, C, R, n_tiles, n_chunks, n_split, (float*)out,
      (float*)scratch);
  err = (int)cudaGetLastError();
  if (err != 0 || n_split == 1) return err;
  pair_ll_join_kernel<<<(unsigned)tiles, TPB, 0, st>>>(
      (const float*)scratch, C, n_tiles, n_split, (float*)out);
  return (int)cudaGetLastError();
}
