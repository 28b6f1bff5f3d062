// Gram-Schmidt orthonormalization of PowerSGD's P factor (K11).
//
// Replaces the Pallas kernel src/repro/kernels/orthogonalize.py::orthogonalize_2d
// (the loop of its _gs_padded).  Input: the (rows, r) float32 factor
// P = M @ Q, r <= 64, row-major; output: the same shape with its columns
// orthonormalized.  The TPU kernel pads P to a (rows_p, 128) tile for its
// 128-lane registers; this kernel takes the factor as it is.  For pivot j,
// in the order of _gs_padded:
//   1. take column j of the remaining block;
//   2. re-orthogonalize it against every basis column in turn, each dot
//      product taken with the already-updated vector;
//   3. scale it by 1/sqrt(max(v.v, 1e-30)) (IEEE division and sqrtf, not
//      rsqrtf; the build's -fmad=false keeps products and sums apart);
//   4. project it out of every later column at once, each dot product taken
//      against the block before this update.
// Zero columns stay exactly zero (0 * 1e15).
//
// Bound: latency.  The bytes (the factor read once and written once, 26 KB
// at smallnet's bucket) take under ten nanoseconds at 3.35 TB/s, but the
// loop is a chain of r(r-1)/2 + r + (r-1) dependent block-wide reductions
// (13 at r = 4).
//
// Design.  One block of 256 threads, as the TPU kernel is one grid step.
// Thread t owns rows t, t + 256, ...; element-wise updates touch only the
// owner's rows, so only the reductions cross threads.  Every dot product is
// reduced in a fixed order -- each thread over its rows in order, a
// shuffle-down tree in each warp, then the warps in index order, summed
// alike by every thread -- with no float atomics, so the result repeats bit
// for bit, and one barrier a reduction (step 4's r - j - 1 dot products
// share theirs).  Two paths, picked by shape, reduce in that one order and
// give the same bits:
//   registers  r <= 8 and rows <= 1024 (every factor of a bucket up to the
//              4 MB target, so all of the main path's): the factor is
//              loaded once into its owners' registers (4 rows of r floats
//              each), the whole loop unrolled at compile time for that r,
//              and written back once, so every dot product and update is
//              register arithmetic and a reduction costs one shuffle tree
//              and one barrier.  Holding the factor in shared memory with
//              run-time loops instead took 13.2 us at (809, 4), barely
//              below the 15.2 us of the global path, whose passes hit L1;
//              in registers it takes about 4.5 us (NVIDIA H100, 700 W).
//   global     anything larger, up to (rows, 64) at any row count: the
//              factor is copied into the output buffer and worked there.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RANK = 64;       // CompressorConfig.rank <= 64
constexpr int REG_RANK = 8;        // kernels/orthogonalize.py REG_RANK
constexpr int REG_ROWS = 4;        // rows a thread holds: rows <= 1024
constexpr float EPS = 1e-30f;      // orthogonalize.EPS

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL_MASK, v, off);
  return v;  // lane 0 holds the warp's sum
}

// Sum of every thread's partial, the same value in every thread.  The two
// halves of buf alternate between calls: a thread writes one half only after
// the barrier of the previous call, which every thread reaches after reading
// the half before it, so one barrier per reduction suffices.
__device__ __forceinline__ float block_sum(float part, float (*buf)[WARPS], int& round) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* half = buf[round & 1];
  ++round;
  part = warp_sum(part);
  if (lane == 0) half[warp] = part;
  __syncthreads();
  float total = half[0];
  for (int w = 1; w < WARPS; ++w) total = total + half[w];
  return total;
}

// Step 4's dot products: lane 0 of each warp has left its warp's partial of
// column c in multi[warp][c]; after the one barrier every thread adds them
// in warp order.  multi is written again only in the next pivot, after its
// norm's barrier, which every thread reaches after reading it here.
__device__ __forceinline__ float warps_total(const float (*multi)[MAX_RANK], int c) {
  float total = multi[0][c];
  for (int w = 1; w < WARPS; ++w) total = total + multi[w][c];
  return total;
}

template <int R>
__global__ void __launch_bounds__(THREADS)
gram_schmidt_regs(const float* __restrict__ p, float* __restrict__ out, int rows) {
  __shared__ float s_buf[2][WARPS];
  __shared__ float s_multi[WARPS][MAX_RANK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int round = 0;
  float a[REG_ROWS][R];  // a[i][k]: element (tid + 256 i, k)
  bool own[REG_ROWS];
#pragma unroll
  for (int i = 0; i < REG_ROWS; ++i) {
    own[i] = tid + THREADS * i < rows;
#pragma unroll
    for (int k = 0; k < R; ++k) a[i][k] = own[i] ? p[(tid + THREADS * i) * R + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int k = 0; k < j; ++k) {  // reorthogonalize against basis column k
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < REG_ROWS; ++i)
        if (own[i]) part = part + a[i][k] * a[i][j];
      const float d = block_sum(part, s_buf, round);
#pragma unroll
      for (int i = 0; i < REG_ROWS; ++i) a[i][j] = a[i][j] - d * a[i][k];
    }
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < REG_ROWS; ++i)
      if (own[i]) part = part + a[i][j] * a[i][j];
    const float scale = 1.0f / sqrtf(fmaxf(block_sum(part, s_buf, round), EPS));
#pragma unroll
    for (int i = 0; i < REG_ROWS; ++i) a[i][j] = a[i][j] * scale;
    if (j + 1 == R) break;
#pragma unroll
    for (int c = j + 1; c < R; ++c) {  // all later columns' dot products in one round
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < REG_ROWS; ++i)
        if (own[i]) acc = acc + a[i][j] * a[i][c];
      acc = warp_sum(acc);
      if (lane == 0) s_multi[warp][c] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int c = j + 1; c < R; ++c) {
      const float dot = warps_total(s_multi, c);
#pragma unroll
      for (int i = 0; i < REG_ROWS; ++i) a[i][c] = a[i][c] - dot * a[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < REG_ROWS; ++i)
    if (own[i])
#pragma unroll
      for (int k = 0; k < R; ++k) out[(tid + THREADS * i) * R + k] = a[i][k];
}

__global__ void __launch_bounds__(THREADS)
gram_schmidt_global(const float* __restrict__ p, float* __restrict__ out, long long rows, int r) {
  __shared__ float s_buf[2][WARPS];
  __shared__ float s_multi[WARPS][MAX_RANK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int round = 0;
  // element (row, k) of the working factor
#define AT(row, k) out[(row) * r + (k)]

  // coalesced copy; the barrier makes every row visible to its owner
  for (long long i = tid; i < rows * r; i += THREADS) out[i] = p[i];
  __syncthreads();

  for (int j = 0; j < r; ++j) {
    for (int k = 0; k < j; ++k) {  // reorthogonalize against basis column k
      float part = 0.0f;
      for (long long row = tid; row < rows; row += THREADS) part = part + AT(row, k) * AT(row, j);
      const float d = block_sum(part, s_buf, round);
      for (long long row = tid; row < rows; row += THREADS) AT(row, j) = AT(row, j) - d * AT(row, k);
    }
    float part = 0.0f;
    for (long long row = tid; row < rows; row += THREADS) {
      const float x = AT(row, j);
      part = part + x * x;
    }
    const float scale = 1.0f / sqrtf(fmaxf(block_sum(part, s_buf, round), EPS));
    for (long long row = tid; row < rows; row += THREADS) AT(row, j) = AT(row, j) * scale;
    if (j + 1 == r) break;
    for (int c = j + 1; c < r; ++c) {  // all later columns' dot products in one round
      float acc = 0.0f;
      for (long long row = tid; row < rows; row += THREADS) acc = acc + AT(row, j) * AT(row, c);
      acc = warp_sum(acc);
      if (lane == 0) s_multi[warp][c] = acc;
    }
    __syncthreads();
    for (int c = j + 1; c < r; ++c) {
      const float dot = warps_total(s_multi, c);
      for (long long row = tid; row < rows; row += THREADS) AT(row, c) = AT(row, c) - dot * AT(row, j);
    }
  }
#undef AT
}

template <int R>
void launch_regs(const float* p, float* out, long long rows, cudaStream_t stream) {
  gram_schmidt_regs<R><<<1, THREADS, 0, stream>>>(p, out, (int)rows);
}

}  // namespace

extern "C" {

// p, out: (rows, r) float32, row-major; rows >= 1, 1 <= r <= 64.  regs
// picks the register path, which takes r <= 8 and rows <= 1024 only.
int repro_orthogonalize(const float* p, float* out, long long rows, int r, int regs,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!regs) {
    gram_schmidt_global<<<1, THREADS, 0, s>>>(p, out, rows, r);
    return (int)cudaGetLastError();
  }
  if (rows > (long long)THREADS * REG_ROWS) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 1: launch_regs<1>(p, out, rows, s); break;
    case 2: launch_regs<2>(p, out, rows, s); break;
    case 3: launch_regs<3>(p, out, rows, s); break;
    case 4: launch_regs<4>(p, out, rows, s); break;
    case 5: launch_regs<5>(p, out, rows, s); break;
    case 6: launch_regs<6>(p, out, rows, s); break;
    case 7: launch_regs<7>(p, out, rows, s); break;
    case 8: launch_regs<8>(p, out, rows, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
