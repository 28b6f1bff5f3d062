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
// loop is a chain of about r*r/2 + 2r dependent block-wide reductions.
//
// Design.  One block, as the TPU kernel is one grid step.  The working
// columns live in the output buffer in global memory (L2-resident): at
// r = 64 and 1,024 rows they take 256 KB, more than a block's shared memory.
// Thread t owns rows t, t + 256, ...; element-wise updates touch only the
// owner's rows, so only the reductions cross threads.  Every dot product is
// reduced in a fixed order -- each thread over its rows in order, a
// shuffle-down tree in each warp, then the warps in index order, summed
// alike by every thread -- with no float atomics, so the result repeats bit
// for bit.  Step 4 reduces all r - j - 1 dot products in one round.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RANK = 64;   // CompressorConfig.rank <= 64
constexpr float EPS = 1e-30f;  // orthogonalize.EPS

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

__global__ void __launch_bounds__(THREADS)
gram_schmidt_kernel(const float* __restrict__ p, float* __restrict__ out, long long rows, int r) {
  __shared__ float s_buf[2][WARPS];
  __shared__ float s_multi[WARPS][MAX_RANK];
  __shared__ float s_dots[MAX_RANK];
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

    const int later = r - j - 1;
    if (later == 0) continue;
    for (int c = 0; c < later; ++c) {  // all later columns' dot products in one round
      float acc = 0.0f;
      for (long long row = tid; row < rows; row += THREADS)
        acc = acc + AT(row, j) * AT(row, j + 1 + c);
      acc = warp_sum(acc);
      if (lane == 0) s_multi[warp][c] = acc;
    }
    __syncthreads();
    if (tid < later) {
      float total = s_multi[0][tid];
      for (int w = 1; w < WARPS; ++w) total = total + s_multi[w][tid];
      s_dots[tid] = total;
    }
    __syncthreads();
    for (long long row = tid; row < rows; row += THREADS) {
      const float v = AT(row, j);
      for (int c = 0; c < later; ++c) AT(row, j + 1 + c) = AT(row, j + 1 + c) - s_dots[c] * v;
    }
  }
#undef AT
}

}  // namespace

extern "C" {

// p, out: (rows, r) float32, row-major; rows >= 1, 1 <= r <= 64.
int repro_orthogonalize(const float* p, float* out, long long rows, int r, void* stream) {
  gram_schmidt_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(p, out, rows, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
