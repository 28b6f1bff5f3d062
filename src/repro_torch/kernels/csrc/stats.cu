// One-pass bucket statistics, with or without the error-feedback add.
//
// Replaces two Pallas kernels:
//   EF=false  src/repro/kernels/stats.py::bucket_stats_2d         (K10)
//   EF=true   src/repro/kernels/encode_fused.py::ef_correct_stats_2d (K1),
//             which also writes the corrected bucket c = g + e.
// Output: the (8, 128) float32 tile of the first n elements of x (x = g,
// or c): row 0 counts of the 128-bin log2|x| histogram over [2^-24, 2^8),
// row 1 per-bin sums of ln|x|, row 2 max|x|, row 3 sum x, row 4 sum x^2.
//
// Bound: bytes.  K10 reads the bucket once (4 B/element); K1 reads g and e
// and writes c (12 B/element).  The arithmetic (one logf per element) is far
// below the card's rate.
//
// Design.  The Pallas grid walks 64-row tiles in order and merges each
// tile's partial statistics into one accumulator.  Here one block of 256
// threads owns one 64-row tile (8192 elements; each warp a contiguous 1024)
// and writes its partial tile to scratch; a second launch merges the
// partials in tile order, exactly like the Pallas grid.  Nothing uses float
// atomics: counts use integer shared-memory atomics (exact), and each warp
// adds ln|x| into its per-bin sums lane by lane in a fixed order, so two
// launches on the same input agree bit for bit.  The bin math mirrors
// stats._block_stats op for op (logf, IEEE division, floorf, clamp).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int TILE_ROWS = 64;                 // stats.BLOCK_ROWS
constexpr int TILE_ELEMS = TILE_ROWS * LANES;  // 8192
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ELEMS = TILE_ELEMS / WARPS;  // 1024

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(FULL_MASK, v, off));
  return v;
}

template <bool EF>
__global__ void __launch_bounds__(THREADS)
stats_partial_kernel(const float* __restrict__ g, const float* __restrict__ e,
                     float* __restrict__ c, float* __restrict__ partials,
                     long long n, long long total) {
  __shared__ int s_counts[WARPS][NUM_BINS];
  __shared__ float s_lsum[WARPS][NUM_BINS];
  __shared__ float s_red[3][WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < WARPS * NUM_BINS; i += THREADS) {
    (&s_counts[0][0])[i] = 0;
    (&s_lsum[0][0])[i] = 0.0f;
  }
  __syncthreads();

  const long long base = (long long)blockIdx.x * TILE_ELEMS + (long long)warp * WARP_ELEMS;
  float vmax = 0.0f, vsum = 0.0f, vsq = 0.0f;
  for (int it = 0; it < WARP_ELEMS / 32; ++it) {
    const long long idx = base + it * 32 + lane;
    float x = 0.0f;
    if (idx < total) {
      x = g[idx];
      if (EF) {
        x = x + e[idx];
        c[idx] = x;
      }
    }
    const bool valid = idx < n;
    int bin = 0;
    float ln = 0.0f;
    if (valid) {
      const float a = fabsf(x);
      ln = logf(fmaxf(a, TINY));
      float b = floorf((ln / LN2 - LOG2_LO) / BIN_W);
      b = fminf(fmaxf(b, 0.0f), (float)(NUM_BINS - 1));
      bin = (int)b;
      atomicAdd(&s_counts[warp][bin], 1);
      vmax = fmaxf(vmax, a);
      vsum = vsum + x;
      vsq = vsq + x * x;
    }
    // per-bin ln sums, one lane at a time in lane order
    const unsigned pending = __ballot_sync(FULL_MASK, valid);
    for (int l = 0; l < 32; ++l) {
      if (((pending >> l) & 1u) && lane == l) s_lsum[warp][bin] = s_lsum[warp][bin] + ln;
      __syncwarp();
    }
  }
  vmax = warp_max(vmax);
  vsum = warp_sum(vsum);
  vsq = warp_sum(vsq);
  if (lane == 0) {
    s_red[0][warp] = vmax;
    s_red[1][warp] = vsum;
    s_red[2][warp] = vsq;
  }
  __syncthreads();

  if (tid < NUM_BINS) {
    int count = 0;
    float lsum = 0.0f, tmax = 0.0f, tsum = 0.0f, tsq = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      count += s_counts[w][tid];
      lsum = lsum + s_lsum[w][tid];
      tmax = fmaxf(tmax, s_red[0][w]);
      tsum = tsum + s_red[1][w];
      tsq = tsq + s_red[2][w];
    }
    float* out = partials + (long long)blockIdx.x * STATS_ROWS * NUM_BINS;
    out[0 * NUM_BINS + tid] = (float)count;
    out[1 * NUM_BINS + tid] = lsum;
    out[2 * NUM_BINS + tid] = tmax;
    out[3 * NUM_BINS + tid] = tsum;
    out[4 * NUM_BINS + tid] = tsq;
    for (int r = 5; r < STATS_ROWS; ++r) out[r * NUM_BINS + tid] = 0.0f;
  }
}

// Merge the per-tile partials in tile order: row 2 with max, the rest add
// (stats._merge).  One thread per tile entry.
__global__ void stats_merge_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                   int tiles) {
  const int i = threadIdx.x;  // i = row * NUM_BINS + bin
  const bool is_max = i / NUM_BINS == 2;
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    const float p = partials[(long long)t * STATS_ROWS * NUM_BINS + i];
    acc = is_max ? fmaxf(acc, p) : acc + p;
  }
  out[i] = acc;
}

template <bool EF>
int launch(const float* g, const float* e, float* c, float* partials, float* out,
           long long n, long long rows, cudaStream_t stream) {
  const int tiles = (int)((rows + TILE_ROWS - 1) / TILE_ROWS);
  stats_partial_kernel<EF><<<tiles, THREADS, 0, stream>>>(g, e, c, partials, n, rows * LANES);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_kernel<<<1, STATS_ROWS * NUM_BINS, 0, stream>>>(partials, out, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g: (rows, 128) float32; partials: (ceil(rows/64), 8, 128) scratch;
// out: (8, 128) float32.
int repro_bucket_stats(const float* g, float* partials, float* out, long long n,
                       long long rows, void* stream) {
  return launch<false>(g, nullptr, nullptr, partials, out, n, rows, (cudaStream_t)stream);
}

// As repro_bucket_stats for c = g + e, which is also written to c.
int repro_ef_correct_stats(const float* g, const float* e, float* c, float* partials,
                           float* out, long long n, long long rows, void* stream) {
  return launch<true>(g, e, c, partials, out, n, rows, (cudaStream_t)stream);
}

}  // extern "C"
