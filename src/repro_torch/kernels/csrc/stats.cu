// One-pass bucket statistics, with or without the error-feedback add.
//
// Replaces two Pallas kernels:
//   EF=false  src/repro/kernels/stats.py::bucket_stats_2d         (K10)
//   EF=true   src/repro/kernels/encode_fused.py::ef_correct_stats_2d (K1),
//             which also writes the corrected bucket c = g + e.
// Output: the (8, 128) float32 tile of the first n elements of x (x = g,
// or c): row 0 counts of the 128-bin log2|x| histogram over [2^-24, 2^8),
// row 1 per-bin sums of ln|x|, row 2 max|x|, row 3 sum x, row 4 sum x^2,
// rows 5-7 zero.  The buffers are flat and read as they lie: any 4-byte
// alignment, any length.
//
// Bound: bytes.  K10 reads the bucket once (4 B/element); K1 reads g and e
// and writes c (12 B/element).  What keeps it above that bound is the
// arithmetic: one logf and two IEEE divisions per element at six blocks an
// SM, and the launch with its zeroed scratch.
//
// Design: one launch, enough blocks to fill the card, no float atomics.
// - A block of 4 warps owns 2,048 consecutive elements, so the grid (and
//   each block's range) depends on the element count alone.  Each thread
//   issues all its 16-byte loads (4 of g, 4 of e) before any arithmetic;
//   a buffer off a 16-byte boundary, or a ragged tail, is read with scalar
//   loads into the same registers, so the tile does not depend on where a
//   buffer lies.
// - Per-bin ln sums without a lane-serial loop: each pair of lanes (c,
//   c + 16) of a warp has its own column of 128 per-bin sums in shared
//   memory, laid out [warp][bin][column]; the two take turns, so a lane
//   only ever adds to its own column, in a fixed order and without bank
//   conflicts.  The block then sums the columns of each bin in a fixed
//   order.  Counts are shared-memory integer atomics, exact in any order.
//   32 KB a block: six blocks on an SM.
// - The blocks meet in exact integer sums, so their order does not
//   matter: a block's per-bin ln sum is a float32 of magnitude 0 or at
//   least 2^-25 (its terms share a sign, and each nonzero ln|x| is at
//   least that) and below 2^18, so times 2^48 it is an integer below 2^66,
//   which the block adds, as two 64-bit limbs, to device-wide words with
//   integer atomics; so do the counts, and max |x| is an atomicMax on its
//   bits (non-negative floats order as their bit patterns).  The words are
//   kept in 8 copies (block b adds to copy b % 8) against contention.  Sum
//   x and sum x^2 of each block go to scratch.  Then each block takes a
//   ticket (a release-acquire add); the block that draws the last one adds
//   the copies, adds the blocks' (sum, sum x^2) pairs in a fixed order and
//   writes the tile.  Which block finishes last depends on timing, the
//   tile does not, so two launches on one input agree bit for bit.
// The bin math mirrors stats._block_stats op for op (logf, IEEE division,
// floorf, clamp), so each element lands in the plain version's bin.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;                  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                        // floats per 16-byte load
constexpr int UNROLL = 4;                     // 16-byte loads per thread and operand
constexpr int PER_THREAD = VEC * UNROLL;      // 16 elements
constexpr int CHUNK = THREADS * PER_THREAD;   // 2,048 elements a block
constexpr int SHARE = 2;                      // lanes that take turns at one column
constexpr int COLW = 32 / SHARE;              // ln-sum columns per warp
constexpr int COLS = WARPS * NUM_BINS * COLW;  // 32 KB of floats
constexpr int COPIES = 8;                     // of the device-wide words, against contention
static_assert(THREADS == NUM_BINS, "thread t owns bin t");
static_assert(CHUNK <= 2048, "a block's ln sum stays below 2^18");

// Scratch, zeroed before the launch: the device-wide accumulators, in
// COPIES copies (block b adds to copy b % COPIES).  A bin's ln sum is
// (hi * 2^32 + lo) * 2^-48 summed over the copies, each word two's
// complement.
struct Acc {
  unsigned ticket, inf, max_bits, pad;
  unsigned count[COPIES][NUM_BINS];
  unsigned long long lo[COPIES][NUM_BINS], hi[COPIES][NUM_BINS];
};
static_assert(sizeof(Acc) % 16 == 0, "the blocks' (sum, sum of squares) pairs follow");

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(FULL_MASK, v, off));
  return v;
}

// Elements i .. i+3 of p below limit (zero past it); one 16-byte load
// where p is 16-byte aligned and all four lie below limit.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool vec, long long i,
                                        long long limit) {
  if (vec && i + VEC <= limit) return __ldg(reinterpret_cast<const float4*>(p + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < limit) v.x = p[i];
  if (i + 1 < limit) v.y = p[i + 1];
  if (i + 2 < limit) v.z = p[i + 2];
  if (i + 3 < limit) v.w = p[i + 3];
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ p, bool vec, long long i,
                                       long long limit, float4 v) {
  if (vec && i + VEC <= limit) {
    *reinterpret_cast<float4*>(p + i) = v;
    return;
  }
  if (i < limit) p[i] = v.x;
  if (i + 1 < limit) p[i + 1] = v.y;
  if (i + 2 < limit) p[i + 2] = v.z;
  if (i + 3 < limit) p[i + 3] = v.w;
}

__device__ __forceinline__ float lane_of(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Add s * 2^48 exactly to the two words of a bin.  s is a finite float32,
// 0 or of magnitude in [2^-25, 2^18): s = m * 2^(E - 150) with a 24-bit m,
// so s * 2^48 = m << (E - 102), a shift of 0 to 42.
__device__ __forceinline__ void add_fixed(unsigned long long* lo, unsigned long long* hi,
                                          float s) {
  const unsigned bits = __float_as_uint(s);
  const int sh = (int)((bits >> 23) & 0xff) - 102;
  if (s == 0.0f || sh < 0) return;
  const unsigned long long m = (bits & 0x7fffffu) | 0x800000u;
  const unsigned long long l = sh < 32 ? (m << sh) & 0xffffffffull : 0;
  const unsigned long long h = sh < 32 ? (m << sh) >> 32 : m << (sh - 32);
  const bool neg = bits >> 31;
  atomicAdd(lo, neg ? 0ull - l : l);
  atomicAdd(hi, neg ? 0ull - h : h);
}

// The ticket: a release-acquire add at device scope.  After the barrier
// that precedes it, it publishes the whole block's atomics and stores; the
// block that draws the last ticket sees every block's (and shares that
// with its threads through the next barrier).
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(t) : "memory");
  return old;
}

template <bool EF>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ g, const float* __restrict__ e, float* __restrict__ c,
             Acc* __restrict__ acc, float2* __restrict__ pairs, float* __restrict__ out,
             long long n, long long total, bool vec_g, bool vec_e, bool vec_c) {
  __shared__ float s_col[COLS];  // [WARPS][NUM_BINS][COLW]
  __shared__ unsigned s_cnt[NUM_BINS];
  __shared__ float s_red[3][WARPS];
  __shared__ int s_inf, s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long limit = EF ? total : n;
  const long long base = (long long)blockIdx.x * CHUNK + (long long)tid * VEC;

  // every load in flight before any arithmetic
  float4 x[UNROLL], y[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) x[u] = load4(g, vec_g, base + u * THREADS * VEC, limit);
  if (EF) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) y[u] = load4(e, vec_e, base + u * THREADS * VEC, limit);
  }
  // clear the columns while the loads are in flight
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < COLS / VEC; i += THREADS) reinterpret_cast<float4*>(s_col)[i] = zero;
  s_cnt[tid] = 0;
  if (tid == 0) s_inf = 0;
  if (EF) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = make_float4(x[u].x + y[u].x, x[u].y + y[u].y, x[u].z + y[u].z, x[u].w + y[u].w);
      store4(c, vec_c, base + u * THREADS * VEC, limit, x[u]);
    }
  }
  __syncthreads();

  float ln[PER_THREAD];
  int bin[PER_THREAD];
  float vmax = 0.0f, vsum = 0.0f, vsq = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const bool valid = base + (j / VEC) * THREADS * VEC + (j % VEC) < n;
    const float v = valid ? lane_of(x[j / VEC], j % VEC) : 0.0f;
    const float a = fabsf(v);
    ln[j] = logf(fmaxf(a, TINY));
    float b = floorf((ln[j] / LN2 - LOG2_LO) / BIN_W);
    b = fminf(fmaxf(b, 0.0f), (float)(NUM_BINS - 1));
    bin[j] = valid ? (int)b : -1;
    vmax = fmaxf(vmax, a);
    vsum = vsum + v;
    vsq = vsq + v * v;
  }
  // lanes c, c + COLW, ... take turns at column c
  float* col = s_col + warp * NUM_BINS * COLW + lane % COLW;  // col[bin * COLW]
  const int turn = lane / COLW;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (bin[j] >= 0) atomicAdd(&s_cnt[bin[j]], 1u);
#pragma unroll
    for (int k = 0; k < SHARE; ++k) {
      if (turn == k && bin[j] >= 0) col[bin[j] * COLW] = col[bin[j] * COLW] + ln[j];
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

  // this block's share: thread t sums bin t's 64 columns, each warp's 16
  // from column t % 16 on (at most two threads a bank), then the warps
  float part[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float* row = s_col + (w * NUM_BINS + tid) * COLW;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < COLW; ++k) sum = sum + row[(k + tid) % COLW];
    part[w] = sum;
  }
  if (s_cnt[tid]) {
    const float lsum = (part[0] + part[1]) + (part[2] + part[3]);
    const int copy = blockIdx.x % COPIES;
    atomicAdd(&acc->count[copy][tid], s_cnt[tid]);
    if (isinf(lsum)) {
      s_inf = 1;  // |x| = inf: ln|x| = inf in bin 127
    } else {
      add_fixed(&acc->lo[copy][tid], &acc->hi[copy][tid], lsum);
    }
  }
  __syncthreads();
  if (tid == 0) {
    float m = s_red[0][0], s = s_red[1][0], sq = s_red[2][0];
    for (int w = 1; w < WARPS; ++w) {
      m = fmaxf(m, s_red[0][w]);
      s = s + s_red[1][w];
      sq = sq + s_red[2][w];
    }
    atomicMax(&acc->max_bits, __float_as_uint(m));
    if (s_inf) atomicOr(&acc->inf, 1u);
    pairs[blockIdx.x] = make_float2(s, sq);
    s_last = take_ticket(&acc->ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: the pairs in a fixed order, then the tile
  float s = 0.0f, sq = 0.0f;
  for (unsigned i = tid; i < gridDim.x; i += THREADS) {
    const float2 p = __ldcg(pairs + i);
    s = s + p.x;
    sq = sq + p.y;
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  if (lane == 0) {
    s_red[1][warp] = s;
    s_red[2][warp] = sq;
  }
  __syncthreads();
  float tot = s_red[1][0], totsq = s_red[2][0];
  for (int w = 1; w < WARPS; ++w) {
    tot = tot + s_red[1][w];
    totsq = totsq + s_red[2][w];
  }
  unsigned count = 0;
  unsigned long long lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < COPIES; ++k) {
    count += __ldcg(&acc->count[k][tid]);
    lo += __ldcg(&acc->lo[k][tid]);
    hi += __ldcg(&acc->hi[k][tid]);
  }
  const double fixed = (double)(long long)hi * 0x1p32 + (double)(long long)lo;
  float lsum = (float)(fixed * 0x1p-48);
  if (tid == NUM_BINS - 1 && __ldcg(&acc->inf)) lsum = INFINITY;
  out[0 * NUM_BINS + tid] = (float)count;
  out[1 * NUM_BINS + tid] = lsum;
  out[2 * NUM_BINS + tid] = __uint_as_float(__ldcg(&acc->max_bits));
  out[3 * NUM_BINS + tid] = tot;
  out[4 * NUM_BINS + tid] = totsq;
  for (int r = 5; r < STATS_ROWS; ++r) out[r * NUM_BINS + tid] = 0.0f;
}

inline bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

inline long long blocks_for(long long elements) { return (elements + CHUNK - 1) / CHUNK; }

template <bool EF>
int launch(const float* g, const float* e, float* c, float* scratch, float* out, long long n,
           long long total, cudaStream_t stream) {
  Acc* acc = reinterpret_cast<Acc*>(scratch);
  const cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(Acc), stream);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<EF><<<(unsigned)blocks_for(EF ? total : n), THREADS, 0, stream>>>(
      g, e, c, acc, reinterpret_cast<float2*>(acc + 1), out, n, total, aligned16(g),
      aligned16(e), aligned16(c));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 words of scratch the kernels need for a buffer of `elements`
// (K10: n; K1: total).
int repro_stats_scratch_words(long long elements) {
  return (int)(sizeof(Acc) / 4 + 2 * blocks_for(elements));
}

// K10.  g: n float32; scratch: repro_stats_scratch_words(n) float32;
// out: (8, 128) float32.
int repro_bucket_stats(const float* g, float* scratch, float* out, long long n, void* stream) {
  return launch<false>(g, nullptr, nullptr, scratch, out, n, n, (cudaStream_t)stream);
}

// K1.  g, e, c: total float32 (c = g + e is written for all of them);
// the statistics are of c's first n; scratch:
// repro_stats_scratch_words(total) float32.
int repro_ef_correct_stats(const float* g, const float* e, float* c, float* scratch, float* out,
                           long long n, long long total, void* stream) {
  return launch<true>(g, e, c, scratch, out, n, total, (cudaStream_t)stream);
}

}  // extern "C"
