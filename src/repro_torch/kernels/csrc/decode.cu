// Fused unpack -> dequant -> peer mean (or one band per peer).
//
// One template, four TPU kernels of src/repro/kernels/decode.py:
//   <UNIFORM=false, REDUCE=true>   codebook_decode_reduce_3d (K4)
//   <UNIFORM=true,  REDUCE=true>   uniform_decode_reduce_3d  (K5)
//   <UNIFORM=false, REDUCE=false>  codebook_decode_rows_3d   (K8)
//   <UNIFORM=true,  REDUCE=false>  uniform_decode_rows_3d    (K9)
//
// words: each peer's int32 wire in the pack_codes layout, peer p's at
// words + p * stride, of which the first `valid` words are read and every
// later word counts as zero: the (peers, rows, 4*bits) rows of the *_3d
// entry points (stride = valid = rows * 4 * bits), or the stacked (peers,
// packed_size(n, bits)) wire as the codec leaves it (stride the row
// stride, valid = packed_size), with no zero-padded copy.  meta: (peers,
// s+1) float32 codebooks, or (peers,) float32 alphas.  Bit j of code_p(i)
// is bit (i % 32) of word (i / 32) * bits + j of peer p, and its value
// v_p(i) is levels_p[code] or code * (2 alpha_p / s) - alpha_p
// (decode._uniform_vals: the step an IEEE quotient, then a separate
// multiply and subtract under -fmad=false).  REDUCE writes the (rows, 128)
// mean over peers; otherwise out is (peers, rows, 128), v_p in band p.
//
// Bound: bytes.  It reads bits/8 B of wire per element and peer and writes
// 4 B per element (REDUCE) or per element and peer.
//
// Design.  One warp per 128-element row, one compile-time BITS (1 to 8).
// Lane l owns the row's elements 4l .. 4l+3: they lie in word group l / 8
// at bit offset 4 (l % 8), so the group's BITS words serve all four codes.
// The row's 4*BITS words of a peer are one coalesced load (lane k loads
// word k); the peers come in batches of 8 whose loads are all issued before
// any is used, so a warp has a whole batch's wire in flight (8 x 48 B at 3
// bits).  Batch 0's loads go out before the block fills its table of
// codebooks (or alphas and steps) in shared memory and waits at the
// barrier, so the table is off the critical path.  Each lane then takes
// its group's words by __shfl_sync and turns each word's 4-bit slice into
// one bit of four byte-wide codes (a multiply spreads the slice's bits to
// the bytes), dequantizes, and adds the peers 0 .. peers-1 in order in
// float32; for REDUCE a whole batch is straight-line code, so the
// compiler overlaps one peer's shuffles and table loads with the last
// one's adds (without REDUCE, where each peer's values are stored at once,
// that made the kernel slower, and a test per peer stays).  The sum
// is divided once by the peer count (by a power of two as a multiply by
// its exact reciprocal, which rounds the same exact quotient), the order
// the Pallas grid and the plain version use, so all three agree bit for
// bit.  The four results go out as one float4 store (per peer band
// without REDUCE).
//
// serial_kernel is the body this design replaced (one thread per element,
// the peers and the bit planes walked in run-time loops, one word loaded
// at a time), kept as the yardstick the new body is timed and held against
// bit for bit on the card; no entry point of the path launches it.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // rows per block
constexpr int BATCH = 8;             // peers whose wire is in flight at once

// Peer p's values of a lane's four elements: its group's BITS words by
// shuffle from `word` (lane k holds word k of the row), each word's 4-bit
// slice at `shift` spread to bit j of four byte-wide codes, then the codes
// dequantized from the table.
template <bool UNIFORM, int BITS>
__device__ __forceinline__ void dequant(unsigned word, int p, int src, int shift, const float* lv,
                                        int peers, int s, float v[4]) {
  unsigned codes = 0;  // byte e: the code of element 4 lane + e
#pragma unroll
  for (int j = 0; j < BITS; ++j) {
    const unsigned x = __shfl_sync(FULL_MASK, word, src + j);
    codes |= ((((x >> shift) & 0xFu) * 0x00204081u) & 0x01010101u) << j;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int code = (int)((codes >> (8 * e)) & 0xFFu);
    v[e] = UNIFORM ? (float)code * lv[peers + p] - lv[p] : lv[p * (s + 1) + code];
  }
}

template <bool UNIFORM, bool REDUCE, int BITS>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const int* __restrict__ words, long long stride, long long valid,
              const float* __restrict__ meta, int peers, int s, long long rows,
              float* __restrict__ out) {
  // codebooks: peers * (s + 1) levels; uniform: peers alphas, then peers steps
  extern __shared__ float lv[];
  constexpr int WC = 4 * BITS;  // words per row and peer
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long k = row * WC + lane;  // the word this lane loads
  const bool loads = row < rows && lane < WC && k < valid;
  unsigned w[BATCH];
#pragma unroll
  for (int b = 0; b < BATCH; ++b)
    w[b] = loads && b < peers ? (unsigned)__ldg(words + b * stride + k) : 0u;
  if (UNIFORM) {
    for (int i = threadIdx.x; i < peers; i += THREADS) {
      const float alpha = meta[i];
      lv[i] = alpha;
      lv[peers + i] = (2.0f * alpha) / (float)s;
    }
  } else {
    const int table = peers * (s + 1);
    for (int i = threadIdx.x; i < table; i += THREADS) lv[i] = meta[i];
  }
  __syncthreads();
  if (row >= rows) return;  // whole warps leave
  const int src = (lane >> 3) * BITS;  // the lane holding word j of my group: src + j
  const int shift = 4 * (lane & 7);
  const long long total = rows * LANES;
  float* dst = out + row * LANES + 4 * lane;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto take = [&](int p, unsigned word) {
    float v[4];
    dequant<UNIFORM, BITS>(word, p, src, shift, lv, peers, s, v);
    if (REDUCE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = acc[e] + v[e];  // peers in order
    } else {
      *reinterpret_cast<float4*>(dst + p * total) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  for (int p0 = 0; p0 < peers; p0 += BATCH) {
    if (p0 > 0) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        w[b] = loads && p0 + b < peers ? (unsigned)__ldg(words + (p0 + b) * stride + k) : 0u;
    }
    if (REDUCE && p0 + BATCH <= peers) {  // a whole batch: straight-line code
#pragma unroll
      for (int b = 0; b < BATCH; ++b) take(p0 + b, w[b]);
    } else {
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (p0 + b < peers) take(p0 + b, w[b]);
    }
  }
  if (REDUCE) {
    // x / 2^k and x * 2^-k round the same exact value, so a power-of-two
    // count multiplies by its exact reciprocal; any other count divides
    const float np = (float)peers;
    float4 mean;
    if ((peers & (peers - 1)) == 0) {
      const float inv = 1.0f / np;
      mean = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    } else {
      mean = make_float4(acc[0] / np, acc[1] / np, acc[2] / np, acc[3] / np);
    }
    *reinterpret_cast<float4*>(dst) = mean;
  }
}

template <bool UNIFORM>
size_t table_bytes(int peers, int s) {
  return (size_t)(UNIFORM ? 2 * peers : peers * (s + 1)) * sizeof(float);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool UNIFORM, bool REDUCE, int BITS>
int launch_bits(const int* words, long long stride, long long valid, const float* meta, int peers,
                int s, long long rows, float* out, void* stream) {
  const size_t smem = table_bytes<UNIFORM>(peers, s);
  if (int err = allow_smem(decode_kernel<UNIFORM, REDUCE, BITS>, smem)) return err;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  decode_kernel<UNIFORM, REDUCE, BITS><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      words, stride, valid, meta, peers, s, rows, out);
  return (int)cudaGetLastError();
}

template <bool UNIFORM, bool REDUCE>
int launch(const int* words, long long stride, long long valid, const float* meta, int peers,
           int s, int bits, long long rows, float* out, void* stream) {
  switch (bits) {
#define REPRO_DECODE_BITS(B) \
  case B: return launch_bits<UNIFORM, REDUCE, B>(words, stride, valid, meta, peers, s, rows, out, stream);
    REPRO_DECODE_BITS(1)
    REPRO_DECODE_BITS(2)
    REPRO_DECODE_BITS(3)
    REPRO_DECODE_BITS(4)
    REPRO_DECODE_BITS(5)
    REPRO_DECODE_BITS(6)
    REPRO_DECODE_BITS(7)
    REPRO_DECODE_BITS(8)
#undef REPRO_DECODE_BITS
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool UNIFORM, bool REDUCE>
__global__ void __launch_bounds__(THREADS)
serial_kernel(const int* __restrict__ words, const float* __restrict__ meta, int peers, int s,
              int bits, long long rows, float* __restrict__ out) {
  extern __shared__ float lv[];  // peers * (s + 1) levels, or peers alphas
  const int table = UNIFORM ? peers : peers * (s + 1);
  for (int i = threadIdx.x; i < table; i += THREADS) lv[i] = meta[i];
  __syncthreads();
  const long long total = rows * LANES;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long per_peer = rows * (LANES / 32) * bits;
  const int* w = words + (idx >> 5) * bits;
  const int lane = (int)(idx & 31);
  float acc = 0.0f;
  for (int p = 0; p < peers; ++p) {
    int code = 0;
    for (int j = 0; j < bits; ++j) code |= ((w[j] >> lane) & 1) << j;
    float v;
    if (UNIFORM) {
      const float alpha = lv[p];
      const float step = (2.0f * alpha) / (float)s;
      v = (float)code * step - alpha;
    } else {
      v = lv[p * (s + 1) + code];
    }
    if (REDUCE) {
      acc = acc + v;
    } else {
      out[p * total + idx] = v;
    }
    w += per_peer;
  }
  if (REDUCE) out[idx] = acc / (float)peers;
}

template <bool UNIFORM, bool REDUCE>
int launch_serial(const int* words, const float* meta, int peers, int s, int bits,
                  long long rows, float* out, void* stream) {
  const size_t smem = (size_t)(UNIFORM ? peers : peers * (s + 1)) * sizeof(float);
  if (int err = allow_smem(serial_kernel<UNIFORM, REDUCE>, smem)) return err;
  const long long blocks = (rows * LANES + THREADS - 1) / THREADS;
  serial_kernel<UNIFORM, REDUCE><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      words, meta, peers, s, bits, rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// words: peer p's wire at words + p * stride, `valid` words of it read
// (later words are zero); 1 <= bits <= 8, s = 2^bits - 1.
// levels: (peers, s+1) float32; alphas: (peers,) float32.
// out: (rows, 128) float32 for the reductions, (peers, rows, 128) for rows.

// K4
int repro_codebook_decode_reduce(const int* words, long long stride, long long valid,
                                 const float* levels, int peers, int s, int bits, long long rows,
                                 float* out, void* stream) {
  return launch<false, true>(words, stride, valid, levels, peers, s, bits, rows, out, stream);
}

// K5
int repro_uniform_decode_reduce(const int* words, long long stride, long long valid,
                                const float* alphas, int peers, int s, int bits, long long rows,
                                float* out, void* stream) {
  return launch<true, true>(words, stride, valid, alphas, peers, s, bits, rows, out, stream);
}

// K8
int repro_codebook_decode_rows(const int* words, long long stride, long long valid,
                               const float* levels, int peers, int s, int bits, long long rows,
                               float* out, void* stream) {
  return launch<false, false>(words, stride, valid, levels, peers, s, bits, rows, out, stream);
}

// K9
int repro_uniform_decode_rows(const int* words, long long stride, long long valid,
                              const float* alphas, int peers, int s, int bits, long long rows,
                              float* out, void* stream) {
  return launch<true, false>(words, stride, valid, alphas, peers, s, bits, rows, out, stream);
}

// The replaced one-thread-per-element body on (peers, rows, 4*bits) words.
int repro_decode_serial(int uniform, int reduce, const int* words, const float* meta, int peers,
                        int s, int bits, long long rows, float* out, void* stream) {
  if (uniform) {
    return reduce ? launch_serial<true, true>(words, meta, peers, s, bits, rows, out, stream)
                  : launch_serial<true, false>(words, meta, peers, s, bits, rows, out, stream);
  }
  return reduce ? launch_serial<false, true>(words, meta, peers, s, bits, rows, out, stream)
                : launch_serial<false, false>(words, meta, peers, s, bits, rows, out, stream);
}

}  // extern "C"
