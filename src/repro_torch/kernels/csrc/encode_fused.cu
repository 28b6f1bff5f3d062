// Fused encode -> bit-pack [-> error-feedback residual | codes], codebook
// or uniform.
//
// One template, six TPU kernels, its output one of three (Out):
//   <UNIFORM=false, RESID>  encode_fused.py codebook_encode_pack_resid_2d (K2)
//   <UNIFORM=true,  RESID>  encode_fused.py uniform_encode_pack_resid_2d  (K3)
//   <UNIFORM=false, WORDS>  encode_fused.py codebook_encode_pack_2d       (K6)
//   <UNIFORM=true,  WORDS>  encode_fused.py uniform_encode_pack_2d        (K7)
//   <UNIFORM=true,  CODES>  quantize.py     uniform_encode_pack_2d        (K16)
//   <UNIFORM=false, CODES>  quantize.py     codebook_encode_pack_2d       (K17)
// (TPU files under src/repro/kernels/.)
//
// Operands: the bucket c, of which the first m elements are read and every
// later one counts as zero, with any 4-byte alignment; the explicit uniform
// draw rand on the (rows, 128) tile; the code length n (rows = ceil(n /
// 128) for a flat bucket).  The *_2d entry points pass their (rows, 128)
// tile with m = rows * 128; the flat entry passes the bucket as it lies
// with m <= n, so no zero-padded copy precedes the launch.  For each
// element i of the tile:
//   codebook (levels[0..s]; select.cuh's codebook_select):
//     x  = clip(c, -levels[s], levels[s])
//     k  = #(x >= levels[1..s]) clamped to [0, s-1]      (compare-count)
//     up = rand < (x - lo) / max(hi - lo, 1e-12),  lo = levels[k], hi = levels[k+1]
//     code = k + up,  resid = c - (up ? hi : lo)
//   uniform (alpha[0]; select.cuh's uniform_select, in this order):
//     scale = s / (2 alpha);  u = (clip(c, -alpha, alpha) + alpha) * scale
//     k  = clip(floor u, 0, s-1);  up = rand < u - k;  code = clip(k + up, 0, s)
//     resid = c - (code * (2 alpha / s) - alpha), from the code zeroed past n
// Codes past element n are zero.  The codes are packed into the wire: word
// q*bits + j of a row holds bit j of the row's elements 32q .. 32q+31, lane
// l in bit l (quantize._pack_block, i.e. core.quantizers.pack_codes).  With
// RESID the residual of elements 0 .. m-1 is written; with CODES the int32
// codes of the whole (rows, 128) tile, the zeros past n included: K14's
// (K12's) codes on the same operands, zeroed past n (quantize._mask_tail).
//
// Bound: bytes.  It reads c and rand (8 B/element) and writes bits/8 B of
// wire per element, plus the residual or the codes (4 B/element) with RESID
// or CODES.
//
// Design.  One warp per 128-element row, one compile-time BITS (1 to 8).
// Lane l takes the row's elements 4l .. 4l+3: one 16-byte load of rand
// and, where c is 16-byte aligned and the four elements lie in it, one of
// c (else four 4-byte loads: a row of a stacked (peers, n) bucket lies
// where it lies).  The loads go out before the table is built.  For BITS
// <= 4 (at most 16 levels) every thread holds the codebook in registers
// for the compare-count, and lane j holds interval j's lo, hi and divisor
// max(hi - lo, 1e-12), which the elements of interval k take by shuffle
// (select.cuh's codebook_select_lanes, bitwise codebook_select): no shared
// memory, no barrier, no select chain; an element clipped onto levels[0]
// (a zero numerator, about 1% of a bucket) skips the IEEE division, whose
// slow path it would send its warp down.  Wider codebooks sit in shared
// memory, filled after the row's loads have gone out, and are walked by
// codebook_select with s passed at run time: unrolled over 255 levels at
// every element, the 7- and 8-bit K6 faulted on the card with an illegal
// address.  With RESID the residual, with CODES the four codes, go out as
// one 16-byte store a lane before the words are packed (the codes tile is
// a fresh (rows, 128) tensor, so that store is always aligned).  Elements
// 32q .. 32q+31 lie on lanes 8q .. 8q+7, so word q*BITS + j gathers lane
// t's bit-j nibble at bit 4t: a multiply turns the four byte-wide codes'
// bit j into a nibble, three xor-shuffles OR the group's eight nibbles,
// and lane t < BITS of the group stores word j = t, so a row's words go
// out in one store instruction.  The uniform flavours read alpha from a
// one-element device operand, as the Pallas kernel reads alpha_ref, so
// alpha never travels through the host.  The codebook residual reuses the
// interval endpoint the rounding chose, so it is exact.  Built with
// -fmad=false and IEEE division, the uniform arithmetic rounds exactly as
// the plain PyTorch version's separate ops do: floor(u) flips at integers,
// so u must come out bit for bit.
//
// serial_kernel is the body this design replaced for K2, K3, K6 and K7
// (one thread per element, the codebook filled into shared memory before
// the first load, lane 0 storing each group's words one by one), kept as
// the yardstick the new body is timed and held against bit for bit on the
// card; no entry point of the path launches it.
#include "select.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;  // rows per block
constexpr int REG_BITS = 4;          // widths whose codebook sits in registers

// What an encode writes beside the words: nothing (K6, K7), the residual
// (K2, K3) or the codes (K16, K17).
enum class Out { WORDS, RESID, CODES };

// Bit j of four byte-wide codes (element e's in byte e) as a nibble,
// element e in bit e: the multiply moves byte e's bit to bit 24 + e, and
// no other product reaches bits 24..31.
__device__ __forceinline__ unsigned nibble(unsigned codes, int j) {
  return (((codes >> j) & 0x01010101u) * 0x01020408u) >> 24;
}

template <bool UNIFORM, Out OUT, int BITS>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ c, long long m, const float* __restrict__ rand,
              const float* __restrict__ meta, int s, long long n, long long rows,
              int* __restrict__ words, float* __restrict__ resid, int* __restrict__ codes) {
  constexpr bool RESID = OUT == Out::RESID;
  constexpr int S = (1 << BITS) - 1;
  constexpr int WC = 4 * BITS;  // words per row
  constexpr bool SHARED = !UNIFORM && BITS > REG_BITS;
  constexpr bool LANES_TABLE = !UNIFORM && !SHARED;
  __shared__ float lv_s[SHARED ? S + 1 : 1];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long base = row * LANES;
  // elements 4 lane + e of the row that lie in c, and that carry a code
  const int vm = (int)max(0LL, min((long long)LANES, m - base)) - 4 * lane;
  const int vn = (int)max(0LL, min((long long)LANES, n - base)) - 4 * lane;
  float x[4], u[4];
  if (row < rows) {
    const float4 rv = __ldg(reinterpret_cast<const float4*>(rand + base) + lane);
    u[0] = rv.x;
    u[1] = rv.y;
    u[2] = rv.z;
    u[3] = rv.w;
    const float* src = c + base + 4 * lane;
    if (vm >= 4 && (reinterpret_cast<size_t>(c) & 15) == 0) {
      const float4 cv = __ldg(reinterpret_cast<const float4*>(src));
      x[0] = cv.x;
      x[1] = cv.y;
      x[2] = cv.z;
      x[3] = cv.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = e < vm ? __ldg(src + e) : 0.0f;
    }
  }
  float lv_r[LANES_TABLE ? S + 1 : 1];
  float lane_lo = 0.0f, lane_hi = 0.0f, lane_d = 0.0f, alpha = 0.0f, step = 0.0f;
  if constexpr (UNIFORM) {
    alpha = __ldg(meta);
    step = (2.0f * alpha) / (float)S;
  } else if constexpr (LANES_TABLE) {
#pragma unroll
    for (int j = 0; j <= S; ++j) lv_r[j] = __ldg(meta + j);
    if (lane < S) {
      lane_lo = __ldg(meta + lane);
      lane_hi = __ldg(meta + lane + 1);
      lane_d = fmaxf(lane_hi - lane_lo, 1e-12f);
    }
  } else {
    for (int i = threadIdx.x; i <= s; i += THREADS) lv_s[i] = meta[i];
    __syncthreads();
  }
  if (row >= rows) return;  // whole warps leave
  unsigned packed = 0;  // byte e: the code of element 4 lane + e
  int k[4];
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int code;
    float value;
    if constexpr (UNIFORM) {
      code = e < vn ? (int)uniform_select(x[e], u[e], alpha, S) : 0;
      value = (float)code * step - alpha;
    } else {
      Pick pick;
      if constexpr (SHARED) {
        pick = codebook_select(x[e], u[e], lv_s, s);
      } else {
        pick = codebook_select_lanes<S, RESID>(x[e], u[e], lv_r, lane_lo, lane_hi, lane_d);
      }
      code = e < vn ? pick.code : 0;
      value = pick.value;
    }
    r[e] = x[e] - value;
    k[e] = code;
    packed |= (unsigned)code << (8 * e);
  }
  if constexpr (RESID) {
    float* dst = resid + base + 4 * lane;
    if (vm >= 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < vm) dst[e] = r[e];
    }
  }
  if constexpr (OUT == Out::CODES) {
    reinterpret_cast<int4*>(codes + base)[lane] = make_int4(k[0], k[1], k[2], k[3]);
  }
  // word (lane / 8) * BITS + j is bit j of the codes of lanes 8 (lane / 8)
  // .. + 7, lane t's nibble at bit 4t: OR the group's 8 nibbles by
  // shuffles; lane t < BITS of the group stores word j = t
  const int t = lane & 7;
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < BITS; ++j) {
    unsigned w = nibble(packed, j) << (4 * t);
    w |= __shfl_xor_sync(FULL_MASK, w, 1);
    w |= __shfl_xor_sync(FULL_MASK, w, 2);
    w |= __shfl_xor_sync(FULL_MASK, w, 4);
    if (t == j) mine = w;
  }
  if (t < BITS) words[row * WC + (lane >> 3) * BITS + t] = (int)mine;
}

template <bool UNIFORM, Out OUT, int BITS>
int launch_bits(const float* c, long long m, const float* rand, const float* meta, long long n,
                long long rows, int* words, float* resid, int* codes, void* stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  encode_kernel<UNIFORM, OUT, BITS><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, m, rand, meta, (1 << BITS) - 1, n, rows, words, resid, codes);
  return (int)cudaGetLastError();
}

template <bool UNIFORM, Out OUT>
int launch(const float* c, long long m, const float* rand, const float* meta, int bits,
           long long n, long long rows, int* words, float* resid, int* codes, void* stream) {
  switch (bits) {
#define REPRO_ENCODE_BITS(B)                                                              \
  case B:                                                                                 \
    return launch_bits<UNIFORM, OUT, B>(c, m, rand, meta, n, rows, words, resid, codes, \
                                        stream);
    REPRO_ENCODE_BITS(1)
    REPRO_ENCODE_BITS(2)
    REPRO_ENCODE_BITS(3)
    REPRO_ENCODE_BITS(4)
    REPRO_ENCODE_BITS(5)
    REPRO_ENCODE_BITS(6)
    REPRO_ENCODE_BITS(7)
    REPRO_ENCODE_BITS(8)
#undef REPRO_ENCODE_BITS
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool UNIFORM, bool RESID>
__global__ void __launch_bounds__(THREADS)
serial_kernel(const float* __restrict__ c, const float* __restrict__ rand,
              const float* __restrict__ meta, int s, int bits, long long n, long long total,
              int* __restrict__ words, float* __restrict__ resid) {
  __shared__ float lv[256];
  if (!UNIFORM) {
    for (int i = threadIdx.x; i <= s; i += THREADS) lv[i] = meta[i];
    __syncthreads();
  }
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;  // total is a multiple of 128: whole warps leave
  const float x0 = c[idx];
  int code;
  if (UNIFORM) {
    const float alpha = meta[0];
    code = idx < n ? (int)uniform_select(x0, rand[idx], alpha, s) : 0;
    if (RESID) {
      const float step = (2.0f * alpha) / (float)s;
      resid[idx] = x0 - ((float)code * step - alpha);
    }
  } else {
    const Pick pick = codebook_select(x0, rand[idx], lv, s);
    if (RESID) resid[idx] = x0 - pick.value;
    code = idx < n ? pick.code : 0;
  }
  ballot_pack(code, bits, words + (idx >> 5) * bits);
}

template <bool UNIFORM, bool RESID>
int launch_serial(const float* c, const float* rand, const float* meta, int bits, long long n,
                  long long rows, int* words, float* resid, void* stream) {
  const long long total = rows * LANES;
  const long long blocks = (total + THREADS - 1) / THREADS;
  serial_kernel<UNIFORM, RESID><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, rand, meta, (1 << bits) - 1, bits, n, total, words, resid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// c: m float32 elements, any 4-byte alignment, later elements read as 0;
// rand: (rows, 128) float32, 16-byte aligned; m, n <= rows * 128;
// 1 <= bits <= 8;
// levels: (2^bits,) float32; alpha: (1,) float32; words: (rows, 4*bits)
// int32; resid: m float32; codes: (rows, 128) int32, 16-byte aligned.

// K2
int repro_codebook_encode_pack_resid(const float* c, long long m, const float* rand,
                                     const float* levels, int bits, long long n, long long rows,
                                     int* words, float* resid, void* stream) {
  return launch<false, Out::RESID>(c, m, rand, levels, bits, n, rows, words, resid, nullptr,
                                   stream);
}

// K3
int repro_uniform_encode_pack_resid(const float* c, long long m, const float* rand,
                                    const float* alpha, int bits, long long n, long long rows,
                                    int* words, float* resid, void* stream) {
  return launch<true, Out::RESID>(c, m, rand, alpha, bits, n, rows, words, resid, nullptr,
                                  stream);
}

// K6
int repro_codebook_encode_pack(const float* c, long long m, const float* rand,
                               const float* levels, int bits, long long n, long long rows,
                               int* words, void* stream) {
  return launch<false, Out::WORDS>(c, m, rand, levels, bits, n, rows, words, nullptr, nullptr,
                                   stream);
}

// K7
int repro_uniform_encode_pack(const float* c, long long m, const float* rand, const float* alpha,
                              int bits, long long n, long long rows, int* words, void* stream) {
  return launch<true, Out::WORDS>(c, m, rand, alpha, bits, n, rows, words, nullptr, nullptr,
                                  stream);
}

// K16
int repro_uniform_encode_pack_codes(const float* c, long long m, const float* rand,
                                    const float* alpha, int bits, long long n, long long rows,
                                    int* codes, int* words, void* stream) {
  return launch<true, Out::CODES>(c, m, rand, alpha, bits, n, rows, words, nullptr, codes,
                                  stream);
}

// K17
int repro_codebook_encode_pack_codes(const float* c, long long m, const float* rand,
                                     const float* levels, int bits, long long n, long long rows,
                                     int* codes, int* words, void* stream) {
  return launch<false, Out::CODES>(c, m, rand, levels, bits, n, rows, words, nullptr, codes,
                                   stream);
}

// The replaced one-thread-per-element body on (rows, 128) c and rand;
// resid (rows, 128) with `resid`, else unused.
int repro_encode_serial(int uniform, int resid, const float* c, const float* rand,
                        const float* meta, int bits, long long n, long long rows, int* words,
                        float* out, void* stream) {
  if (uniform) {
    return resid ? launch_serial<true, true>(c, rand, meta, bits, n, rows, words, out, stream)
                 : launch_serial<true, false>(c, rand, meta, bits, n, rows, words, out, stream);
  }
  return resid ? launch_serial<false, true>(c, rand, meta, bits, n, rows, words, out, stream)
               : launch_serial<false, false>(c, rand, meta, bits, n, rows, words, out, stream);
}

}  // extern "C"
