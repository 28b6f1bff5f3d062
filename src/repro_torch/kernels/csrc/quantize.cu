// Per-tensor stochastic encode [-> bit-pack] and decode, uniform or codebook.
//
// Two templates, six TPU kernels of src/repro/kernels/quantize.py:
//   encode_kernel<UNIFORM=true,  PACK=false>  uniform_encode_2d        (K12)
//   encode_kernel<UNIFORM=false, PACK=false>  codebook_encode_2d       (K14)
//   encode_kernel<UNIFORM=true,  PACK=true>   uniform_encode_pack_2d   (K16)
//   encode_kernel<UNIFORM=false, PACK=true>   codebook_encode_pack_2d  (K17)
//   decode_kernel<UNIFORM=true>               uniform_decode_2d        (K13)
//   decode_kernel<UNIFORM=false>              codebook_decode_2d       (K15)
//
// Encode: for each element of the (rows, 128) tensor g with the explicit
// uniform draw rand, select.cuh's uniform_select (alpha[0], s = 2^bits - 1)
// or codebook_select (levels[0..s]) gives an int32 code in [0, s].  Without
// PACK every code is written, the padding past element n included, as the
// Pallas kernel does; with PACK codes past n are zero (quantize._mask_tail)
// and are also packed into (rows, 4*bits) wire words: word q*bits + j of a
// row holds bit j of the row's elements 32q .. 32q+31 (select.cuh's
// ballot_pack, i.e. core.quantizers.pack_codes).
//
// Decode: (rows, 128) int32 codes ->
//   uniform:  (float)code * ((2 alpha) / s) - alpha, two roundings
//             (-fmad=false) and an IEEE quotient;
//   codebook: levels[code], an exact gather; a code outside [0, s] gives 0,
//             as the Pallas kernel's one-hot product does.
//
// Bound: bytes.  Encode reads g and rand (8 B/element) and writes a 4-byte
// code, plus bits/8 B of wire with PACK; decode reads a 4-byte code and
// writes a 4-byte value.  A handful of float operations per element is far
// below the card's rate.
//
// Design.  One thread per element, 256 threads a block, so a warp is one
// 32-element wire group and each bit plane is one __ballot_sync written by
// lane 0.  The codebook (at most 256 floats) sits in shared memory; alpha
// is a one-element device operand, as the Pallas kernels read alpha_ref,
// so it never travels through the host.  The arithmetic is select.cuh's,
// shared with encode_fused.cu, so K12/K16 give K7's codes and K14/K17 K6's
// for the same inputs.
#include "select.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

template <bool UNIFORM, bool PACK>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ g, const float* __restrict__ rand,
              const float* __restrict__ meta, int s, int bits, long long n, long long total,
              int* __restrict__ codes, int* __restrict__ words) {
  __shared__ float lv[256];
  if (!UNIFORM) {
    for (int i = threadIdx.x; i <= s; i += THREADS) lv[i] = meta[i];
    __syncthreads();
  }
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;  // total is a multiple of 128: whole warps leave
  int code = UNIFORM ? (int)uniform_select(g[idx], rand[idx], meta[0], s)
                     : codebook_select(g[idx], rand[idx], lv, s).code;
  if (PACK) {
    if (idx >= n) code = 0;
    ballot_pack(code, bits, words + (idx >> 5) * bits);
  }
  codes[idx] = code;
}

template <bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const int* __restrict__ codes, const float* __restrict__ meta, int s,
              long long total, float* __restrict__ out) {
  __shared__ float lv[256];
  if (!UNIFORM) {
    for (int i = threadIdx.x; i <= s; i += THREADS) lv[i] = meta[i];
    __syncthreads();
  }
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int code = codes[idx];
  if (UNIFORM) {
    const float alpha = meta[0];
    const float step = (2.0f * alpha) / (float)s;
    out[idx] = (float)code * step - alpha;
  } else {
    out[idx] = (code >= 0 && code <= s) ? lv[code] : 0.0f;
  }
}

unsigned blocks_for(long long rows) {
  return (unsigned)((rows * LANES + THREADS - 1) / THREADS);
}

template <bool UNIFORM, bool PACK>
int encode(const float* g, const float* rand, const float* meta, int s, int bits, long long n,
           long long rows, int* codes, int* words, void* stream) {
  encode_kernel<UNIFORM, PACK><<<blocks_for(rows), THREADS, 0, (cudaStream_t)stream>>>(
      g, rand, meta, s, bits, n, rows * LANES, codes, words);
  return (int)cudaGetLastError();
}

template <bool UNIFORM>
int decode(const int* codes, const float* meta, int s, long long rows, float* out,
           void* stream) {
  decode_kernel<UNIFORM><<<blocks_for(rows), THREADS, 0, (cudaStream_t)stream>>>(
      codes, meta, s, rows * LANES, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g, rand, out: (rows, 128) float32; codes: (rows, 128) int32; words:
// (rows, 4*bits) int32; alpha: (1,) float32; levels: (s+1,) float32,
// s + 1 <= 256.

// K12
int repro_uniform_encode(const float* g, const float* rand, const float* alpha, int s,
                         long long rows, int* codes, void* stream) {
  return encode<true, false>(g, rand, alpha, s, 0, 0, rows, codes, nullptr, stream);
}

// K14
int repro_codebook_encode(const float* g, const float* rand, const float* levels, int s,
                          long long rows, int* codes, void* stream) {
  return encode<false, false>(g, rand, levels, s, 0, 0, rows, codes, nullptr, stream);
}

// K16
int repro_uniform_encode_pack_codes(const float* g, const float* rand, const float* alpha,
                                    int s, int bits, long long n, long long rows, int* codes,
                                    int* words, void* stream) {
  return encode<true, true>(g, rand, alpha, s, bits, n, rows, codes, words, stream);
}

// K17
int repro_codebook_encode_pack_codes(const float* g, const float* rand, const float* levels,
                                     int s, int bits, long long n, long long rows, int* codes,
                                     int* words, void* stream) {
  return encode<false, true>(g, rand, levels, s, bits, n, rows, codes, words, stream);
}

// K13
int repro_uniform_decode(const int* codes, const float* alpha, int s, long long rows,
                         float* out, void* stream) {
  return decode<true>(codes, alpha, s, rows, out, stream);
}

// K15
int repro_codebook_decode(const int* codes, const float* levels, int s, long long rows,
                          float* out, void* stream) {
  return decode<false>(codes, levels, s, rows, out, stream);
}

}  // extern "C"
