// Fused encode -> bit-pack [-> error-feedback residual], codebook or uniform.
//
// One template, four TPU kernels of src/repro/kernels/encode_fused.py:
//   <UNIFORM=false, RESID=true>   codebook_encode_pack_resid_2d (K2)
//   <UNIFORM=true,  RESID=true>   uniform_encode_pack_resid_2d  (K3)
//   <UNIFORM=false, RESID=false>  codebook_encode_pack_2d       (K6)
//   <UNIFORM=true,  RESID=false>  uniform_encode_pack_2d        (K7)
//
// For each element of the (rows, 128) bucket c, with the explicit uniform
// draw rand:
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
// l in bit l (quantize._pack_block, i.e. core.quantizers.pack_codes).
//
// Bound: bytes.  It reads c and rand (8 B/element) and writes bits/8 B of
// wire per element, plus the residual (4 B/element) with RESID.
//
// Design.  One thread per element.  The codebook (at most 256 floats) sits
// in shared memory; the uniform flavours read alpha from a one-element
// device operand, as the Pallas kernel reads alpha_ref, so alpha never
// travels through the host.  A warp covers one 32-element group, so each
// bit plane of the group is one __ballot_sync, written by lane 0.  The
// codebook residual reuses the interval endpoint the rounding chose, so it
// is exact.  Built with -fmad=false and IEEE division, the uniform
// arithmetic rounds exactly as the plain PyTorch version's separate ops do:
// floor(u) flips at integers, so u must come out bit for bit.
#include "select.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

template <bool UNIFORM, bool RESID>
__global__ void __launch_bounds__(THREADS)
encode_pack_kernel(const float* __restrict__ c, const float* __restrict__ rand,
                   const float* __restrict__ meta, int s, int bits, long long n,
                   long long total, int* __restrict__ words, float* __restrict__ resid) {
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
int launch(const float* c, const float* rand, const float* meta, int s, int bits, long long n,
           long long rows, int* words, float* resid, void* stream) {
  const long long total = rows * LANES;
  const long long blocks = (total + THREADS - 1) / THREADS;
  encode_pack_kernel<UNIFORM, RESID><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, rand, meta, s, bits, n, total, words, resid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// c, rand, resid: (rows, 128) float32; levels: (s+1,) float32, s + 1 <= 256;
// alpha: (1,) float32; words: (rows, 4*bits) int32.

// K2
int repro_codebook_encode_pack_resid(const float* c, const float* rand, const float* levels,
                                     int s, int bits, long long n, long long rows, int* words,
                                     float* resid, void* stream) {
  return launch<false, true>(c, rand, levels, s, bits, n, rows, words, resid, stream);
}

// K3
int repro_uniform_encode_pack_resid(const float* c, const float* rand, const float* alpha,
                                    int s, int bits, long long n, long long rows, int* words,
                                    float* resid, void* stream) {
  return launch<true, true>(c, rand, alpha, s, bits, n, rows, words, resid, stream);
}

// K6
int repro_codebook_encode_pack(const float* c, const float* rand, const float* levels, int s,
                               int bits, long long n, long long rows, int* words, void* stream) {
  return launch<false, false>(c, rand, levels, s, bits, n, rows, words, nullptr, stream);
}

// K7
int repro_uniform_encode_pack(const float* c, const float* rand, const float* alpha, int s,
                              int bits, long long n, long long rows, int* words, void* stream) {
  return launch<true, false>(c, rand, alpha, s, bits, n, rows, words, nullptr, stream);
}

}  // extern "C"
