// Fused unpack -> dequant -> peer mean (or one band per peer).
//
// One template, four TPU kernels of src/repro/kernels/decode.py:
//   <UNIFORM=false, REDUCE=true>   codebook_decode_reduce_3d (K4)
//   <UNIFORM=true,  REDUCE=true>   uniform_decode_reduce_3d  (K5)
//   <UNIFORM=false, REDUCE=false>  codebook_decode_rows_3d   (K8)
//   <UNIFORM=true,  REDUCE=false>  uniform_decode_rows_3d    (K9)
//
// words: (peers, rows, 4*bits) int32 wire rows in the pack_codes layout;
// meta: (peers, s+1) float32 codebooks, or (peers,) float32 alphas.  Bit j
// of code_p(i) is bit (i % 32) of word (i / 32) * bits + j of peer p, and
// its value v_p(i) is levels_p[code] or code * (2 alpha_p / s) - alpha_p
// (decode._uniform_vals: the step an IEEE quotient, then a separate
// multiply and subtract under -fmad=false).  REDUCE writes the (rows, 128)
// mean over peers; otherwise out is (peers, rows, 128), v_p in band p.
//
// Bound: bytes.  It reads bits/8 B of wire per element and peer and writes
// 4 B per element (REDUCE) or per element and peer.
//
// Design.  One thread per output element, looping over the peers; the
// per-peer codebooks or alphas sit in shared memory.  REDUCE adds the peers
// 0 .. peers-1 in order in float32 and divides the sum once by the peer
// count (no multiplication by 1/peers), the order the Pallas grid and the
// plain version use, so all three agree bit for bit.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

template <bool UNIFORM, bool REDUCE>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const int* __restrict__ words, const float* __restrict__ meta, int peers, int s,
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
int launch(const int* words, const float* meta, int peers, int s, int bits, long long rows,
           float* out, void* stream) {
  const size_t smem = (size_t)(UNIFORM ? peers : peers * (s + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<UNIFORM, REDUCE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows * LANES + THREADS - 1) / THREADS;
  decode_kernel<UNIFORM, REDUCE><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      words, meta, peers, s, bits, rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// levels: (peers, s+1) float32; alphas: (peers,) float32.
// out: (rows, 128) float32 for the reductions, (peers, rows, 128) for rows.

// K4
int repro_codebook_decode_reduce(const int* words, const float* levels, int peers, int s,
                                 int bits, long long rows, float* out, void* stream) {
  return launch<false, true>(words, levels, peers, s, bits, rows, out, stream);
}

// K5
int repro_uniform_decode_reduce(const int* words, const float* alphas, int peers, int s,
                                int bits, long long rows, float* out, void* stream) {
  return launch<true, true>(words, alphas, peers, s, bits, rows, out, stream);
}

// K8
int repro_codebook_decode_rows(const int* words, const float* levels, int peers, int s,
                               int bits, long long rows, float* out, void* stream) {
  return launch<false, false>(words, levels, peers, s, bits, rows, out, stream);
}

// K9
int repro_uniform_decode_rows(const int* words, const float* alphas, int peers, int s,
                              int bits, long long rows, float* out, void* stream) {
  return launch<true, false>(words, alphas, peers, s, bits, rows, out, stream);
}

}  // extern "C"
