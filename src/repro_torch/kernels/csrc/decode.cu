// Fused unpack -> codebook dequant -> peer mean.
//
// Replaces src/repro/kernels/decode.py::codebook_decode_reduce_3d (K4).
// words: (peers, rows, 4*bits) int32 wire rows in the pack_codes layout;
// levels: (peers, s+1) float32 codebooks.  out[i] is the mean over peers of
// levels_p[code_p(i)], where bit j of code_p(i) is bit (i % 32) of word
// (i / 32) * bits + j of peer p.
//
// Bound: bytes.  It reads bits/8 B of wire per element and peer and writes
// 4 B per element.
//
// Design.  One thread per output element; every peer's codebook sits in
// shared memory.  The peers are added 0 .. peers-1 in order in float32 and
// the sum is divided once by the peer count (no multiplication by 1/peers),
// the order the Pallas grid and the plain version use, so all three agree
// bit for bit.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
codebook_decode_reduce_kernel(const int* __restrict__ words, const float* __restrict__ levels,
                              int peers, int s, int bits, long long rows,
                              float* __restrict__ out) {
  extern __shared__ float lv[];  // peers * (s + 1)
  const int table = peers * (s + 1);
  for (int i = threadIdx.x; i < table; i += THREADS) lv[i] = levels[i];
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
    acc = acc + lv[p * (s + 1) + code];
    w += per_peer;
  }
  out[idx] = acc / (float)peers;
}

}  // namespace

extern "C" {

// out: (rows, 128) float32.
int repro_codebook_decode_reduce(const int* words, const float* levels, int peers, int s,
                                 int bits, long long rows, float* out, void* stream) {
  const size_t smem = (size_t)peers * (s + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(codebook_decode_reduce_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows * LANES + THREADS - 1) / THREADS;
  codebook_decode_reduce_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      words, levels, peers, s, bits, rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
