// Fused codebook encode -> bit-pack -> error-feedback residual.
//
// Replaces src/repro/kernels/encode_fused.py::codebook_encode_pack_resid_2d
// (K2).  For each element of the (rows, 128) bucket c, with the codebook
// levels[0..s] and the explicit uniform draw rand:
//   x  = clip(c, -levels[s], levels[s])
//   k  = #(x >= levels[1..s]) clamped to [0, s-1]      (compare-count)
//   up = rand < (x - lo) / max(hi - lo, 1e-12),  lo = levels[k], hi = levels[k+1]
//   code = k + up (0 past element n),  resid = c - (up ? hi : lo)
// and packs the codes into the wire: word q*bits + j of a row holds bit j of
// the row's elements 32q .. 32q+31, lane l in bit l (quantize._pack_block,
// i.e. core.quantizers.pack_codes).
//
// Bound: bytes.  It reads c and rand (8 B/element) and writes the residual
// (4 B/element) and bits/8 B of wire per element.
//
// Design.  One thread per element; the codebook (at most 256 floats) sits in
// shared memory.  A warp covers one 32-element group, so each bit plane of
// the group is one __ballot_sync, written by lane 0.  The residual reuses the
// interval endpoint the rounding chose, so it is exact.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
codebook_encode_pack_resid_kernel(const float* __restrict__ c, const float* __restrict__ rand,
                                  const float* __restrict__ levels, int s, int bits,
                                  long long n, long long total, int* __restrict__ words,
                                  float* __restrict__ resid) {
  __shared__ float lv[256];
  for (int i = threadIdx.x; i <= s; i += THREADS) lv[i] = levels[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;  // total is a multiple of 128: whole warps leave
  const float alpha = lv[s];
  const float x0 = c[idx];
  const float x = fminf(fmaxf(x0, -alpha), alpha);
  int k = 0;
  for (int j = 1; j <= s; ++j) k += x >= lv[j];
  k = min(max(k, 0), s - 1);
  const float lo = lv[k], hi = lv[k + 1];
  const float pr = (x - lo) / fmaxf(hi - lo, 1e-12f);
  const bool up = rand[idx] < pr;
  resid[idx] = x0 - (up ? hi : lo);
  const int code = idx < n ? k + (int)up : 0;
  const long long group = idx >> 5;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < bits; ++j) {
    const unsigned plane = __ballot_sync(FULL_MASK, (code >> j) & 1);
    if (lane == 0) words[group * bits + j] = (int)plane;
  }
}

}  // namespace

extern "C" {

// c, rand, resid: (rows, 128) float32; levels: (s+1,) float32, s + 1 <= 256;
// words: (rows, 4*bits) int32.
int repro_codebook_encode_pack_resid(const float* c, const float* rand, const float* levels,
                                     int s, int bits, long long n, long long rows, int* words,
                                     float* resid, void* stream) {
  const long long total = rows * LANES;
  const long long blocks = (total + THREADS - 1) / THREADS;
  codebook_encode_pack_resid_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, rand, levels, s, bits, n, total, words, resid);
  return (int)cudaGetLastError();
}

}  // extern "C"
