// The shared stochastic-select bodies of the encode kernels (encode_fused.cu
// K2, K3, K6, K7, K16, K17 and quantize.cu K12, K14): one source for the
// arithmetic of src/repro/kernels/quantize.py's uniform_select and
// codebook_select (with the codebook in shared memory or in registers), and
// for _pack_block's bit planes (ballot_pack, used by encode_fused.cu's
// serial body), so that every kernel family writes the same codes for the
// same inputs.
//
// Both bodies must be compiled with -fmad=false and IEEE division: floor(u)
// flips at integers and the rounding compares rand with a quotient, so each
// product, sum and quotient must round as the plain PyTorch version's
// separate ops do.
#pragma once

#include "common.cuh"

namespace repro {

// Truncated uniform stochastic rounding onto s intervals over [-alpha,
// alpha], in quantize.uniform_select's order:
//   scale = s / (2 alpha);  u = (clip(x, -alpha, alpha) + alpha) * scale
//   k = clip(floor u, 0, s-1);  up = r < u - k;  code = clip(k + up, 0, s)
// Returns the code as a float in [0, s].  fminf/fmaxf drop a NaN, so
// alpha = 0 (an infinite scale) gives code 0.
__device__ __forceinline__ float uniform_select(float x, float r, float alpha, int s) {
  const float scale = (float)s / (2.0f * alpha);
  const float u = (fminf(fmaxf(x, -alpha), alpha) + alpha) * scale;
  const float k = fminf(fmaxf(floorf(u), 0.0f), (float)(s - 1));
  const float up = r < u - k ? 1.0f : 0.0f;
  return fminf(fmaxf(k + up, 0.0f), (float)s);
}

struct Pick {
  int code;     // interval index k plus the round-up bit
  float value;  // levels[code]: hi on a round-up, lo otherwise
};

// Codebook stochastic rounding onto lv[0..s] (quantize.codebook_select):
//   x = clip(x, -lv[s], lv[s]);  k = #(x >= lv[1..s]) clamped to [0, s-1]
//   up = r < (x - lo) / max(hi - lo, 1e-12),  lo = lv[k], hi = lv[k+1]
// The compare-count equals a binary search for the interval, since the
// clip puts x at or above lv[0].
__device__ __forceinline__ Pick codebook_select(float x0, float r, const float* lv, int s) {
  const float alpha = lv[s];
  const float x = fminf(fmaxf(x0, -alpha), alpha);
  int k = 0;
  for (int j = 1; j <= s; ++j) k += x >= lv[j];
  k = min(max(k, 0), s - 1);
  const float lo = lv[k], hi = lv[k + 1];
  const bool up = r < (x - lo) / fmaxf(hi - lo, 1e-12f);
  return {k + (int)up, up ? hi : lo};
}

// codebook_select with the codebook lv[0..S] in registers and, on lane j
// < S of the warp, lane_lo = lv[j] and lane_d = fmaxf(lv[j+1] - lv[j],
// 1e-12f) (and lane_hi = lv[j+1] where VALUE asks for levels[code]): the
// same clip, compare-count, clamp, endpoints and quotient, so the same
// bits.  The endpoints and the divisor of interval k come from lane k by
// shuffle, since a register array indexed at run time would spill to local
// memory.  Every lane of the warp must call it.
template <int S, bool VALUE>
__device__ __forceinline__ Pick codebook_select_lanes(float x0, float r, const float (&lv)[S + 1],
                                                      float lane_lo, float lane_hi, float lane_d) {
  const float alpha = lv[S];
  const float x = fminf(fmaxf(x0, -alpha), alpha);
  int k = 0;
#pragma unroll
  for (int j = 1; j <= S; ++j) k += x >= lv[j];
  k = min(max(k, 0), S - 1);
  const float lo = __shfl_sync(FULL_MASK, lane_lo, k);
  const float d = __shfl_sync(FULL_MASK, lane_d, k);
  float hi = lo;
  if constexpr (VALUE) hi = __shfl_sync(FULL_MASK, lane_hi, k);
  // a zero numerator gives a quotient of zero (d > 0), so r < a / d is r <
  // 0; the branch keeps such lanes (x clipped onto levels[0]) out of the
  // division, whose zero check sends the whole warp down its slow path
  const float a = x - lo;
  bool up;
  if (a != 0.0f) {
    up = r < a / d;
  } else {
    up = r < 0.0f;
  }
  return {k + (int)up, up ? hi : lo};
}

// Pack the codes of one warp (32 consecutive elements, lane l holding
// element 32g + l) into `bits` wire words at group_words[0 .. bits): word j
// holds bit j of the 32 codes, lane l in bit l (quantize._pack_block, i.e.
// core.quantizers.pack_codes).  Every lane of the warp must call it.
__device__ __forceinline__ void ballot_pack(int code, int bits, int* group_words) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < bits; ++j) {
    const unsigned plane = __ballot_sync(FULL_MASK, (code >> j) & 1);
    if (lane == 0) group_words[j] = (int)plane;
  }
}

}  // namespace repro
