// Shared constants of the port's kernels: the (rows, 128) element layout of
// every bucket and the statistics tile of src/repro/kernels/stats.py.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int LANES = 128;        // elements per row of the (rows, 128) layout
constexpr int NUM_BINS = 128;     // log2-spaced |x| histogram bins
constexpr int STATS_ROWS = 8;     // rows of the statistics tile (5 used)
constexpr float LOG2_LO = -24.0f; // |x| below 2^-24 (and zeros) land in bin 0
constexpr float BIN_W = 0.25f;    // (LOG2_HI - LOG2_LO) / NUM_BINS, LOG2_HI = 8
constexpr float LN2 = 0.693147182464599609375f;  // (float)math.log(2.0)
constexpr float TINY = 1e-30f;    // ln argument floor for exact zeros
constexpr unsigned FULL_MASK = 0xffffffffu;

}  // namespace repro
