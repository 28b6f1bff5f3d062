// Per-tensor stochastic encode and decode, uniform or codebook.
//
// Two templates, four TPU kernels of src/repro/kernels/quantize.py:
//   encode_kernel<UNIFORM=true>   uniform_encode_2d    (K12)
//   encode_kernel<UNIFORM=false>  codebook_encode_2d   (K14)
//   decode_kernel<UNIFORM=true>   uniform_decode_2d    (K13)
//   decode_kernel<UNIFORM=false>  codebook_decode_2d   (K15)
// The packed encodes of the same file, uniform_encode_pack_2d (K16) and
// codebook_encode_pack_2d (K17), run on encode_fused.cu's body, which
// writes their codes beside the wire words.
//
// Encode: for each element of a (rows, 128) tensor g with the explicit
// uniform draw rand, select.cuh's uniform_select (alpha[0], s = 2^bits - 1)
// or codebook_select (levels[0..s]) gives an int32 code in [0, s].  Every
// code is written, the padding past the tensor's last element included, as
// the Pallas kernel does.
//
// Decode: (rows, 128) int32 codes ->
//   uniform:  (float)code * ((2 alpha) / s) - alpha, two roundings
//             (-fmad=false) and an IEEE quotient;
//   codebook: levels[code], an exact gather; a code outside [0, s] gives 0,
//             as the Pallas kernel's one-hot product does.
//
// Bound: bytes.  Encode reads g and rand (8 B/element) and writes a 4-byte
// code; decode reads a 4-byte code and writes a 4-byte value.  A handful of
// float operations per element is far below the card's rate.  The
// per-tensor path, though, encodes each of a client's gradient leaves, most
// of them 1 to 36 rows: there one launch per leaf costs the launch and
// nothing else.
//
// Design.  One thread per element, 256 threads a block.  The encode takes
// a table of up to 64 segments, each a (rows_i, 128) g and rand with its
// own alpha or levels and s, passed by value as a __grid_constant__ kernel
// parameter (no host-to-device copy, no concatenation of the tiles):
// segment i owns a run of whole blocks, a block finds its segment by a
// binary search of the runs' ends, and its codes go to rows row0_i ..
// row0_i + rows_i of one (sum rows_i, 128) output.  So all of a client's
// leaves (K14 or K12 over 8 segments) are one launch, each segment's codes
// bitwise those of a launch on that segment alone, and the single-tensor
// launches are the one-segment case of the same template.  The codebook (at
// most 256 floats) sits in shared memory; alpha is a one-element device
// operand, as the Pallas kernels read alpha_ref, so it never travels
// through the host.  The arithmetic is select.cuh's, shared with
// encode_fused.cu, so K12 gives K7's and K16's codes and K14 K6's and
// K17's for the same inputs.
#include "select.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int MAX_SEGMENTS = 64;  // kernels/quantize.py MAX_SEGMENTS

// One (rows, 128) tile of an encode: its operands, its s and where its
// codes start in the output.
struct Segment {
  const float* g;
  const float* rand;
  const float* meta;  // alpha (1,) or levels (s+1,)
  long long row0;     // first output row of the segment's codes
  int rows;
  int s;
};

// CAP segments at most (2,824 bytes at 64, within the 4 KB of kernel
// parameters); segment i owns blocks block_end[i-1] .. block_end[i] - 1.
template <int CAP>
struct Table {
  Segment seg[CAP];
  int block_end[CAP];
  int count;
};

unsigned blocks_for(long long rows) {
  return (unsigned)((rows * LANES + THREADS - 1) / THREADS);
}

template <bool UNIFORM, int CAP>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const __grid_constant__ Table<CAP> t, int* __restrict__ codes) {
  __shared__ float lv[256];
  int i = 0;  // the first segment whose run ends past this block
  if (CAP > 1) {
    for (int hi = t.count - 1; i < hi;) {
      const int mid = (i + hi) / 2;
      if (t.block_end[mid] > (int)blockIdx.x) hi = mid; else i = mid + 1;
    }
  }
  const Segment& sg = t.seg[i];
  if (!UNIFORM) {
    for (int k = threadIdx.x; k <= sg.s; k += THREADS) lv[k] = sg.meta[k];
    __syncthreads();
  }
  const int first = i == 0 ? 0 : t.block_end[i - 1];
  const long long idx = (long long)(blockIdx.x - first) * THREADS + threadIdx.x;
  if (idx >= (long long)sg.rows * LANES) return;
  codes[sg.row0 * LANES + idx] =
      UNIFORM ? (int)uniform_select(sg.g[idx], sg.rand[idx], sg.meta[0], sg.s)
              : codebook_select(sg.g[idx], sg.rand[idx], lv, sg.s).code;
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

// Fill t from count descriptors of five int64 each (g, rand, meta
// pointers, s, rows) and launch; segment i's codes follow segment i-1's.
template <bool UNIFORM, int CAP>
int encode(const long long* desc, int count, int* codes, void* stream) {
  if (count < 1 || count > CAP) return (int)cudaErrorInvalidValue;
  Table<CAP> t{};
  long long row0 = 0, blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 5 * i;
    t.seg[i] = {reinterpret_cast<const float*>(d[0]), reinterpret_cast<const float*>(d[1]),
                reinterpret_cast<const float*>(d[2]), row0, (int)d[4], (int)d[3]};
    row0 += d[4];
    blocks += blocks_for(d[4]);
    t.block_end[i] = (int)blocks;
  }
  t.count = count;
  encode_kernel<UNIFORM, CAP><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(t, codes);
  return (int)cudaGetLastError();
}

template <bool UNIFORM>
int encode_one(const float* g, const float* rand, const float* meta, int s, long long rows,
               int* codes, void* stream) {
  const long long desc[5] = {(long long)g, (long long)rand, (long long)meta, s, rows};
  return encode<UNIFORM, 1>(desc, 1, codes, stream);
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

// g, rand, out: (rows, 128) float32; codes: (rows, 128) int32; alpha:
// (1,) float32; levels: (s+1,) float32, s + 1 <= 256.

// K12
int repro_uniform_encode(const float* g, const float* rand, const float* alpha, int s,
                         long long rows, int* codes, void* stream) {
  return encode_one<true>(g, rand, alpha, s, rows, codes, stream);
}

// K14
int repro_codebook_encode(const float* g, const float* rand, const float* levels, int s,
                          long long rows, int* codes, void* stream) {
  return encode_one<false>(g, rand, levels, s, rows, codes, stream);
}

// K14 over 1 <= count <= 64 tiles in one launch.  desc: count * 5 int64,
// per tile its g, rand and levels pointers, s and rows; codes: (sum rows,
// 128) int32, tile i's rows after those of tiles 0 .. i-1.
int repro_codebook_encode_segments(const long long* desc, int count, int* codes, void* stream) {
  return encode<false, MAX_SEGMENTS>(desc, count, codes, stream);
}

// K12 over 1 <= count <= 64 tiles in one launch: desc as above, with each
// tile's alpha (1,) pointer in place of its levels and s = 2^bits_i - 1.
int repro_uniform_encode_segments(const long long* desc, int count, int* codes, void* stream) {
  return encode<true, MAX_SEGMENTS>(desc, count, codes, stream);
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
