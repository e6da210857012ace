// Native weight-packing library — load-time quantization on the host.
//
// The reference's only native code is the external torch_int CUDA extension
// (SURVEY.md §2.7); its compute equivalents are kernels/*.py.
// This library is the native piece of the *runtime* around them: checkpoint
// ingestion.  Quantizing weights host-side before device transfer cuts the
// host→device traffic 4-8× (int4/int8 values + scales instead of fp32),
// which dominates cold-start time for multi-GB models.
//
// Exposed via ctypes (utils/native.py builds this with g++ -O3 -fopenmp at
// first use and caches the .so).  All layouts match kernels/pack.py:
// weights (out, in) row-major; per-(row, group) scales; int4 values in
// int8 containers, or two-per-byte nibbles in split-half order.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Permute columns of a row-major (out, in) fp32 matrix: dst[:, j] = src[:, perm[j]].
void permute_cols_f32(const float* src, const int32_t* perm,
                      int64_t out, int64_t in, float* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < out; ++r) {
    const float* s = src + r * in;
    float* d = dst + r * in;
    for (int64_t j = 0; j < in; ++j) d[j] = s[perm[j]];
  }
}

// Symmetric absmax group quantization of a row-major (out, in) fp32 matrix.
// in must be a multiple of group.  Writes q (out, in) int8 values in
// [-q_max, q_max] and scales (out, in/group) fp32.
// scale = max(absmax, 1e-5) / q_max, round-half-to-even — identical to
// quant/core.group_quant_params.
void group_quant(const float* w, int64_t out, int64_t in, int64_t group,
                 int n_bits, int8_t* q, float* scales) {
  const float q_max = (float)((1 << (n_bits - 1)) - 1);
  const int64_t n_groups = in / group;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < out; ++r) {
    const float* wr = w + r * in;
    int8_t* qr = q + r * in;
    float* sr = scales + r * n_groups;
    for (int64_t g = 0; g < n_groups; ++g) {
      const float* wg = wr + g * group;
      float absmax = 0.f;
      for (int64_t c = 0; c < group; ++c)
        absmax = std::max(absmax, std::fabs(wg[c]));
      float scale = std::max(absmax, 1e-5f) / q_max;
      sr[g] = scale;
      const float inv = 1.0f / scale;
      int8_t* qg = qr + g * group;
      for (int64_t c = 0; c < group; ++c) {
        // round half to even, matching rintf under default rounding mode
        qg[c] = (int8_t)std::lrintf(wg[c] * inv);
      }
    }
  }
}

// Split-half nibble packing: byte (r, o) of the packed (K/2, O) output holds
// channel r in the low nibble and channel r + K/2 in the high nibble of the
// TRANSPOSED (K, O) int8 input.  Unpacking the halves yields two contiguous
// channel ranges — the layout the int4 Pallas kernel expects.
// Nibbles are stored BIASED by +8 (value v in [-8,7] → v+8 in [0,15]): the
// kernel then extracts both halves with two AND/SHIFT ops per 32-bit word
// (8 weights) and corrects the bias on the accumulator with -8*sum(x) per
// group — no per-element sign-extension on the VPU.
void pack_nibbles_split(const int8_t* qt, int64_t k, int64_t o, int8_t* packed) {
  const int64_t half = k / 2;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < half; ++r) {
    const int8_t* lo = qt + r * o;
    const int8_t* hi = qt + (r + half) * o;
    int8_t* dst = packed + r * o;
    for (int64_t c = 0; c < o; ++c) {
      dst[c] = (int8_t)(((lo[c] + 8) & 0x0F) | (((hi[c] + 8) & 0x0F) << 4));
    }
  }
}

// Transpose a row-major (out, in) int8 matrix to (in, out).
void transpose_i8(const int8_t* src, int64_t out, int64_t in, int8_t* dst) {
  const int64_t TILE = 64;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t rb = 0; rb < out; rb += TILE) {
    for (int64_t cb = 0; cb < in; cb += TILE) {
      int64_t rmax = std::min(rb + TILE, out);
      int64_t cmax = std::min(cb + TILE, in);
      for (int64_t r = rb; r < rmax; ++r)
        for (int64_t c = cb; c < cmax; ++c)
          dst[c * out + r] = src[r * in + c];
    }
  }
}

// Transpose a row-major (out, in) fp32 matrix to (in, out).
void transpose_f32(const float* src, int64_t out, int64_t in, float* dst) {
  const int64_t TILE = 64;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t rb = 0; rb < out; rb += TILE) {
    for (int64_t cb = 0; cb < in; cb += TILE) {
      int64_t rmax = std::min(rb + TILE, out);
      int64_t cmax = std::min(cb + TILE, in);
      for (int64_t r = rb; r < rmax; ++r)
        for (int64_t c = cb; c < cmax; ++c)
          dst[c * out + r] = src[r * in + c];
    }
  }
}

}  // extern "C"
