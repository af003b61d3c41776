// Device code shared by the hash-grid kernels H1-fwd (hash_fused_fwd.cu),
// H1-bwd (hash_fused_bwd.cu) and H2 (hash_sampler_fwd.cu): one level's
// metadata, the eight corner rows of a point, the smoothstep weights, and
// the staging of H1's point tiles through shared memory.
//
// Semantics (holoscene_tpu/ops/hashgrid.py _fused_core / hash_encode_sampler;
// plain twins in holoscene_tpu_torch/ops/hashgrid.py): per level
// pos = scale * x01 with scale the host's float32. Dense levels (a prefix of
// n_dense) clamp the cell to [0, res - 2] and index row-major with stride
// res; hashed levels take floor(pos) unclamped and hash (pg + corner) with
// the xor-primes in uint32 wraparound, then % size. Corner k has offset bits
// (k & 1, k >> 1 & 1, k >> 2 & 1). Every product is written in the order
// of the plain version, and the library is built with -fmad=false, so the
// weights are the plain version's bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_grid {

constexpr int kBlock = 128;

// H1's tile: kTilePoints consecutive points (one a lane) x every level, the
// levels spread over at most kFwdWarps (H1-fwd) / kBwdWarps (H1-bwd) warps.
// The counts are the faster of 2 / 4 / 8 / 16 at the fine tier and the
// background patch (utils/hash_bench.py on an H100).
constexpr int kTilePoints = 32;
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;

__host__ __device__ __forceinline__ int tile_warps(int n_levels,
                                                   int max_warps) {
  return n_levels < max_warps ? n_levels : max_warps;
}

// dst[0:count] = src[0:count], the block's threads on consecutive floats.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* dst, int count, int tid,
                                          int nthreads) {
  for (int i = tid; i < count; i += nthreads) dst[i] = src[i];
}

// Rows of `width` floats, `rows` of them: dst (contiguous) from a shared
// tile whose rows are `stride` floats apart, one float a thread in order,
// so each warp moves 128 contiguous bytes.
__device__ __forceinline__ void store_tile(const float* tile,
                                           float* __restrict__ dst, int rows,
                                           int width, int stride, int tid,
                                           int nthreads) {
  const int count = rows * width;
  for (int i = tid; i < count; i += nthreads) {
    const int r = i / width;
    dst[i] = tile[r * stride + (i - r * width)];
  }
}

// The inverse: a shared tile with row stride `stride` from contiguous rows.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* tile, int rows, int width,
                                          int stride, int tid, int nthreads) {
  const int count = rows * width;
  for (int i = tid; i < count; i += nthreads) {
    const int r = i / width;
    tile[r * stride + (i - r * width)] = src[i];
  }
}

struct Level {
  float scale;
  int res, size, offset;
  bool dense;
};

// ints: [n_dense, res[L], sizes[L], offsets[L]]
__device__ __forceinline__ Level load_level(const float* scales,
                                            const int* ints, int L, int l) {
  Level v;
  v.scale = scales[l];
  v.res = ints[1 + l];
  v.size = ints[1 + L + l];
  v.offset = ints[1 + 2 * L + l];
  v.dense = l < ints[0];
  return v;
}

__device__ __forceinline__ bool out_of_range(const float x[3]) {
  return x[0] < 0.f || x[0] > 1.f || x[1] < 0.f || x[1] > 1.f ||
         x[2] < 0.f || x[2] > 1.f;
}

__device__ __forceinline__ float smoothstep(float t) {
  return t * t * (3.f - 2.f * t);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The eight corner rows of point x at level lv, and its fractional
// position per dimension. A hashed level's size is a power of two
// (ops/hashgrid.py::level_tables refuses any other), so the 32-bit hash
// wraps by a mask: the rows of its remainder without the division.
__device__ __forceinline__ void corner_rows(const Level& lv, const float x[3],
                                            int rows[8], float frac[3]) {
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = lv.scale * x[d];
    float cf = floorf(pos);
    if (lv.dense) cf = fminf(fmaxf(cf, 0.f), static_cast<float>(lv.res - 2));
    frac[d] = pos - cf;
    c[d] = static_cast<int>(cf);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int gx = c[0] + (k & 1), gy = c[1] + ((k >> 1) & 1),
              gz = c[2] + ((k >> 2) & 1);
    if (lv.dense) {
      rows[k] = lv.offset + gx + lv.res * (gy + lv.res * gz);
    } else {
      const uint32_t h = static_cast<uint32_t>(gx) ^
                         (static_cast<uint32_t>(gy) * 2654435761u) ^
                         (static_cast<uint32_t>(gz) * 805459861u);
      rows[k] = static_cast<int>(h & static_cast<uint32_t>(lv.size - 1)) +
                lv.offset;
    }
  }
}

// Per-dimension weights of corner k: bit set -> w, else 1 - w.
__device__ __forceinline__ float corner_w(const float w[3], int k, int d) {
  return ((k >> d) & 1) ? w[d] : 1.f - w[d];
}

// Trilinear weight of corner k and, when dcw is given, its derivative in
// x01 (the scale chain factor included), as the plain version orders the
// products.
__device__ __forceinline__ float corner_weight(const float w[3],
                                               const float dw[3], float scale,
                                               int k, float dcw[3]) {
  const float w0 = corner_w(w, k, 0), w1 = corner_w(w, k, 1),
              w2 = corner_w(w, k, 2);
  if (dcw != nullptr) {
    const float s0 = (k & 1) ? dw[0] : -dw[0];
    const float s1 = ((k >> 1) & 1) ? dw[1] : -dw[1];
    const float s2 = ((k >> 2) & 1) ? dw[2] : -dw[2];
    dcw[0] = scale * s0 * w1 * w2;
    dcw[1] = scale * w0 * s1 * w2;
    dcw[2] = scale * w0 * w1 * s2;
  }
  return w0 * w1 * w2;
}

// smoothstep weights and their derivatives 6 t (1 - t) of a point's frac
__device__ __forceinline__ void weights(const float frac[3], float w[3],
                                        float dw[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    w[d] = smoothstep(frac[d]);
    dw[d] = 6.f * frac[d] * (1.f - frac[d]);
  }
}

__device__ __forceinline__ void load_point(const float* x01, int n,
                                           float x[3]) {
  x[0] = x01[3 * n];
  x[1] = x01[3 * n + 1];
  x[2] = x01[3 * n + 2];
}

}  // namespace hash_grid
