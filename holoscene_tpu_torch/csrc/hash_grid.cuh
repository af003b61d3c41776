// Device code shared by the hash-grid kernels H1-fwd (hash_fused_fwd.cu),
// H1-bwd (hash_fused_bwd.cu) and H2 (hash_sampler_fwd.cu): one level's
// metadata, the eight corner rows of a point and their smoothstep weights
// (trilinear) or the four of its tetrahedron and their barycentric weights
// (tetrahedral), the two as one interface (Stencil<kTet>), and the staging
// of H1's point tiles through shared memory.
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

// The cell of point x at level lv (its lower corner c) and the fractional
// position per dimension.
__device__ __forceinline__ void grid_cell(const Level& lv, const float x[3],
                                          int c[3], float frac[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = lv.scale * x[d];
    float cf = floorf(pos);
    if (lv.dense) cf = fminf(fmaxf(cf, 0.f), static_cast<float>(lv.res - 2));
    frac[d] = pos - cf;
    c[d] = static_cast<int>(cf);
  }
}

// The row of grid point (gx, gy, gz) at level lv. A hashed level's size is a
// power of two (ops/hashgrid.py::level_tables refuses any other), so the
// 32-bit hash wraps by a mask: the rows of its remainder without the
// division.
__device__ __forceinline__ int grid_row(const Level& lv, int gx, int gy,
                                        int gz) {
  if (lv.dense) return lv.offset + gx + lv.res * (gy + lv.res * gz);
  const uint32_t h = static_cast<uint32_t>(gx) ^
                     (static_cast<uint32_t>(gy) * 2654435761u) ^
                     (static_cast<uint32_t>(gz) * 805459861u);
  return static_cast<int>(h & static_cast<uint32_t>(lv.size - 1)) + lv.offset;
}

// The eight corner rows of point x at level lv, and its fractional
// position per dimension.
__device__ __forceinline__ void corner_rows(const Level& lv, const float x[3],
                                            int rows[8], float frac[3]) {
  int c[3];
  grid_cell(lv, x, c, frac);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rows[k] = grid_row(lv, c[0] + (k & 1), c[1] + ((k >> 1) & 1),
                       c[2] + ((k >> 2) & 1));
}

// The tetrahedral stencil (holoscene_tpu/ops/hashgrid.py _encode_core_tet):
// the cell splits into six tetrahedra by the order of the fractions, and
// the point's is walked from the cell's lower corner one dimension at a
// time, the largest fraction first. rank[d], the place of dimension d in
// that order, comes from JAX's strict comparisons (a tie puts the higher
// dimension first, as the reverse of a stable ascending sort does); vertex
// k (k = 0..3) is the lower corner plus e_d for every d with rank[d] < k.
// Weights [1 - g0, g0 - g1, g1 - g2, g2] with g_j the fraction of rank j
// (barycentric, no smoothstep). Ranks, not a permutation, so that no
// register array is indexed by a value.
// The cell is JAX's: floor(pos) on every level, a dense level's row index
// taken modulo its size (for a point in [0, 1] one subtraction: a corner
// coordinate reaches res only at x01 = 1 on a level of integer scale). The
// clamped cell of the trilinear stencil would give the same features
// there, but not the same J: the tetrahedral weights' derivative does not
// vanish at a cell's face, and JAX's, which the port keeps, reads the
// wrapped row (ROADMAP.md queue C).
__device__ __forceinline__ void tet_rows(const Level& lv, const float x[3],
                                         int rows[4], float cw[4],
                                         int rank[3]) {
  int c[3];
  float frac[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = lv.scale * x[d];
    const float cf = floorf(pos);
    frac[d] = pos - cf;
    c[d] = static_cast<int>(cf);
  }
  const int gt01 = frac[0] > frac[1], gt02 = frac[0] > frac[2],
            gt12 = frac[1] > frac[2];
  rank[0] = (1 - gt01) + (1 - gt02);
  rank[1] = gt01 + (1 - gt12);
  rank[2] = gt02 + gt12;
  float g[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    g[j] = rank[0] == j ? frac[0] : (rank[1] == j ? frac[1] : frac[2]);
  cw[0] = 1.f - g[0];
  cw[1] = g[0] - g[1];
  cw[2] = g[1] - g[2];
  cw[3] = g[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int gx = c[0] + (rank[0] < k), gy = c[1] + (rank[1] < k),
              gz = c[2] + (rank[2] < k);
    if (lv.dense) {
      int idx = gx + lv.res * (gy + lv.res * gz);
      if (idx >= lv.size) idx -= lv.size;
      rows[k] = lv.offset + idx;
    } else {
      rows[k] = grid_row(lv, gx, gy, gz);
    }
  }
}

// d cw_k / d x01 of the tetrahedral stencil (the scale chain factor
// included): piecewise constant, +scale in the dimension of rank k - 1,
// -scale in that of rank k.
__device__ __forceinline__ void tet_dweights(const int rank[3], float scale,
                                             int k, float dcw[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float up = rank[d] == k - 1 ? scale : 0.f;
    const float down = rank[d] == k ? scale : 0.f;
    dcw[d] = up - down;
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

// One (point, level)'s stencil: kCorners rows, the weight of corner k and
// (dcw given) its derivative in x01. Stencil<false> is trilinear (8
// corners, smoothstep weights w and their derivatives dw, which H1-bwd's
// sampled modes also read), Stencil<true> tetrahedral (4 corners).
template <bool kTet>
struct Stencil;

template <>
struct Stencil<false> {
  static constexpr int kCorners = 8;
  int rows[8];
  float w[3], dw[3], scale;
  __device__ __forceinline__ Stencil(const Level& lv, const float x[3])
      : scale(lv.scale) {
    float frac[3];
    corner_rows(lv, x, rows, frac);
    weights(frac, w, dw);
  }
  __device__ __forceinline__ float weight(int k, float dcw[3]) const {
    return corner_weight(w, dw, scale, k, dcw);
  }
};

template <>
struct Stencil<true> {
  static constexpr int kCorners = 4;
  int rows[4], rank[3];
  float cw[4], scale;
  __device__ __forceinline__ Stencil(const Level& lv, const float x[3])
      : scale(lv.scale) {
    tet_rows(lv, x, rows, cw, rank);
  }
  __device__ __forceinline__ float weight(int k, float dcw[3]) const {
    if (dcw != nullptr) tet_dweights(rank, scale, k, dcw);
    return cw[k];
  }
};

__device__ __forceinline__ void load_point(const float* x01, int n,
                                           float x[3]) {
  x[0] = x01[3 * n];
  x[1] = x01[3 * n + 1];
  x[2] = x01[3 * n + 2];
}

}  // namespace hash_grid
