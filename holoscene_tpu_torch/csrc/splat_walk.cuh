// Device code shared by the four tile-walk kernels (K1/K2 of the flat
// pipeline, K3/K4 of the top-K pipeline): the per-candidate alpha, the
// forward compositing of one staged 128-candidate chunk and its closed-form
// reverse. The kernels differ only in where a tile's chunks come from (flat
// chunk ranges vs. the tile's own [K, 16] list), where its pixels lie and
// how far it walks; the arithmetic per (pixel, candidate) is the same and
// lives here once, so that all four round every alpha identically.
//
// A candidate is a row of 16 floats:
//   x y conic_a conic_b conic_c opacity r g b depth one pad*5.
// One thread owns one pixel; a chunk is staged in shared memory and every
// thread reads the same row at the same time (a broadcast).

#pragma once

#include <cuda_runtime.h>

namespace splat_walk {

constexpr int kChunk = 128;
constexpr int kRows = 16;
constexpr int kGradRows = 10;  // x y conic(3) opacity rgb depth
constexpr float kTermEps = 1e-4f;
constexpr float kAlphaEps = 1.0f / 255.0f;

// Copy one chunk (kChunk rows, 8 KB) into shared memory with 16-byte loads.
// The caller synchronises.
__device__ __forceinline__ void stage_chunk(float* sc, const float* src,
                                            int p, int n_pix) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(sc);
  for (int i = p; i < kChunk * kRows / 4; i += n_pix) d4[i] = s4[i];
}

// Front-to-back compositing of the staged chunk at pixel (px, py), whose
// transmittance at chunk entry is `trans`. Adds to the accumulators and
// returns the chunk's sum of log(1 - alpha). Candidates below the 1/255 cut
// skip the exp/log1p work.
__device__ __forceinline__ float composite_chunk(const float* sc, float px,
                                                 float py, float trans,
                                                 float& acc_r, float& acc_g,
                                                 float& acc_b, float& acc_z) {
  float cum = 0.f;  // sum log(1 - alpha) of this chunk's earlier rows
  for (int k = 0; k < kChunk; ++k) {
    const float* c = sc + k * kRows;
    const float dx = px - c[0];
    const float dy = py - c[1];
    const float power =
        -0.5f * (c[2] * dx * dx + 2.0f * c[3] * dx * dy + c[4] * dy * dy);
    const float a = fminf(0.999f, c[5] * expf(fminf(power, 0.0f)));
    if (a < kAlphaEps) continue;
    const float w = a * expf(cum) * trans;
    acc_r += w * c[6];
    acc_g += w * c[7];
    acc_b += w * c[8];
    acc_z += w * c[9];
    cum += log1pf(-a);
  }
  return cum;
}

// Reverse walk of the staged chunk at pixel (px, py): rebuilds
//   log T_k = total - sum_{r >= k} log(1 - a_r)
// from the forward's total and the running `suffix` (never a division by
// 1 - a), carries s_after = sum_{r > k} w_r s_r, and forms
//   dL/da_k = T_k s_k - s_after / (1 - a_k),
// masked to alpha >= 1/255 and a_pre < 0.999 (the clamp), the exponent's
// gradient masked to power < 0. Each candidate's per-pixel contributions are
// reduced over the warp by shuffles, then over the block by shared-memory
// atomics into sg [kChunk][kGradRows] (zeroed by the caller). A candidate no
// pixel of the warp reaches contributes exact zeros, so the warp skips it.
__device__ __forceinline__ void backprop_chunk(const float* sc, float* sg,
                                               float px, float py,
                                               bool in_img, float total,
                                               const float (&v)[5],
                                               float& suffix, float& s_after,
                                               int lane) {
  for (int k = kChunk - 1; k >= 0; --k) {
    const float* c = sc + k * kRows;
    const float dx = px - c[0];
    const float dy = py - c[1];
    const float ca = c[2], cb = c[3], cc = c[4];
    const float power =
        -0.5f * (ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy);
    const float e = expf(fminf(power, 0.0f));
    const float a_pre = c[5] * e;
    const float a = fminf(0.999f, a_pre);
    const bool keep = a >= kAlphaEps;
    float g[kGradRows];
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) g[r] = 0.f;
    if (keep) {
      const float log1m = log1pf(-a);
      const float tr = in_img ? expf(total - suffix - log1m) : 0.0f;
      const float w = a * tr;
      const float s = v[0] * c[6] + v[1] * c[7] + v[2] * c[8] + v[3] * c[9] +
                      v[4] * c[10];
      const float da = a_pre < 0.999f ? tr * s - s_after / (1.0f - a) : 0.0f;
      const float dpow = power < 0.0f ? da * a : 0.0f;
      g[0] = dpow * (ca * dx + cb * dy);
      g[1] = dpow * (cb * dx + cc * dy);
      g[2] = dpow * (-0.5f * dx * dx);
      g[3] = dpow * (-dx * dy);
      g[4] = dpow * (-0.5f * dy * dy);
      g[5] = da * e;
      g[6] = v[0] * w;
      g[7] = v[1] * w;
      g[8] = v[2] * w;
      g[9] = v[3] * w;
      suffix += log1m;
      s_after += w * s;
    }
    if (__any_sync(0xffffffffu, keep)) {
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) {
        float x = g[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          x += __shfl_down_sync(0xffffffffu, x, off);
        }
        if (lane == 0) atomicAdd(&sg[k * kGradRows + r], x);
      }
    }
  }
}

// Write the block's reduced gradients of one chunk to its kChunk rows of
// the gradient array (columns kGradRows.. stay as allocated: zero).
__device__ __forceinline__ void store_chunk_grads(float* dst, const float* sg,
                                                  int p, int n_pix) {
  for (int i = p; i < kChunk * kGradRows; i += n_pix) {
    const int k = i / kGradRows;
    const int r = i - k * kGradRows;
    dst[k * kRows + r] = sg[i];
  }
}

}  // namespace splat_walk
