// H2: the error-bound sampler's SDF-probe encode (no gradient), for sm_90a.
//
// Replaces holoscene_tpu/ops/hashgrid.py hash_encode_sampler, which the
// JAX package left to XLA (dense levels through per-cell block-row gathers,
// hashed levels through the packed-pair gather). Plain PyTorch twin:
// sampler_fwd_plain in holoscene_tpu_torch/ops/hashgrid.py.
//
// What it computes. For point n and level l < L (the sampler's coarse
// levels): feats[n, 2l + c] = sum_k cw_k e_c(row_k), where dense levels read
// the table's exact float32 values with the cell clamped to [0, res - 2]
// and hashed levels read bf16-rounded values at the wrapped hash; zeros for
// a point outside [0, 1]. The caller zero-pads the fine levels. With
// `packed` set the dense levels read bf16-rounded values too: the packed
// encode of holoscene_tpu/models/fields.py implicit_sdf_raw (clamped cells
// where it wraps the row, which differ only on zero-weight corners), the
// encode of mesh extraction's grid evaluation.
//
// Bounds on the card. Per (point, level) 8 gathers of 8 bytes (32-byte
// sectors) and 8 bytes written, ~60 flops: memory. At the probe bake's 2.1M
// points x 8 levels the dense levels' tables (<= 4.2 MB) sit in L2.
// Design: one thread per (point, level), the level the slow index.

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

__global__ void __launch_bounds__(kBlock) hash_sampler_fwd_kernel(
    const float* __restrict__ x01, const float2* __restrict__ emb,
    const float* __restrict__ scales, const int* __restrict__ ints,
    float* __restrict__ out, int N, int L, int packed) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * L) return;
  const int n = static_cast<int>(idx % N), l = static_cast<int>(idx / N);
  float x[3];
  load_point(x01, n, x);
  float f0 = 0.f, f1 = 0.f;
  if (!out_of_range(x)) {
    const Level lv = load_level(scales, ints, L, l);
    int rows[8];
    float frac[3], w[3], dw[3];
    corner_rows(lv, x, rows, frac);
    weights(frac, w, dw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float cw = corner_weight(w, dw, lv.scale, k, nullptr);
      float2 v = emb[rows[k]];
      if (packed || !lv.dense) {
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
      }
      f0 += cw * v.x;
      f1 += cw * v.y;
    }
  }
  const int64_t f = static_cast<int64_t>(n) * 2 * L + 2 * l;
  out[f] = f0;
  out[f + 1] = f1;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int hash_sampler_fwd(const void* x01, const void* emb,
                                const void* scales, const void* ints,
                                void* out, int n, int n_levels, int packed,
                                void* stream) {
  const int64_t total = static_cast<int64_t>(n) * n_levels;
  const int blocks = static_cast<int>((total + kBlock - 1) / kBlock);
  hash_sampler_fwd_kernel<<<blocks, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x01), static_cast<const float2*>(emb),
      static_cast<const float*>(scales), static_cast<const int*>(ints),
      static_cast<float*>(out), n, n_levels, packed);
  return static_cast<int>(cudaGetLastError());
}
