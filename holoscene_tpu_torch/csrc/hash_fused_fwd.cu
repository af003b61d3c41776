// H1-fwd: dual-table hash-grid encode with the analytic jacobian of table
// a, for sm_90a.
//
// Replaces the XLA forward of the fused custom VJP of the JAX package,
// holoscene_tpu/ops/hashgrid.py _hash_fused_fwd / _fused_core (fetch
// "packed"); the original HoloScene wrote it by hand as hashencoder.cu's
// kernel_grid. Plain PyTorch twin: fused_fwd_plain in
// holoscene_tpu_torch/ops/hashgrid.py.
//
// What it computes. For point n and level l < L: the eight corner rows
// (hash_grid.cuh), both tables' two channels at each, rounded to bf16
// (round to nearest even; the packed fetch rounds every level), and
//   feats_a[n, 2l + c] = sum_k cw_k a_c(row_k),
//   J_a[2l + c, d, n]  = sum_k dcw_k,d a_c(row_k),
//   feats_b[n, 2l + c] = sum_k cw_k b_c(row_k)     (emb_b may be null:
//                                                  single-table mode),
// zeros for a point with any coordinate outside [0, 1].
//
// Bounds on the card. Per (point, level) 8 rows x 16 bytes of gathers (a
// 32-byte sector each, scattered through 49 MB tables at the fine levels)
// and 12 + 24 floats written; ~250 flops. Memory: the gathers' sectors.
// Design: one thread per (point, level), the level the slow index, so a
// warp shares a level's metadata and writes J coalesced; the feature rows
// are written 8 bytes a thread. Simple and right first: no shared-memory
// staging, no vector loads of the packed pair.

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

__global__ void __launch_bounds__(kBlock) hash_fused_fwd_kernel(
    const float* __restrict__ x01, const float2* __restrict__ emb_a,
    const float2* __restrict__ emb_b, const float* __restrict__ scales,
    const int* __restrict__ ints, float* __restrict__ fa,
    float* __restrict__ J, float* __restrict__ fb, int N, int L) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * L) return;
  const int n = static_cast<int>(idx % N), l = static_cast<int>(idx / N);
  float x[3];
  load_point(x01, n, x);
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
  float j0[3] = {0.f, 0.f, 0.f}, j1[3] = {0.f, 0.f, 0.f};
  if (!out_of_range(x)) {
    const Level lv = load_level(scales, ints, L, l);
    int rows[8];
    float frac[3], w[3], dw[3];
    corner_rows(lv, x, rows, frac);
    weights(frac, w, dw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float dcw[3];
      const float cw = corner_weight(w, dw, lv.scale, k, dcw);
      const float2 va = emb_a[rows[k]];
      const float va0 = bf16_round(va.x), va1 = bf16_round(va.y);
      a0 += cw * va0;
      a1 += cw * va1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        j0[d] += dcw[d] * va0;
        j1[d] += dcw[d] * va1;
      }
      if (emb_b != nullptr) {
        const float2 vb = emb_b[rows[k]];
        b0 += cw * bf16_round(vb.x);
        b1 += cw * bf16_round(vb.y);
      }
    }
  }
  const int64_t f = static_cast<int64_t>(n) * 2 * L + 2 * l;
  fa[f] = a0;
  fa[f + 1] = a1;
  if (fb != nullptr) {
    fb[f] = b0;
    fb[f + 1] = b1;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    J[(static_cast<int64_t>(2 * l) * 3 + d) * N + n] = j0[d];
    J[(static_cast<int64_t>(2 * l + 1) * 3 + d) * N + n] = j1[d];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int hash_fused_fwd(const void* x01, const void* emb_a,
                              const void* emb_b, const void* scales,
                              const void* ints, void* fa, void* J, void* fb,
                              int n, int n_levels, void* stream) {
  const int64_t total = static_cast<int64_t>(n) * n_levels;
  const int blocks = static_cast<int>((total + kBlock - 1) / kBlock);
  hash_fused_fwd_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x01), static_cast<const float2*>(emb_a),
      static_cast<const float2*>(emb_b), static_cast<const float*>(scales),
      static_cast<const int*>(ints), static_cast<float*>(fa),
      static_cast<float*>(J), static_cast<float*>(fb), n, n_levels);
  return static_cast<int>(cudaGetLastError());
}
