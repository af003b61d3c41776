// H1-bwd: fused first- and second-order backward of the dual-table encode,
// for sm_90a.
//
// Replaces the XLA backward of the fused custom VJP of the JAX package,
// holoscene_tpu/ops/hashgrid.py _hash_fused_bwd (fetch "packed", modes
// exact / sampled / sampled_all); the original HoloScene wrote it by hand as
// hashencoder.cu's kernel_grid_backward + kernel_grid_second_backward.
// Plain PyTorch twin: fused_bwd_plain in holoscene_tpu_torch/ops/hashgrid.py.
//
// What it computes. For point n and level l: the corner rows and weights
// of the forward, and per corner the fused cotangent of table a,
//   ca_c,k = cw_k ct_fa[n, 2l+c] + sum_d dcw_k,d ct_J[2l+c, d, n],
// and of table b, cb_c,k = cw_k ct_fb[n, 2l+c]. They are added with
// atomicAdd into zero-initialised [rows, 2] float32 gradients (never
// rounded: the bf16 fetch is straight-through). Dense levels scatter every
// corner in every mode. On hashed levels:
//   sampled:     table b scatters ct_fb alone at ONE corner, bit d set iff
//                u_b[d, l - n_dense, n] < w_d (probability = its weight);
//   sampled_all: also table a at ONE corner: s_k = |ca_0,k| + |ca_1,k|,
//                cum its running sum, k = min(#{cum_k <= u_a S}, 7), the
//                value ca_c,k S / s_k (0 when s_k = 0).
// The uniforms come from the caller: the kernel has no RNG. Points outside
// [0, 1] add nothing. The points' own cotangent is not computed.
//
// Bounds on the card: the zero-fill of both tables (2 x 48.8 MB at the
// flagship width) and 8 bytes of atomics per scattered corner and channel
// pair; memory, and the atomics' serialisation where points share rows.
// Atomics make the sums order-dependent: two launches agree to rounding,
// not bitwise. Design: one thread per (point, level), as the forward.

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

__device__ __forceinline__ void add2(float* g, int row, float v0, float v1) {
  atomicAdd(g + 2 * static_cast<int64_t>(row), v0);
  atomicAdd(g + 2 * static_cast<int64_t>(row) + 1, v1);
}

__global__ void __launch_bounds__(kBlock) hash_fused_bwd_kernel(
    const float* __restrict__ x01, const float* __restrict__ ct_fa,
    const float* __restrict__ ct_J, const float* __restrict__ ct_fb,
    const float* __restrict__ u_b, const float* __restrict__ u_a,
    const float* __restrict__ scales, const int* __restrict__ ints,
    float* __restrict__ ga, float* __restrict__ gb, int N, int L, int mode) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(N) * L) return;
  const int n = static_cast<int>(idx % N), l = static_cast<int>(idx / N);
  float x[3];
  load_point(x01, n, x);
  if (out_of_range(x)) return;
  const Level lv = load_level(scales, ints, L, l);
  const int n_dense = ints[0];
  const int lh = l - n_dense;
  const bool hashed = !lv.dense;
  int rows[8];
  float frac[3], w[3], dw[3];
  corner_rows(lv, x, rows, frac);
  weights(frac, w, dw);

  const int64_t f = static_cast<int64_t>(n) * 2 * L + 2 * l;
  const float cfa0 = ct_fa[f], cfa1 = ct_fa[f + 1];
  float cj0[3], cj1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cj0[d] = ct_J[(static_cast<int64_t>(2 * l) * 3 + d) * N + n];
    cj1[d] = ct_J[(static_cast<int64_t>(2 * l + 1) * 3 + d) * N + n];
  }
  float ca0[8], ca1[8], cw[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float dcw[3];
    cw[k] = corner_weight(w, dw, lv.scale, k, dcw);
    float s0 = dcw[0] * cj0[0] + dcw[1] * cj0[1];
    s0 = s0 + dcw[2] * cj0[2];
    float s1 = dcw[0] * cj1[0] + dcw[1] * cj1[1];
    s1 = s1 + dcw[2] * cj1[2];
    ca0[k] = cw[k] * cfa0 + s0;
    ca1[k] = cw[k] * cfa1 + s1;
  }

  // table a
  if (hashed && mode == 2) {
    float s[8], cum[8], run = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] = fabsf(ca0[k]) + fabsf(ca1[k]);
      run += s[k];
      cum[k] = run;
    }
    const float S = cum[7];
    const float u2 = u_a[static_cast<int64_t>(lh) * N + n] * S;
    int ks = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) ks += (u2 >= cum[k]) ? 1 : 0;
    ks = min(ks, 7);
    float sk = s[0], v0 = ca0[0], v1 = ca1[0];
    int row = rows[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      if (k == ks) {
        sk = s[k];
        v0 = ca0[k];
        v1 = ca1[k];
        row = rows[k];
      }
    }
    const float ratio = sk > 0.f ? S / fmaxf(sk, 1e-30f) : 0.f;
    add2(ga, row, v0 * ratio, v1 * ratio);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) add2(ga, rows[k], ca0[k], ca1[k]);
  }

  // table b
  if (gb == nullptr) return;
  const float cfb0 = ct_fb[f], cfb1 = ct_fb[f + 1];
  if (hashed && mode != 0) {
    int ks = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float u = u_b[(static_cast<int64_t>(d) * (L - n_dense) + lh) * N + n];
      ks |= (u < w[d] ? 1 : 0) << d;
    }
    int row = rows[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) row = (k == ks) ? rows[k] : row;
    add2(gb, row, cfb0, cfb1);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) add2(gb, rows[k], cw[k] * cfb0, cw[k] * cfb1);
  }
}

}  // namespace

// mode: 0 exact, 1 sampled, 2 sampled_all. Returns cudaGetLastError().
extern "C" int hash_fused_bwd(const void* x01, const void* ct_fa,
                              const void* ct_J, const void* ct_fb,
                              const void* u_b, const void* u_a,
                              const void* scales, const void* ints, void* ga,
                              void* gb, int n, int n_levels, int mode,
                              void* stream) {
  const int64_t total = static_cast<int64_t>(n) * n_levels;
  const int blocks = static_cast<int>((total + kBlock - 1) / kBlock);
  hash_fused_bwd_kernel<<<blocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x01), static_cast<const float*>(ct_fa),
      static_cast<const float*>(ct_J), static_cast<const float*>(ct_fb),
      static_cast<const float*>(u_b), static_cast<const float*>(u_a),
      static_cast<const float*>(scales), static_cast<const int*>(ints),
      static_cast<float*>(ga), static_cast<float*>(gb), n, n_levels, mode);
  return static_cast<int>(cudaGetLastError());
}
