// H1-bwd: fused first- and second-order backward of the dual-table encode,
// for sm_90a.
//
// Replaces the XLA backward of the fused custom VJP of the JAX package,
// holoscene_tpu/ops/hashgrid.py _hash_fused_bwd (fetch "packed" or "raw",
// modes exact / sampled / sampled_all), and the table transpose of the
// packed hash_encode and its jacobian in the vjp and jvp gradient modes,
// trilinear or tetrahedral; the original HoloScene wrote it by hand as
// hashencoder.cu's kernel_grid_backward + kernel_grid_second_backward.
// Plain PyTorch twin: fused_bwd_plain in holoscene_tpu_torch/ops/hashgrid.py.
// The table gradients do not depend on the table's values, so the raw
// fetch needs nothing of its own here. The stencil is a template parameter
// (interp 0 trilinear, 8 corners / 1 tetrahedral, 4 corners); the
// tetrahedral stencil runs in exact mode only, as JAX samples the backward
// only under the fused, packed, trilinear encode (fields.py:532).
//
// What it computes. For point n and level l: the corner rows and weights
// of the forward, and per corner the fused cotangent of table a,
//   ca_c,k = cw_k ct_fa[n, 2l+c] + sum_d dcw_k,d ct_J[2l+c, d, n],
// and of table b, cb_c,k = cw_k ct_fb[n, 2l+c]. They are added into
// zero-initialised [rows, 2] float32 gradients (never rounded: the bf16
// fetch is straight-through). Dense levels scatter every corner in every
// mode. On hashed levels:
//   sampled:     table b scatters ct_fb alone at ONE corner, bit d set iff
//                u_b[d, l - n_dense, n] < w_d (probability = its weight);
//   sampled_all: also table a at ONE corner: s_k = |ca_0,k| + |ca_1,k|,
//                cum its running sum, k = min(#{cum_k <= u_a S}, 7), the
//                value ca_c,k S / s_k (0 when s_k = 0).
// The uniforms come from the caller: the kernel has no RNG. Points outside
// [0, 1] add nothing. The points' own cotangent is not computed.
// ct_J == nullptr: no jacobian term, ca_c,k = cw_k ct_fa[n, 2l+c] (the
// transpose of the packed encode, JAX hashgrid.py _gather_pairs_transpose:
// the colour field's table gradient, one table, exact mode).
//
// Bounds on the card: the least traffic is the zero-fill of both tables
// (2 x 48.8 MB at the flagship width, done by the wrapper), which writes
// every gradient row once, and the inputs read once. Above it: 8 bytes of
// atomics per scattered corner and table, and their serialisation where
// points share rows. The render calls' points are ray-major (a ray's samples are
// consecutive and cluster at its surface), so at the coarse levels
// neighbouring points hit the same few rows: one thread per (point, level)
// issued up to 32 atomics of one warp onto one address, which L2 applies
// one after another. After this design the zero-fill is about half of the
// fine tier's call and the hashed levels' atomics most of an exact-mode
// call (utils/hash_bench.py's ablations).
// Design: the forward's tile (kTilePoints consecutive points x all levels,
// lane = point, warp = level), so the lanes of a warp are neighbouring
// points at one level. Each scatter is warp-aggregated: __match_any_sync
// groups the lanes by row, the lowest lane of a group sums the group's
// values (shared memory, in lane order) and issues one atomic for the row;
// where every lane's row is distinct the lanes add directly. A row's two
// channels go in one 8-byte vector atomic (atomicAdd on float2, sm_90).
// Dense levels and exact mode give tables a and b the same rows, so one
// grouping serves both. The tile's coordinates and its [P, 2L] cotangent
// rows of feats_a / feats_b are staged in shared memory by coalesced loads
// (each read once; ct_J and the uniforms are point-minor and read
// coalesced as they are). Atomics make the sums order-dependent: two
// launches agree to rounding, not bitwise.
//
// Ablation switches (utils/hash_bench.py --variant NAME=DIR:DEFINE):
// HASH_BWD_ZERO_FILL_ONLY (the kernel returns at once: the wrapper's
// zero-fill and the launch), HASH_BWD_NO_DENSE_ATOMICS /
// HASH_BWD_NO_HASHED_ATOMICS (no scatter, and so no work, at those levels),
// HASH_BWD_NO_CT_READS (cotangents made from the coordinates).

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_row(float* g, int row, float v0,
                                        float v1) {
  atomicAdd(reinterpret_cast<float2*>(g) + row, make_float2(v0, v1));
}

// Warp-aggregated scatter of (v0, v1) into g at `row` and, when gb is
// given, (v2, v3) into gb at the same row. Every lane of the warp calls it
// (warp-uniform control flow); a lane with nothing to add passes row < 0.
// `scratch` is the warp's 32 float4 of shared memory.
__device__ __forceinline__ void warp_scatter(float* g, float* gb, int row,
                                             float v0, float v1, float v2,
                                             float v3, float4* scratch) {
  const int lane = threadIdx.x;
  // a lane without a row gets one of its own, so it matches no other lane
  const int key = row >= 0 ? row : -1 - lane;
  const unsigned peers = __match_any_sync(kFull, key);
  if (!__all_sync(kFull, peers == (1u << lane))) {
    scratch[lane] = make_float4(v0, v1, v2, v3);
    __syncwarp();
    if (row >= 0 && __ffs(peers) - 1 == lane) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (unsigned m = peers; m; m &= m - 1) {
        const float4 t = scratch[__ffs(m) - 1];
        s0 += t.x;
        s1 += t.y;
        s2 += t.z;
        s3 += t.w;
      }
      add_row(g, row, s0, s1);
      if (gb != nullptr) add_row(gb, row, s2, s3);
    }
    __syncwarp();
    return;
  }
  if (row >= 0) {
    add_row(g, row, v0, v1);
    if (gb != nullptr) add_row(gb, row, v2, v3);
  }
}

template <bool kTet>
__global__ void __launch_bounds__(kTilePoints * kBwdWarps)
    hash_fused_bwd_kernel(const float* __restrict__ x01,
                          const float* __restrict__ ct_fa,
                          const float* __restrict__ ct_J,
                          const float* __restrict__ ct_fb,
                          const float* __restrict__ u_b,
                          const float* __restrict__ u_a,
                          const float* __restrict__ scales,
                          const int* __restrict__ ints, float* __restrict__ ga,
                          float* __restrict__ gb, int N, int L, int mode) {
#ifdef HASH_BWD_ZERO_FILL_ONLY
  return;
#endif
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const int tid = warp * kTilePoints + lane, nthreads = kTilePoints * W;
  const int n0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - n0);
  const int stride = 2 * L + 1;
  float4* scratch = reinterpret_cast<float4*>(smem) + warp * kTilePoints;
  float* xs = smem + 4 * kTilePoints * W;        // [kTilePoints * 3]
  float* sfa = xs + 3 * kTilePoints;             // [kTilePoints][stride]
  float* sfb = sfa + kTilePoints * stride;

  load_tile(x01 + 3 * static_cast<int64_t>(n0), xs, 3 * np, tid, nthreads);
#ifndef HASH_BWD_NO_CT_READS
  load_rows(ct_fa + static_cast<int64_t>(n0) * 2 * L, sfa, np, 2 * L, stride,
            tid, nthreads);
  if (gb != nullptr)
    load_rows(ct_fb + static_cast<int64_t>(n0) * 2 * L, sfb, np, 2 * L,
              stride, tid, nthreads);
#endif
  __syncthreads();
  const int n = n0 + lane;
  float x[3] = {0.f, 0.f, 0.f};
  if (lane < np) {
    x[0] = xs[3 * lane];
    x[1] = xs[3 * lane + 1];
    x[2] = xs[3 * lane + 2];
  }
  const bool valid = lane < np && !out_of_range(x);
  if (!valid) x[0] = x[1] = x[2] = 0.f;
  const int n_dense = ints[0];

  for (int l = warp; l < L; l += W) {
    const Level lv = load_level(scales, ints, L, l);
    const int lh = l - n_dense;
    const bool hashed = !lv.dense;
#ifdef HASH_BWD_NO_DENSE_ATOMICS
    if (!hashed) continue;
#endif
#ifdef HASH_BWD_NO_HASHED_ATOMICS
    if (hashed) continue;
#endif
    const Stencil<kTet> st(lv, x);
    constexpr int K = Stencil<kTet>::kCorners;

#ifdef HASH_BWD_NO_CT_READS
    const float cfa0 = x[0], cfa1 = x[1], cfb0 = x[2], cfb1 = x[0];
    const float cj0[3] = {x[1], x[2], x[0]}, cj1[3] = {x[2], x[0], x[1]};
#else
    const float cfa0 = sfa[lane * stride + 2 * l];
    const float cfa1 = sfa[lane * stride + 2 * l + 1];
    const float cfb0 = sfb[lane * stride + 2 * l];
    const float cfb1 = sfb[lane * stride + 2 * l + 1];
    float cj0[3] = {0.f, 0.f, 0.f}, cj1[3] = {0.f, 0.f, 0.f};
    if (lane < np && ct_J != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        cj0[d] = ct_J[(static_cast<int64_t>(2 * l) * 3 + d) * N + n];
        cj1[d] = ct_J[(static_cast<int64_t>(2 * l + 1) * 3 + d) * N + n];
      }
    }
#endif
    float ca0[K], ca1[K], cw[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float dcw[3];
      cw[k] = st.weight(k, dcw);
      ca0[k] = cw[k] * cfa0;
      ca1[k] = cw[k] * cfa1;
      if (ct_J != nullptr) {
        float s0 = dcw[0] * cj0[0] + dcw[1] * cj0[1];
        s0 = s0 + dcw[2] * cj0[2];
        float s1 = dcw[0] * cj1[0] + dcw[1] * cj1[1];
        s1 = s1 + dcw[2] * cj1[2];
        ca0[k] = ca0[k] + s0;
        ca1[k] = ca1[k] + s1;
      }
    }

    // every corner of both tables: one grouping a corner serves a and b
    const bool a_all = kTet || !(hashed && mode == 2);
    const bool b_all = gb != nullptr && (kTet || !(hashed && mode != 0));
    if (a_all) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        warp_scatter(ga, b_all ? gb : nullptr, valid ? st.rows[k] : -1,
                     ca0[k], ca1[k], cw[k] * cfb0, cw[k] * cfb1, scratch);
    } else if constexpr (!kTet) {
      // table a, sampled_all: one corner drawn ~ s_k, weighted S / s_k
      float s[8], cum[8], run = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] = fabsf(ca0[k]) + fabsf(ca1[k]);
        run += s[k];
        cum[k] = run;
      }
      const float S = cum[7];
      const float u2 =
          (valid ? u_a[static_cast<int64_t>(lh) * N + n] : 0.f) * S;
      int ks = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) ks += (u2 >= cum[k]) ? 1 : 0;
      ks = min(ks, 7);
      float sk = s[0], v0 = ca0[0], v1 = ca1[0];
      int row = st.rows[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        if (k == ks) {
          sk = s[k];
          v0 = ca0[k];
          v1 = ca1[k];
          row = st.rows[k];
        }
      }
      const float ratio = sk > 0.f ? S / fmaxf(sk, 1e-30f) : 0.f;
      warp_scatter(ga, nullptr, valid ? row : -1, v0 * ratio, v1 * ratio,
                   0.f, 0.f, scratch);
    }
    if constexpr (!kTet) {
      if (gb != nullptr && !b_all) {
        // table b on a hashed level, sampled modes: one corner, bit d set
        // iff u_b[d] < w_d
        int ks = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float u =
              valid
                  ? u_b[(static_cast<int64_t>(d) * (L - n_dense) + lh) * N + n]
                  : 1.f;
          ks |= (u < st.w[d] ? 1 : 0) << d;
        }
        int row = st.rows[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) row = (k == ks) ? st.rows[k] : row;
        warp_scatter(gb, nullptr, valid ? row : -1, cfb0, cfb1, 0.f, 0.f,
                     scratch);
      }
    }
  }
}

template <bool kTet>
int launch(const void* x01, const void* ct_fa, const void* ct_J,
           const void* ct_fb, const void* u_b, const void* u_a,
           const void* scales, const void* ints, void* ga, void* gb, int n,
           int n_levels, int mode, void* stream) {
  const int warps = tile_warps(n_levels, kBwdWarps);
  const dim3 block(kTilePoints, warps);
  const int blocks = (n + kTilePoints - 1) / kTilePoints;
  const size_t shmem = sizeof(float) * kTilePoints *
                       (4 * warps + 3 + 2 * (2 * n_levels + 1));
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  hash_fused_bwd_kernel<kTet>
      <<<blocks, block, shmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x01), static_cast<const float*>(ct_fa),
          static_cast<const float*>(ct_J), static_cast<const float*>(ct_fb),
          static_cast<const float*>(u_b), static_cast<const float*>(u_a),
          static_cast<const float*>(scales), static_cast<const int*>(ints),
          static_cast<float*>(ga), static_cast<float*>(gb), n, n_levels,
          mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 exact, 1 sampled, 2 sampled_all; interp: 0 trilinear, 1
// tetrahedral (exact mode only). Returns cudaGetLastError().
extern "C" int hash_fused_bwd(const void* x01, const void* ct_fa,
                              const void* ct_J, const void* ct_fb,
                              const void* u_b, const void* u_a,
                              const void* scales, const void* ints, void* ga,
                              void* gb, int n, int n_levels, int mode,
                              int interp, void* stream) {
  if (interp == 0)
    return launch<false>(x01, ct_fa, ct_J, ct_fb, u_b, u_a, scales, ints, ga,
                         gb, n, n_levels, mode, stream);
  if (interp == 1 && mode == 0)
    return launch<true>(x01, ct_fa, ct_J, ct_fb, u_b, u_a, scales, ints, ga,
                        gb, n, n_levels, mode, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
