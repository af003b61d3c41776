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
// and of table b, cb_c,k = cw_k ct_fb[n, 2l+c]. Their sums per row are the
// [rows, 2] float32 gradients (never rounded: the bf16 fetch is
// straight-through). Dense levels scatter every corner in every mode. On
// hashed levels:
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
// Accumulation: fixed point, so that a row's sum does not depend on the
// order in which its contributions arrive (the same bits for any launch
// and any order of the points). Per (table, level) an exponent e: each
// contribution v, computed in float32 as the plain version computes it, is
// rounded once to the int64 round(v 2^e) and added with 64-bit integer
// atomics into a zero-filled int64 [rows, 2] buffer (integer addition is
// associative); a conversion pass writes float(sum) 2^-e, the correctly
// rounded float32 of the exact sum of the rounded contributions. e is
// chosen on the device, from the inputs alone, so that no row can
// overflow: a contribution of table a at level l is at most
//   B_l = max |ct_fa[:, 2l:2l+2]| + 4.5 scale_l max |ct_J[2l:2l+2]|
// (|cw| <= 1, |dcw_d| <= 1.5 scale_l; sampled_all's S-weighted value at
// most 16 B_l), of table b max |ct_fb[:, 2l:2l+2]|, and a row takes at most
// 8 N of them; with B_l < 2^x (frexp) and 8 N <= 2^c,
//   e = min(62 - c - x (- 4 for table a in sampled_all), 126),
// so a row's sum stays below 2^62 + 2^(c-1) < 2^63. A kernel reduces the
// maxima first (atomicMax on the bits of |v|, order-free) into the buffer's
// tail; the scatter and the conversion read them there, so the host never
// synchronises. Resolution: each contribution is off by at most 2^-(e+1),
// below 2^(c-61) B_l: at 2^20 points about 2^-38 of the largest
// contribution's bound, far inside the 1e-5-of-scale tolerance against
// plain and JAX. A contribution smaller than that rounds to zero (a float
// sum keeps it); Adam's sign-like first step can then differ on rows whose
// whole gradient is that small, where float sums in another order flip
// signs as well. A non-finite maximum makes its (table, level)'s rows NaN.
//
// Bounds on the card: the function's least traffic is its inputs read once
// and each gradient table (2 x 48.8 MB at the flagship width) written
// once. The accumulation adds the int64 buffer: zero-filled by the wrapper
// (16 bytes a row and table), read by the conversion, and 16 bytes of
// atomics (two 8-byte atomics: sm_90 has no 128-bit integer atomic) per
// scattered corner and table, serialised where points share rows. The
// render calls' points are ray-major (a ray's samples are consecutive and
// cluster at its surface), so at the coarse levels neighbouring points hit
// the same few rows: one thread per (point, level) issued up to 32 atomics
// of one warp onto one address, which L2 applies one after another.
// Design: the forward's tile (kTilePoints consecutive points x all levels,
// lane = point, warp = level), so the lanes of a warp are neighbouring
// points at one level. Each scatter is warp-aggregated: __match_any_sync
// groups the lanes by row, the lowest lane of a group sums the group's
// int64 values (shared memory) and issues the row's atomics; where every
// lane's row is distinct the lanes add directly. A zero channel issues no
// atomic. Dense levels and exact mode give tables a and b the same rows,
// so one grouping serves both. The tile's coordinates and its [P, 2L]
// cotangent rows of feats_a / feats_b are staged in shared memory by
// coalesced loads (each read once; ct_J and the uniforms are point-minor
// and read coalesced as they are).
//
// Ablation switches (utils/hash_bench.py --variant NAME=DIR:DEFINE):
// HASH_BWD_ZERO_FILL_ONLY (the bound and scatter kernels return at once:
// the wrapper's zero-fill, the conversion and the launches),
// HASH_BWD_NO_DENSE_ATOMICS / HASH_BWD_NO_HASHED_ATOMICS (no scatter, and
// so no work, at those levels), HASH_BWD_NO_CT_READS (cotangents made
// from the coordinates).

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 64;
constexpr int kAuxThreads = 256;

// The bits of |v|: their order as unsigned ints is the order of the values,
// and a NaN sorts above +inf.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// Per (table, level) maxima of the cotangents: maxima[l] |ct_fa|,
// maxima[L + l] |ct_J|, maxima[2 L + l] |ct_fb| of level l, as abs_bits
// (the wrapper zero-fills them). A thread a point, grid-stride; a warp
// reduces each level's values before one shared atomic.
__global__ void __launch_bounds__(kAuxThreads)
    hash_bwd_bounds_kernel(const float* __restrict__ ct_fa,
                           const float* __restrict__ ct_J,
                           const float* __restrict__ ct_fb, int N, int L,
                           unsigned* __restrict__ maxima) {
#ifdef HASH_BWD_ZERO_FILL_ONLY
  return;
#endif
  __shared__ unsigned sm[3 * kMaxLevels];
  for (int i = threadIdx.x; i < 3 * L; i += blockDim.x) sm[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < N; base += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t n = base + threadIdx.x;
    const bool in = n < N;
    for (int l = 0; l < L; ++l) {
      unsigned a = 0u, j = 0u, b = 0u;
      if (in) {
        const int64_t r = n * 2 * L + 2 * l;
        a = max(abs_bits(ct_fa[r]), abs_bits(ct_fa[r + 1]));
        if (ct_J != nullptr) {
#pragma unroll
          for (int cd = 0; cd < 6; ++cd)
            j = max(j, abs_bits(ct_J[(static_cast<int64_t>(6 * l + cd)) * N +
                                     n]));
        }
        if (ct_fb != nullptr)
          b = max(abs_bits(ct_fb[r]), abs_bits(ct_fb[r + 1]));
      }
      a = __reduce_max_sync(kFull, a);
      j = __reduce_max_sync(kFull, j);
      b = __reduce_max_sync(kFull, b);
      if (lane == 0) {
        atomicMax(&sm[l], a);
        atomicMax(&sm[L + l], j);
        atomicMax(&sm[2 * L + l], b);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * L; i += blockDim.x)
    if (sm[i]) atomicMax(&maxima[i], sm[i]);
}

// The fixed point of (table, level): a contribution v becomes
// round(v * scale) and a sum s the float s * inv (header note). bad: a
// non-finite maximum, whose rows the conversion writes as NaN.
struct Fixed {
  float scale, inv;
  bool bad;
};

__device__ __forceinline__ Fixed level_fixed(const unsigned* maxima,
                                             const float* scales, int L,
                                             int l, int table, int clog2,
                                             int mode, bool has_j) {
  float bound;
  if (table == 0) {
    bound = __uint_as_float(maxima[l]);
    if (has_j) {
      const float s45 = 4.5f * scales[l];
      bound = bound + s45 * __uint_as_float(maxima[L + l]);
    }
  } else {
    bound = __uint_as_float(maxima[2 * L + l]);
  }
  if (!isfinite(bound)) return {0.f, __int_as_float(0x7fc00000), true};
  int x;
  frexpf(bound, &x);
  int e = 62 - clog2 - x - (table == 0 && mode == 2 ? 4 : 0);
  e = min(max(e, -126), 126);
  return {ldexpf(1.f, e), ldexpf(1.f, -e), false};
}

__device__ __forceinline__ long long to_fixed(float v, float scale) {
  return __float2ll_rn(v * scale);
}

__device__ __forceinline__ void add_row(unsigned long long* g, int row,
                                        long long v0, long long v1) {
  unsigned long long* p = g + 2 * static_cast<int64_t>(row);
  if (v0) atomicAdd(p, static_cast<unsigned long long>(v0));
  if (v1) atomicAdd(p + 1, static_cast<unsigned long long>(v1));
}

// Warp-aggregated scatter of (v0, v1) into g at `row` and, when gb is
// given, (v2, v3) into gb at the same row (fixed-point values). Every lane
// of the warp calls it (warp-uniform control flow); a lane with nothing to
// add passes row < 0. `scratch` is the warp's 4 x 32 long longs of shared
// memory.
__device__ __forceinline__ void warp_scatter(unsigned long long* g,
                                             unsigned long long* gb, int row,
                                             long long v0, long long v1,
                                             long long v2, long long v3,
                                             long long* scratch) {
  const int lane = threadIdx.x;
  // a lane without a row gets one of its own, so it matches no other lane
  const int key = row >= 0 ? row : -1 - lane;
  const unsigned peers = __match_any_sync(kFull, key);
  if (!__all_sync(kFull, peers == (1u << lane))) {
    scratch[lane] = v0;
    scratch[32 + lane] = v1;
    scratch[64 + lane] = v2;
    scratch[96 + lane] = v3;
    __syncwarp();
    if (row >= 0 && __ffs(peers) - 1 == lane) {
      long long s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (unsigned m = peers; m; m &= m - 1) {
        const int p = __ffs(m) - 1;
        s0 += scratch[p];
        s1 += scratch[32 + p];
        s2 += scratch[64 + p];
        s3 += scratch[96 + p];
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
                          const int* __restrict__ ints,
                          const unsigned* __restrict__ maxima,
                          unsigned long long* __restrict__ ga,
                          unsigned long long* __restrict__ gb, int N, int L,
                          int mode, int clog2) {
#ifdef HASH_BWD_ZERO_FILL_ONLY
  return;
#endif
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const int tid = warp * kTilePoints + lane, nthreads = kTilePoints * W;
  const int n0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - n0);
  const int stride = 2 * L + 1;
  long long* scratch =
      reinterpret_cast<long long*>(smem_raw) + warp * 4 * kTilePoints;
  float* xs = reinterpret_cast<float*>(
      reinterpret_cast<long long*>(smem_raw) + 4 * kTilePoints * W);
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
    const Fixed fa =
        level_fixed(maxima, scales, L, l, 0, clog2, mode, ct_J != nullptr);
    const Fixed fb = level_fixed(maxima, scales, L, l, 1, clog2, mode, false);

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
                     to_fixed(ca0[k], fa.scale), to_fixed(ca1[k], fa.scale),
                     b_all ? to_fixed(cw[k] * cfb0, fb.scale) : 0,
                     b_all ? to_fixed(cw[k] * cfb1, fb.scale) : 0, scratch);
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
      warp_scatter(ga, nullptr, valid ? row : -1,
                   to_fixed(v0 * ratio, fa.scale),
                   to_fixed(v1 * ratio, fa.scale), 0, 0, scratch);
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
        warp_scatter(gb, nullptr, valid ? row : -1, to_fixed(cfb0, fb.scale),
                     to_fixed(cfb1, fb.scale), 0, 0, scratch);
      }
    }
  }
}

// g[table] (float32 [n_rows, 2]) from the fixed-point sums acc[table]
// (int64 [n_rows, 2]), blockIdx.y the table: a row's level is the last
// whose offset it reaches; rows past the last level have no contributions
// and are written as zeros.
__global__ void __launch_bounds__(kAuxThreads)
    hash_bwd_convert_kernel(const long long* __restrict__ acc,
                            const unsigned* __restrict__ maxima,
                            const float* __restrict__ scales,
                            const int* __restrict__ ints,
                            float* __restrict__ ga, float* __restrict__ gb,
                            int n_rows, int L, int mode, int clog2,
                            int has_j) {
  __shared__ float inv[kMaxLevels];
  __shared__ int off[kMaxLevels];
  const int table = blockIdx.y;
  if (threadIdx.x < L) {
    const int l = threadIdx.x;
    inv[l] = level_fixed(maxima, scales, L, l, table, clog2, mode,
                         has_j != 0).inv;
    off[l] = ints[1 + 2 * L + l];
  }
  __syncthreads();
  const int end = ints[1 + 2 * L + L - 1] + ints[1 + L + L - 1];
  const longlong2* src = reinterpret_cast<const longlong2*>(acc) +
                         static_cast<int64_t>(table) * n_rows;
  float2* dst = reinterpret_cast<float2*>(table == 0 ? ga : gb);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < n_rows; row += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float2 out = make_float2(0.f, 0.f);
    if (row < end) {
      int l = 0;
      for (int k = 1; k < L; ++k) l = row >= off[k] ? k : l;
      const longlong2 q = src[row];
      out = make_float2(__ll2float_rn(q.x) * inv[l],
                        __ll2float_rn(q.y) * inv[l]);
    }
    dst[row] = out;
  }
}

int aux_blocks(int64_t items) {
  const int64_t b = (items + kAuxThreads - 1) / kAuxThreads;
  return static_cast<int>(b < 1 ? 1 : (b > 2048 ? 2048 : b));
}

template <bool kTet>
int launch(const void* x01, const void* ct_fa, const void* ct_J,
           const void* ct_fb, const void* u_b, const void* u_a,
           const void* scales, const void* ints, void* acc, void* ga,
           void* gb, int n, int n_rows, int n_levels, int mode,
           void* stream) {
  if (n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = tile_warps(n_levels, kBwdWarps);
  const dim3 block(kTilePoints, warps);
  const int blocks = (n + kTilePoints - 1) / kTilePoints;
  const size_t shmem = sizeof(long long) * 4 * kTilePoints * warps +
                       sizeof(float) * kTilePoints *
                           (3 + 2 * (2 * n_levels + 1));
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // 8 n <= 2^clog2: the most contributions one row can take
  int clog2 = 0;
  while ((int64_t{1} << clog2) < int64_t{8} * n) ++clog2;
  const int tables = gb != nullptr ? 2 : 1;
  auto* acc_a = static_cast<unsigned long long*>(acc);
  auto* acc_b = gb != nullptr ? acc_a + 2 * static_cast<int64_t>(n_rows)
                              : nullptr;
  auto* maxima = reinterpret_cast<unsigned*>(
      acc_a + 2 * static_cast<int64_t>(n_rows) * tables);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hash_bwd_bounds_kernel<<<aux_blocks(n), kAuxThreads, 0, st>>>(
      static_cast<const float*>(ct_fa), static_cast<const float*>(ct_J),
      static_cast<const float*>(ct_fb), n, n_levels, maxima);
  hash_fused_bwd_kernel<kTet><<<blocks, block, shmem, st>>>(
      static_cast<const float*>(x01), static_cast<const float*>(ct_fa),
      static_cast<const float*>(ct_J), static_cast<const float*>(ct_fb),
      static_cast<const float*>(u_b), static_cast<const float*>(u_a),
      static_cast<const float*>(scales), static_cast<const int*>(ints),
      maxima, acc_a, acc_b, n, n_levels, mode, clog2);
  hash_bwd_convert_kernel<<<dim3(aux_blocks(n_rows), tables), kAuxThreads, 0,
                            st>>>(
      static_cast<const long long*>(acc), maxima,
      static_cast<const float*>(scales), static_cast<const int*>(ints),
      static_cast<float*>(ga), static_cast<float*>(gb), n_rows, n_levels,
      mode, clog2, ct_J != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 exact, 1 sampled, 2 sampled_all; interp: 0 trilinear, 1
// tetrahedral (exact mode only). acc: the zero-filled int64 work buffer,
// [tables][n_rows][2] sums then ceil(3 n_levels / 2) words of maxima;
// ga / gb: the float32 [n_rows, 2] gradients it writes (gb nullptr: one
// table). n >= 1. Returns cudaGetLastError().
extern "C" int hash_fused_bwd(const void* x01, const void* ct_fa,
                              const void* ct_J, const void* ct_fb,
                              const void* u_b, const void* u_a,
                              const void* scales, const void* ints, void* acc,
                              void* ga, void* gb, int n, int n_rows,
                              int n_levels, int mode, int interp,
                              void* stream) {
  if (interp == 0)
    return launch<false>(x01, ct_fa, ct_J, ct_fb, u_b, u_a, scales, ints,
                         acc, ga, gb, n, n_rows, n_levels, mode, stream);
  if (interp == 1 && mode == 0)
    return launch<true>(x01, ct_fa, ct_J, ct_fb, u_b, u_a, scales, ints, acc,
                        ga, gb, n, n_rows, n_levels, mode, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
