// H1-fwd: dual-table hash-grid encode with the analytic jacobian of table
// a, for sm_90a.
//
// Replaces the XLA forward of the fused custom VJP of the JAX package,
// holoscene_tpu/ops/hashgrid.py _hash_fused_fwd / _fused_core (fetch
// "packed" or "raw"), and the packed hash_encode / hash_encode_dual with
// their jacobian (what JAX's autodiff takes of them) in the vjp and jvp
// gradient modes, trilinear or tetrahedral (hashgrid.py:408, :453, :530);
// the original HoloScene wrote it by hand as hashencoder.cu's kernel_grid.
// Plain PyTorch twin: fused_fwd_plain in holoscene_tpu_torch/ops/hashgrid.py.
//
// What it computes. For point n and level l < L: the stencil's corner rows
// (hash_grid.cuh: 8 trilinear, 4 tetrahedral), both tables' two channels
// at each, rounded to bf16 (round to nearest even) in the packed fetch or
// read as they are in the raw fetch, and
//   feats_a[n, 2l + c] = sum_k cw_k a_c(row_k),
//   J_a[2l + c, d, n]  = sum_k dcw_k,d a_c(row_k),
//   feats_b[n, 2l + c] = sum_k cw_k b_c(row_k)     (emb_b may be null:
//                                                  single-table mode),
// zeros for a point with any coordinate outside [0, 1]. The stencil and the
// fetch are template parameters; each combination a conf reaches has its
// instantiation (interp 0 trilinear / 1 tetrahedral, fetch 0 packed / 1
// raw; tetrahedral with raw is no conf's: JAX's raw fetch is the fused
// encode's, which is trilinear only).
//
// Bounds on the card. Per (point, level) 8 rows (tetrahedral: 4) x 16
// bytes of gathers (a 32-byte sector each, scattered through 49 MB tables
// at the fine levels) and 12 + 24 floats written; ~250 flops (~130). Memory: the gathers' sectors,
// then the writes. The gathers are the largest part of its time: compiled
// out (in a copy of this file, timed by utils/hash_bench.py) they take
// about a third off the fine tier's call and half off the background
// patch's.
// Design: a block is a tile of kTilePoints consecutive points x all L
// levels; lane = point, warp = level (a warp takes levels w, w + W, ...,
// W = kFwdWarps), so a warp shares one level's metadata and its J stores
// are coalesced.
// The tile's coordinates are staged in shared memory by one coalesced load
// (each point is read once, not once per level). The [P, 2L] feature rows
// are assembled in shared memory (stride 2L + 1: conflict-free) and leave
// as one contiguous, coalesced span per table, where one thread per
// (point, level) wrote 8 bytes at a 128-byte stride. The arithmetic of
// each (point, level) is the earlier kernel's, in the same order, so the
// outputs are bitwise those of the one-thread-per-(point, level) kernel.

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

template <bool kRound>
__device__ __forceinline__ float fetch(float v) {
  return kRound ? bf16_round(v) : v;
}

template <bool kTet, bool kRound>
__global__ void __launch_bounds__(kTilePoints * kFwdWarps)
    hash_fused_fwd_kernel(const float* __restrict__ x01,
                          const float2* __restrict__ emb_a,
                          const float2* __restrict__ emb_b,
                          const float* __restrict__ scales,
                          const int* __restrict__ ints, float* __restrict__ fa,
                          float* __restrict__ J, float* __restrict__ fb, int N,
                          int L) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const int tid = warp * kTilePoints + lane, nthreads = kTilePoints * W;
  const int n0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - n0);
  const int stride = 2 * L + 1;
  float* xs = smem;                             // [kTilePoints * 3]
  float* sa = xs + 3 * kTilePoints;             // [kTilePoints][stride]
  float* sb = sa + kTilePoints * stride;

  load_tile(x01 + 3 * static_cast<int64_t>(n0), xs, 3 * np, tid, nthreads);
  __syncthreads();
  const int n = n0 + lane;
  const bool live = lane < np;
  float x[3] = {xs[3 * lane], xs[3 * lane + 1], xs[3 * lane + 2]};
  const bool valid = live && !out_of_range(x);

  for (int l = warp; l < L; l += W) {
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    float j0[3] = {0.f, 0.f, 0.f}, j1[3] = {0.f, 0.f, 0.f};
    if (valid) {
      const Stencil<kTet> st(load_level(scales, ints, L, l), x);
#pragma unroll
      for (int k = 0; k < Stencil<kTet>::kCorners; ++k) {
        float dcw[3];
        const float cw = st.weight(k, dcw);
        const float2 va = emb_a[st.rows[k]];
        const float va0 = fetch<kRound>(va.x), va1 = fetch<kRound>(va.y);
        a0 += cw * va0;
        a1 += cw * va1;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          j0[d] += dcw[d] * va0;
          j1[d] += dcw[d] * va1;
        }
        if (emb_b != nullptr) {
          const float2 vb = emb_b[st.rows[k]];
          b0 += cw * fetch<kRound>(vb.x);
          b1 += cw * fetch<kRound>(vb.y);
        }
      }
    }
    sa[lane * stride + 2 * l] = a0;
    sa[lane * stride + 2 * l + 1] = a1;
    sb[lane * stride + 2 * l] = b0;
    sb[lane * stride + 2 * l + 1] = b1;
    if (live) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        J[(static_cast<int64_t>(2 * l) * 3 + d) * N + n] = j0[d];
        J[(static_cast<int64_t>(2 * l + 1) * 3 + d) * N + n] = j1[d];
      }
    }
  }
  __syncthreads();
  store_tile(sa, fa + static_cast<int64_t>(n0) * 2 * L, np, 2 * L, stride,
             tid, nthreads);
  if (fb != nullptr)
    store_tile(sb, fb + static_cast<int64_t>(n0) * 2 * L, np, 2 * L, stride,
               tid, nthreads);
}

template <bool kTet, bool kRound>
int launch(const void* x01, const void* emb_a, const void* emb_b,
           const void* scales, const void* ints, void* fa, void* J, void* fb,
           int n, int n_levels, void* stream) {
  const dim3 block(kTilePoints, tile_warps(n_levels, kFwdWarps));
  const int blocks = (n + kTilePoints - 1) / kTilePoints;
  const size_t shmem =
      sizeof(float) * kTilePoints * (3 + 2 * (2 * n_levels + 1));
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  hash_fused_fwd_kernel<kTet, kRound>
      <<<blocks, block, shmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x01), static_cast<const float2*>(emb_a),
          static_cast<const float2*>(emb_b),
          static_cast<const float*>(scales), static_cast<const int*>(ints),
          static_cast<float*>(fa), static_cast<float*>(J),
          static_cast<float*>(fb), n, n_levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// interp: 0 trilinear, 1 tetrahedral; fetch: 0 packed (bf16 values), 1 raw.
// Returns cudaGetLastError() after the launch.
extern "C" int hash_fused_fwd(const void* x01, const void* emb_a,
                              const void* emb_b, const void* scales,
                              const void* ints, void* fa, void* J, void* fb,
                              int n, int n_levels, int interp, int fetch_raw,
                              void* stream) {
  if (interp == 0 && fetch_raw == 0)
    return launch<false, true>(x01, emb_a, emb_b, scales, ints, fa, J, fb, n,
                               n_levels, stream);
  if (interp == 0 && fetch_raw == 1)
    return launch<false, false>(x01, emb_a, emb_b, scales, ints, fa, J, fb,
                                n, n_levels, stream);
  if (interp == 1 && fetch_raw == 0)
    return launch<true, true>(x01, emb_a, emb_b, scales, ints, fa, J, fb, n,
                              n_levels, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
