// H2: the hash-grid encode without gradient, for sm_90a: the error-bound
// sampler's SDF probes and the probe bake, and (packed) mesh extraction's
// grid evaluation.
//
// Replaces holoscene_tpu/ops/hashgrid.py hash_encode_sampler, which the
// JAX package left to XLA (dense levels through per-cell block-row gathers,
// hashed levels through the packed-pair gather), and in its packed mode the
// encode of holoscene_tpu/models/fields.py implicit_sdf_raw. Plain PyTorch
// twin: sampler_fwd_plain in holoscene_tpu_torch/ops/hashgrid.py.
//
// What it computes. For point n and level l < L (the sampler's coarse
// levels): feats[n, 2l + c] = sum_k cw_k e_c(row_k), where dense levels read
// the table's exact float32 values with the cell clamped to [0, res - 2]
// and hashed levels read bf16-rounded values at the wrapped hash; zeros for
// a point outside [0, 1]. The caller zero-pads the fine levels. With
// `packed` set the dense levels read bf16-rounded values too: the packed
// encode of implicit_sdf_raw (clamped cells where it wraps the row, which
// differ only on zero-weight corners), the encode of mesh extraction's grid
// evaluation. A tetrahedral field's extraction (JAX implicit_sdf_raw ->
// hash_encode(interp="tetrahedral"), hashgrid.py:453) takes the packed
// mode with the tetrahedral stencil of hash_grid.cuh: four corners,
// barycentric weights (interp 1, a template parameter). The sampler and
// the probe bake stay trilinear, as JAX's do (fields.py:105-108).
//
// Bounds on the card. Per (point, level) 8 gathers of 8-byte rows and 8
// bytes written, ~60 flops: memory. The bound counts each 32-byte sector
// the gathers touch once (66 MB at an extraction chunk of 262,144 points x
// 16 levels); the kernel makes one sector request per corner wherever
// neighbouring points do not share a cell (the finest levels of that
// chunk: 33.5M corner loads in all), and those scattered requests are what
// is left of its time (compiled out in a copy, utils/hash_bench.py's
// ablations, the hashed levels' gathers are half of it; the dense levels',
// which neighbouring points share, a tenth at the 8-level probe bake and
// nothing measurable at 16 levels).
// Design: a block is kSamplerPoints consecutive points, one a thread. Each
// thread loads its coordinates once and encodes the levels in groups of
// kSamplerGroup into a shared-memory tile; after each group the block
// writes the tile, each point's 2 x 4 floats one whole 32-byte sector.
// The earlier kernel (commit 2c8f867) ran one thread per (point, level),
// the level the slow index, and wrote two 4-byte values per thread 2L
// floats from its neighbour's: a quarter of a sector per pass over the
// points, and about 60% of its time at an extraction chunk. All blocks
// walk the levels in the same order, in step at each group's barrier, so
// the card gathers from about one group's tables (<= 16.8 MB of the 50 MB
// L2) at a time. The arithmetic of each (point, level) is the earlier
// kernel's, in the same order, so the outputs are bitwise its.
// Measured against the earlier kernel (utils/hash_bench.py, NVIDIA H100
// 80GB HBM3, 700 W): 2.3x at the x01 = 1 extraction chunk, 2.5x at a
// mid-grid one, 1.8x at a probe-bake chunk, 1.6x at the vjp conf's sampler
// call. Tried and not kept, slower at most of those shapes: a grid over
// (32-point tile, group of 4 or 16 levels) with one warp a level; all 16
// levels staged before one store; corners x, x + 1 as one float4 where
// they share a 16-byte row pair.

#include "hash_grid.cuh"

namespace {

using namespace hash_grid;

constexpr int kSamplerPoints = 64;
constexpr int kSamplerGroup = 4;

// feats[n, 2l:2l + 2] of point x at level l: the stencil's corner rows,
// all gathers issued before the sums, the sums in corner order
template <bool kTet>
__device__ __forceinline__ void encode(const float* __restrict__ scales,
                                       const int* __restrict__ ints,
                                       const float2* __restrict__ emb, int L,
                                       int l, const float x[3], int packed,
                                       float& f0, float& f1) {
  const Level lv = load_level(scales, ints, L, l);
  const bool round = packed || !lv.dense;
  const Stencil<kTet> st(lv, x);
  constexpr int K = Stencil<kTet>::kCorners;
  float2 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = emb[st.rows[k]];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float cw = st.weight(k, nullptr);
    if (round) {
      v[k].x = bf16_round(v[k].x);
      v[k].y = bf16_round(v[k].y);
    }
    f0 += cw * v[k].x;
    f1 += cw * v[k].y;
  }
}

template <bool kTet>
__global__ void __launch_bounds__(kSamplerPoints)
    hash_sampler_fwd_kernel(const float* __restrict__ x01,
                            const float2* __restrict__ emb,
                            const float* __restrict__ scales,
                            const int* __restrict__ ints,
                            float* __restrict__ out, int N, int L,
                            int packed) {
  __shared__ float tile[kSamplerPoints * (2 * kSamplerGroup + 1)];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSamplerPoints;
  const int np = min(kSamplerPoints, N - n0);
  const int stride = 2 * kSamplerGroup + 1;
  float x[3] = {0.f, 0.f, 0.f};
  if (tid < np) load_point(x01, n0 + tid, x);
  const bool valid = tid < np && !out_of_range(x);
  for (int l0 = 0; l0 < L; l0 += kSamplerGroup) {
    const int ng = min(kSamplerGroup, L - l0);
#pragma unroll
    for (int j = 0; j < kSamplerGroup; ++j) {
      float f0 = 0.f, f1 = 0.f;
      if (valid && j < ng)
        encode<kTet>(scales, ints, emb, L, l0 + j, x, packed, f0, f1);
      tile[tid * stride + 2 * j] = f0;
      tile[tid * stride + 2 * j + 1] = f1;
    }
    __syncthreads();
    // the tile's np rows of 2 ng floats, 2 L floats apart in out
    const int width = 2 * ng;
    float* dst = out + static_cast<int64_t>(n0) * 2 * L + 2 * l0;
    for (int i = tid; i < np * width; i += kSamplerPoints) {
      const int r = i / width, c = i - r * width;
      dst[static_cast<int64_t>(r) * 2 * L + c] = tile[r * stride + c];
    }
    __syncthreads();
  }
}

template <bool kTet>
int launch(const void* x01, const void* emb, const void* scales,
           const void* ints, void* out, int n, int n_levels, int packed,
           void* stream) {
  const int blocks = (n + kSamplerPoints - 1) / kSamplerPoints;
  hash_sampler_fwd_kernel<kTet>
      <<<blocks, kSamplerPoints, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x01), static_cast<const float2*>(emb),
          static_cast<const float*>(scales), static_cast<const int*>(ints),
          static_cast<float*>(out), n, n_levels, packed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// interp: 0 trilinear, 1 tetrahedral (packed only). Returns
// cudaGetLastError() after the launch.
extern "C" int hash_sampler_fwd(const void* x01, const void* emb,
                                const void* scales, const void* ints,
                                void* out, int n, int n_levels, int packed,
                                int interp, void* stream) {
  if (interp == 0)
    return launch<false>(x01, emb, scales, ints, out, n, n_levels, packed,
                         stream);
  if (interp == 1 && packed)
    return launch<true>(x01, emb, scales, ints, out, n, n_levels, packed,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
