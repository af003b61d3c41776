// K3: forward tile walk of the top-K splat pipeline, for sm_90a.
//
// Replaces the Pallas TPU kernel _composite_tile_kernel
// (holoscene_tpu/ops/splat_pallas.py), launched there by _core_fwd_impl
// under the _composite_core custom VJP. Plain PyTorch twin:
// composite_fwd_plain in holoscene_tpu_torch/ops/splat_topk.py.
//
// What it computes. Tile t owns a list of K depth-sorted candidates, front
// to back with dead entries (opacity 0) last: rows cand[t, 0..K) of 16
// floats (x y conic_a conic_b conic_c opacity r g b depth one pad*5). They
// are composited at the tile's pixel centres, origin[t] + (col, row) + 0.5:
//   alpha = min(0.999, op * exp(min(power, 0))), alpha < 1/255 counts as 0,
//   exclusive transmittance T = T_chunk_start * exp(prefix sum log(1-alpha)).
// The walk covers at most min(K / 128, ceil(count[t] / 128)) chunks of 128
// candidates and stops after the first chunk at which every pixel of the
// tile has T <= 1e-4 (per-tile, chunk-granular termination); a tile with
// count 0 writes zeros. Out-of-image pixels of edge tiles start at T = 0.
// Output per pixel, 8 floats: rgb(3), depth_acc, 1 - T, 0, total
// log(1 - alpha) over the walked chunks, 0; and used[t], the number of
// chunks walked, as an int beside it (the TPU kernel carried it as a float
// in channel 5). K4's walk length is used[t], and K4 rebuilds every T_k
// from the stored total, so it needs no first pass to recompute it (the TPU
// kernel made that pass; its two spare output channels were unused).
//
// Bounds on the card. Per tile the walk reads used x 8 KB of candidates and
// does ~25 flops plus exp/log1p per live (pixel, candidate): it is bound by
// operations (the special-function units and the serial dependence through
// each thread's running sum), not by memory. Design: one block per tile and
// one thread per pixel, the chunk staged in shared memory with 16-byte
// loads straight from the row-major [T, K, 16] gather, every candidate row
// a shared-memory broadcast. The TPU kernel's transposed [T, 2, K] /
// [T, 4, K] inputs and its [P,128]x[128,128] triangular matmuls (a prefix
// sum on the matrix unit) have no counterpart: each thread runs the
// sequential product itself. The tile-wide termination vote is one
// __syncthreads_or per chunk, which is also the barrier that protects the
// staging buffer. The per-chunk arithmetic is splat_walk.cuh's, shared with
// K1, K2 and K4.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

__global__ void splat_topk_fwd_kernel(const float* __restrict__ cand,
                                      const float* __restrict__ origins,
                                      const int* __restrict__ counts,
                                      float* __restrict__ out,
                                      int* __restrict__ used, int k_total,
                                      int tile_size, int img_w, int img_h) {
  __shared__ __align__(16) float sc[kChunk * kRows];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const float px =
      origins[2 * t] + static_cast<float>(p % tile_size) + 0.5f;
  const float py =
      origins[2 * t + 1] + static_cast<float>(p / tile_size) + 0.5f;
  float trans =
      (px < static_cast<float>(img_w) && py < static_cast<float>(img_h))
          ? 1.0f
          : 0.0f;

  const float* list = cand + static_cast<size_t>(t) * k_total * kRows;
  const int by_count = (max(counts[t], 0) + kChunk - 1) / kChunk;
  const int m = min(k_total / kChunk, by_count);
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_z = 0.f, tot = 0.f;
  int kc = 0;
  int live = __syncthreads_or(trans > kTermEps);
  while (kc < m && live) {
    stage_chunk(sc, list + static_cast<size_t>(kc) * kChunk * kRows, p,
                n_pix);
    __syncthreads();
    const float cum =
        composite_chunk(sc, px, py, trans, acc_r, acc_g, acc_b, acc_z);
    trans *= expf(cum);
    tot += cum;
    ++kc;
    live = __syncthreads_or(trans > kTermEps);
  }

  float* o = out + (static_cast<size_t>(t) * n_pix + p) * 8;
  reinterpret_cast<float4*>(o)[0] = make_float4(acc_r, acc_g, acc_b, acc_z);
  reinterpret_cast<float4*>(o)[1] = make_float4(1.0f - trans, 0.0f, tot, 0.0f);
  if (p == 0) used[t] = kc;
}

}  // namespace

extern "C" int splat_topk_fwd(const void* cand, const void* origins,
                              const void* counts, void* out, void* used,
                              int n_tiles, int k_total, int tile_size,
                              int img_w, int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  splat_topk_fwd_kernel<<<n_tiles, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(origins),
      static_cast<const int*>(counts), static_cast<float*>(out),
      static_cast<int*>(used), k_total, tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}
