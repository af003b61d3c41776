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
// does ~25 flops per (pixel, candidate) up to the 1/255 cut and ~40 more,
// log1pf the most of them, per candidate some pixel keeps: operations, not
// memory. The walk it replaced evaluated the alpha of every candidate of
// every walked chunk at every pixel, 79% of its time, though a warp had a
// live lane for under a quarter of (warp, candidate) pairs on a training
// frame. Design (splat_walk.cuh::composite_tile, shared with K1): one block
// per tile, one thread per pixel, each warp on an 8 x 4 pixel block; a warp
// first tests the chunk's 128 candidates against the rectangle of its
// pixel centres (the binning's Schur bound, with a margin that covers the
// float rounding) and composites only those it keeps, 30% of the pairs,
// four at a time with their alphas, log1p and exps overlapped; the next
// chunk is in flight (cp.async) meanwhile, and the tile-wide termination
// vote is the one block barrier a chunk. Every output is the same bits as
// the walk that visited all rows. The TPU kernel's transposed [T, 2, K] /
// [T, 4, K] inputs and its [P,128]x[128,128] triangular matmuls (a prefix
// sum on the matrix unit) have no counterpart: each thread runs the
// sequential sum itself, from the row-major [T, K, 16] gather.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

// The launch bounds are the register budget: a 1024-thread block (tile 32)
// can be given 64 registers a thread and no more; for the 256-thread blocks
// of 16 x 16 tiles ptxas takes 60-62 at four blocks an SM, which is faster
// here than 48 at five (8-10%) or 32 at eight (27%, with spills).
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    splat_topk_fwd_kernel(const float* __restrict__ cand,
                          const float* __restrict__ origins,
                          const int* __restrict__ counts,
                          float* __restrict__ out, int* __restrict__ used,
                          int k_total, int tile_size, int img_w, int img_h) {
  const int t = blockIdx.x;
  const int q = fwd_pixel(threadIdx.x, tile_size);
  const float px =
      origins[2 * t] + static_cast<float>(q % tile_size) + 0.5f;
  const float py =
      origins[2 * t + 1] + static_cast<float>(q / tile_size) + 0.5f;
  const bool in_img =
      px < static_cast<float>(img_w) && py < static_cast<float>(img_h);
  const int by_count = (max(counts[t], 0) + kChunk - 1) / kChunk;
  const FwdPixel r =
      composite_tile(cand + static_cast<size_t>(t) * k_total * kRows,
                     min(k_total / kChunk, by_count), px, py, in_img);

  float* o = out + (static_cast<size_t>(t) * blockDim.x + q) * 8;
  reinterpret_cast<float4*>(o)[0] = make_float4(r.r, r.g, r.b, r.z);
  reinterpret_cast<float4*>(o)[1] =
      make_float4(1.0f - r.trans, 0.0f, r.tot, 0.0f);
  if (threadIdx.x == 0) used[t] = r.used;
}

template <int kMaxThreads, int kMinBlocks>
int launch(const void* cand, const void* origins, const void* counts,
           void* out, void* used, int n_tiles, int k_total, int tile_size,
           int img_w, int img_h, void* stream) {
  splat_topk_fwd_kernel<kMaxThreads, kMinBlocks>
      <<<n_tiles, tile_size * tile_size, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(cand), static_cast<const float*>(origins),
          static_cast<const int*>(counts), static_cast<float*>(out),
          static_cast<int*>(used), k_total, tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_topk_fwd(const void* cand, const void* origins,
                              const void* counts, void* out, void* used,
                              int n_tiles, int k_total, int tile_size,
                              int img_w, int img_h, void* stream) {
  if (tile_size * tile_size <= 256) {
    return launch<256, 4>(cand, origins, counts, out, used, n_tiles, k_total,
                          tile_size, img_w, img_h, stream);
  }
  return launch<1024, 1>(cand, origins, counts, out, used, n_tiles, k_total,
                         tile_size, img_w, img_h, stream);
}
