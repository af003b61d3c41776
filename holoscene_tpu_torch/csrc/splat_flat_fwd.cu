// K1: forward tile walk of the flat splat pipeline, for sm_90a.
//
// Replaces the Pallas TPU kernel _flat_fwd_kernel3
// (holoscene_tpu/ops/splat_flat.py), launched there by _fwd_call3 under the
// _flat_core custom VJP. Plain PyTorch twin: flat_fwd_plain in
// holoscene_tpu_torch/ops/splat_flat.py.
//
// What it computes. For tile t, the candidates of chunks
// [cs[t], cs[t] + cc[t]) (128 depth-sorted rows of 16 floats each:
// x y conic_a conic_b conic_c opacity r g b depth one pad*5) are composited
// front to back at the tile's pixel centres:
//   alpha = min(0.999, op * exp(min(power, 0))), alpha < 1/255 counts as 0,
//   exclusive transmittance T = T_chunk_start * exp(prefix sum log(1-alpha)).
// The walk stops after the first chunk at which every pixel of the tile has
// T <= 1e-4 (per-tile, chunk-granular termination: `used_chunks`, the
// saturation trim and the stale flag all read it). Out-of-image pixels start
// at T = 0. Output per pixel, 8 floats: rgb(3), depth_acc, 1 - T,
// used_chunks, total log(1 - alpha) over the walked chunks (K2 rebuilds
// every T_k from it), ended-live flag.
//
// Bounds on the card. Per tile the walk reads used x 8 KB of candidates and
// does ~25 flops per (pixel, candidate) up to the 1/255 cut and ~40 more,
// log1pf the most of them, per candidate some pixel keeps: operations, not
// memory. The walk it replaced evaluated the alpha of all 128 candidates of
// every chunk at every pixel, 75% of its time, though a warp had a live
// lane for a third of (warp, candidate) pairs on a training frame.
// Design (splat_walk.cuh::composite_tile, shared with K3): one block per
// tile, one thread per pixel, each warp on an 8 x 4 pixel block; a warp
// first tests the chunk's 128 candidates against the rectangle of its
// pixel centres (the binning's Schur bound, with a margin that covers the
// float rounding) and composites only those it keeps, 41% of the pairs,
// four at a time with their alphas, log1p and exps overlapped; the next
// chunk is in flight (cp.async) meanwhile, and the tile-wide termination
// vote is the one block barrier a chunk. Every output is the same bits as
// the walk that visited all 128 rows. The output stays indexed by pixel.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

// The launch bounds are the register budget: a 1024-thread block (tile 32)
// can be given 64 registers a thread and no more; for the 256-thread blocks
// of 16 x 16 tiles ptxas takes 60-62 at four blocks an SM, which is faster
// here than 48 at five (8-10%) or 32 at eight (27%, with spills).
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    splat_flat_fwd_kernel(const float* __restrict__ cand,
                          const int* __restrict__ cs,
                          const int* __restrict__ cc,
                          float* __restrict__ out, int tiles_x,
                          int tile_size, int img_w, int img_h) {
  const int t = blockIdx.x;
  const int q = fwd_pixel(threadIdx.x, tile_size);
  const float px =
      static_cast<float>((t % tiles_x) * tile_size + q % tile_size) + 0.5f;
  const float py =
      static_cast<float>((t / tiles_x) * tile_size + q / tile_size) + 0.5f;
  const bool in_img =
      px < static_cast<float>(img_w) && py < static_cast<float>(img_h);
  const int m = cc[t];
  const FwdPixel r = composite_tile(cand + static_cast<size_t>(cs[t]) * kStep,
                                    m, px, py, in_img);

  float* o = out + (static_cast<size_t>(t) * blockDim.x + q) * 8;
  reinterpret_cast<float4*>(o)[0] = make_float4(r.r, r.g, r.b, r.z);
  reinterpret_cast<float4*>(o)[1] =
      make_float4(1.0f - r.trans, static_cast<float>(r.used), r.tot,
                  (r.used >= m && r.live) ? 1.0f : 0.0f);
}

template <int kMaxThreads, int kMinBlocks>
int launch(const void* cand, const void* cs, const void* cc, void* out,
           int n_tiles, int tiles_x, int tile_size, int img_w, int img_h,
           void* stream) {
  splat_flat_fwd_kernel<kMaxThreads, kMinBlocks>
      <<<n_tiles, tile_size * tile_size, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(cand), static_cast<const int*>(cs),
          static_cast<const int*>(cc), static_cast<float*>(out), tiles_x,
          tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_flat_fwd(const void* cand, const void* cs,
                              const void* cc, void* out, int n_tiles,
                              int tiles_x, int tile_size, int img_w,
                              int img_h, void* stream) {
  if (tile_size * tile_size <= 256) {
    return launch<256, 4>(cand, cs, cc, out, n_tiles, tiles_x, tile_size,
                          img_w, img_h, stream);
  }
  return launch<1024, 1>(cand, cs, cc, out, n_tiles, tiles_x, tile_size,
                         img_w, img_h, stream);
}
