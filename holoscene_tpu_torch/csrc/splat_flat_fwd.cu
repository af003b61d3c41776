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
// does ~25 flops per (pixel, candidate): at the 512^2 training shapes it is
// bound by the exp/log1p issue rate and by the serial dependence through
// the running sum inside each thread, not by memory. Design: one block per
// tile and one thread per pixel, so every candidate row is a shared-memory
// broadcast (all threads read the same address); the chunk is staged with
// 16-byte loads straight from the row-major [c_max, 16] gather (no field-
// major transpose: that layout only served the TPU's DMA engine); candidates
// whose alpha is below 1/255 skip the exp/log1p work; the tile-wide
// termination vote is one __syncthreads_or per chunk, which is also the
// barrier that protects the staging buffer. The per-chunk arithmetic is
// splat_walk.cuh's, shared with K2-K4.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

__global__ void splat_flat_fwd_kernel(const float* __restrict__ cand,
                                      const int* __restrict__ cs,
                                      const int* __restrict__ cc,
                                      float* __restrict__ out, int tiles_x,
                                      int tile_size, int img_w, int img_h) {
  __shared__ __align__(16) float sc[kChunk * kRows];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const float px =
      static_cast<float>((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py =
      static_cast<float>((t / tiles_x) * tile_size + p / tile_size) + 0.5f;
  float trans =
      (px < static_cast<float>(img_w) && py < static_cast<float>(img_h))
          ? 1.0f
          : 0.0f;

  const int c0 = cs[t];
  const int m = cc[t];
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_z = 0.f, tot = 0.f;
  int kc = 0;
  int live = __syncthreads_or(trans > kTermEps);
  while (kc < m && live) {
    stage_chunk(sc, cand + static_cast<size_t>(c0 + kc) * kChunk * kRows, p,
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
  reinterpret_cast<float4*>(o)[1] =
      make_float4(1.0f - trans, static_cast<float>(kc), tot,
                  (kc >= m && live) ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int splat_flat_fwd(const void* cand, const void* cs,
                              const void* cc, void* out, int n_tiles,
                              int tiles_x, int tile_size, int img_w,
                              int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  splat_flat_fwd_kernel<<<n_tiles, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int*>(cs),
      static_cast<const int*>(cc), static_cast<float*>(out), tiles_x,
      tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}
