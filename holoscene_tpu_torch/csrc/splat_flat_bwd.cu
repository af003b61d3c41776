// K2: backward tile walk of the flat splat pipeline, for sm_90a.
//
// Replaces the Pallas TPU kernel _flat_bwd_kernel3
// (holoscene_tpu/ops/splat_flat.py), launched there by _flat_core_bwd.
// Plain PyTorch twin (the same closed form): flat_bwd_plain in
// holoscene_tpu_torch/ops/splat_flat.py.
//
// What it computes. For tile t it walks, in reverse, exactly the `used`
// chunks K1 composited (fwd[t, 0, 5]) and, within each chunk, the
// candidates in reverse. Per pixel it rebuilds the exclusive transmittance
// from K1's stored total:
//   log T_k = total - sum_{r >= k} log(1 - a_r)
// (the running suffix, never a division by 1 - a), carries
// s_after = sum_{r > k} w_r s_r with w_r = a_r T_r and s_r = v . payload_r,
// and forms
//   dL/da_k = T_k s_k - s_after / (1 - a_k),
// masked to alpha >= 1/255 and a_pre < 0.999 (the clamp), with the exponent
// gradient masked to power < 0. Each candidate's 256 per-pixel
// contributions (dx, dy, d conic a/b/c, d opacity, d rgb, d depth) are
// reduced with warp shuffles, then shared-memory atomics into a [128][10]
// buffer, and written to the chunk's rows of dcand [c_max, 16]. A chunk
// belongs to one tile, so no global atomics are needed. Columns 10-15 and
// every chunk the walk skipped stay as the wrapper's torch.zeros left them
// (the TPU kernel zero-filled them by DMA).
//
// Bounds on the card. Like K1 it is bound by per-candidate arithmetic
// (exp, log1p, one division) and here also by the cross-pixel reductions:
// 10 warp reductions per live candidate. Design: one block per tile, one
// thread per pixel, candidates broadcast from shared memory; a candidate no
// pixel of a warp reaches (alpha < 1/255 everywhere) contributes exact
// zeros, so that warp skips its reduction (__any_sync vote).

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

__global__ void splat_flat_bwd_kernel(const float* __restrict__ cand,
                                      const int* __restrict__ cs,
                                      const float* __restrict__ fwd,
                                      const float* __restrict__ v,
                                      float* __restrict__ dcand, int tiles_x,
                                      int tile_size, int img_w, int img_h) {
  __shared__ __align__(16) float sc[kChunk * kRows];
  __shared__ float sg[kChunk * kGradRows];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int lane = p & 31;
  const float px =
      static_cast<float>((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py =
      static_cast<float>((t / tiles_x) * tile_size + p / tile_size) + 0.5f;
  const bool in_img =
      px < static_cast<float>(img_w) && py < static_cast<float>(img_h);

  const size_t pix = static_cast<size_t>(t) * n_pix + p;
  const int used = static_cast<int>(fwd[static_cast<size_t>(t) * n_pix * 8 + 5]);
  const float total = fwd[pix * 8 + 6];
  const float vp[5] = {v[pix * 8 + 0], v[pix * 8 + 1], v[pix * 8 + 2],
                       v[pix * 8 + 3], v[pix * 8 + 4]};
  const int c0 = cs[t];

  float suffix = 0.f;   // sum log(1 - a) over later candidates
  float s_after = 0.f;  // sum w s over later candidates
  for (int j = 0; j < used; ++j) {
    const size_t row0 = static_cast<size_t>(c0 + used - 1 - j) * kChunk * kRows;
    stage_chunk(sc, cand + row0, p, n_pix);
    for (int i = p; i < kChunk * kGradRows; i += n_pix) sg[i] = 0.f;
    __syncthreads();
    backprop_chunk(sc, sg, px, py, in_img, total, vp, suffix, s_after, lane);
    __syncthreads();
    store_chunk_grads(dcand + row0, sg, p, n_pix);
    __syncthreads();
  }
}

}  // namespace

extern "C" int splat_flat_bwd(const void* cand, const void* cs,
                              const void* fwd, const void* v, void* dcand,
                              int n_tiles, int tiles_x, int tile_size,
                              int img_w, int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  splat_flat_bwd_kernel<<<n_tiles, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int*>(cs),
      static_cast<const float*>(fwd), static_cast<const float*>(v),
      static_cast<float*>(dcand), tiles_x, tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}
