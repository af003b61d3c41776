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
// summed and written to the chunk's rows of dcand [c_max, 16], all 16
// columns of a walked row (10-15 zeros). A chunk belongs to one tile, so no
// global atomics are needed. Every chunk the walk skipped stays as the
// wrapper's torch.zeros left it (the TPU kernel zero-filled them by DMA).
//
// Bounds on the card. Operations, not bytes: a walked chunk is 8 KB read
// and 8 KB written against ~33k alpha evaluations and, for the quarter of
// the (candidate, pixel) pairs that are live, a log1p, an exp, a division
// and ten sums over the tile (everything after the alpha in double:
// splat_walk.cuh::backprop_chunk says why). What the time goes to
// is the sums: the design of splat_walk.cuh::backprop_tile (per-warp slabs
// instead of shared-memory atomics, a 12-shuffle transposing butterfly,
// alphas in groups of eight with a ballot so that only candidates live in
// the warp reach the serial part, the next chunk fetched by cp.async
// meanwhile) is shared with K4. One block per tile, one thread per pixel; a
// 256-thread block takes 53 KB of dynamic shared memory and 80 registers a
// thread (24 bytes spilled): three blocks an SM. Sums are taken in a fixed
// order, so the result is the same bits from launch to launch.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

// The launch bounds are the register budget only: a 1024-thread block can
// be given 64 registers a thread and no more (ptxas spills 68 bytes there
// with the walk in double, 16 before the chain went to double); for the
// 256-thread blocks of
// 16 x 16 tiles it takes 80 at three blocks an SM, its cap there (75 before
// the double chain, 71 before the chunk partials of
// splat_walk.cuh::backprop_chunk; then 4-6% faster here than 64 at four).
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    splat_flat_bwd_kernel(const float* __restrict__ cand,
                          const int* __restrict__ cs,
                          const float* __restrict__ fwd,
                          const float* __restrict__ v,
                          float* __restrict__ dcand, int tiles_x,
                          int tile_size, int img_w, int img_h) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int used = static_cast<int>(fwd[static_cast<size_t>(t) * n_pix * 8 + 5]);
  if (used <= 0) return;
  const float px =
      static_cast<float>((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py =
      static_cast<float>((t / tiles_x) * tile_size + p / tile_size) + 0.5f;
  const bool in_img =
      px < static_cast<float>(img_w) && py < static_cast<float>(img_h);

  const size_t pix = static_cast<size_t>(t) * n_pix + p;
  const float total = fwd[pix * 8 + 6];
  const float vp[5] = {v[pix * 8 + 0], v[pix * 8 + 1], v[pix * 8 + 2],
                       v[pix * 8 + 3], v[pix * 8 + 4]};
  const size_t last = static_cast<size_t>(cs[t] + used - 1) * kChunk * kRows;
  backprop_tile(cand + last, dcand + last, used, px, py, in_img, total, vp);
}

template <int kMaxThreads, int kMinBlocks>
int launch(const void* cand, const void* cs, const void* fwd, const void* v,
           void* dcand, int n_tiles, int tiles_x, int tile_size, int img_w,
           int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  const size_t smem = bwd_smem_bytes(threads);
  const cudaError_t err =
      allow_bwd_smem(splat_flat_bwd_kernel<kMaxThreads, kMinBlocks>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splat_flat_bwd_kernel<kMaxThreads, kMinBlocks>
      <<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(cand), static_cast<const int*>(cs),
          static_cast<const float*>(fwd), static_cast<const float*>(v),
          static_cast<float*>(dcand), tiles_x, tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_flat_bwd(const void* cand, const void* cs,
                              const void* fwd, const void* v, void* dcand,
                              int n_tiles, int tiles_x, int tile_size,
                              int img_w, int img_h, void* stream) {
  if (tile_size * tile_size <= 256) {
    return launch<256, 3>(cand, cs, fwd, v, dcand, n_tiles, tiles_x,
                          tile_size, img_w, img_h, stream);
  }
  return launch<1024, 1>(cand, cs, fwd, v, dcand, n_tiles, tiles_x, tile_size,
                         img_w, img_h, stream);
}
