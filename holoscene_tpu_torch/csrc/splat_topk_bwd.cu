// K4: backward tile walk of the top-K splat pipeline, for sm_90a.
//
// Replaces the Pallas TPU kernel _composite_bwd_kernel
// (holoscene_tpu/ops/splat_pallas.py), launched there by _core_bwd. Plain
// PyTorch twin (the same closed form): composite_bwd_plain in
// holoscene_tpu_torch/ops/splat_topk.py.
//
// What it computes. For tile t it walks, in reverse, exactly the used[t]
// chunks K3 composited of the tile's own list cand[t, 0..K) and, within
// each chunk, the candidates in reverse. Per pixel it rebuilds the exclusive
// transmittance from K3's stored total (fwd[t, p, 6]):
//   log T_k = total - sum_{r >= k} log(1 - a_r)
// (the running suffix, never a division by 1 - a), carries
// s_after = sum_{r > k} w_r s_r with w_r = a_r T_r and s_r = v . payload_r
// (v = cotangents of rgb, depth_acc, alpha), and forms
//   dL/da_k = T_k s_k - s_after / (1 - a_k),
// masked to alpha >= 1/255 and a_pre < 0.999 (the clamp), with the exponent
// gradient masked to power < 0. The total comes from K3's output, so the TPU
// kernel's first pass, which recomputed it over all walked chunks, is gone.
// Each candidate's 256 per-pixel contributions (dx, dy, d conic a/b/c,
// d opacity, d rgb, d depth) are summed and written to the chunk's rows of
// dcand [T, K, 16], the layout of the gather, whose transpose is then one
// index_add; all 16 columns of a walked row are written (10-15 zeros). Slot
// (t, k) belongs to one tile, so no global atomics are needed. Every slot
// beyond the walked chunks stays as the wrapper's torch.zeros left it; a
// dead entry (opacity 0) has alpha 0 everywhere and receives exact zeros.
//
// Bounds on the card. By the count of bytes (the wrapper clears all of
// dcand, 67 MB for lists [1024, 1024, 16], of which the walk writes a
// third), but the time goes to operations as in K2: the alpha of every
// (candidate, pixel) pair and, for the live ones, a log1p, an exp, a
// division and ten sums over the tile (everything after the alpha in
// double: splat_walk.cuh::backprop_chunk says why). The
// walk is K2's, splat_walk.cuh::backprop_tile: per-warp slabs instead of
// shared-memory atomics, a 12-shuffle transposing butterfly, alphas in
// groups of eight with a ballot so that only candidates live in the warp
// reach the serial part, the next chunk fetched by cp.async meanwhile. One
// block per tile, one thread per pixel; a 256-thread block takes 53 KB of
// dynamic shared memory and 80 registers a thread (36 bytes spilled): three
// blocks an SM. Sums are taken in a fixed order, so the result is the same
// bits from launch to launch.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

// The launch bounds are the register budget only: a 1024-thread block can
// be given 64 registers a thread and no more (ptxas spills 84 bytes there
// since the chain went to double, 16 before); for the 256-thread blocks of
// 16 x 16 tiles it takes 80 at three blocks an SM, its cap there (71 before
// the double chain, then 4-6% faster here than 64 at four).
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    splat_topk_bwd_kernel(const float* __restrict__ cand,
                          const float* __restrict__ origins,
                          const int* __restrict__ used,
                          const float* __restrict__ fwd,
                          const float* __restrict__ v,
                          float* __restrict__ dcand, int k_total,
                          int tile_size, int img_w, int img_h) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int n_used = min(max(used[t], 0), k_total / kChunk);
  if (n_used == 0) return;
  const float px =
      origins[2 * t] + static_cast<float>(p % tile_size) + 0.5f;
  const float py =
      origins[2 * t + 1] + static_cast<float>(p / tile_size) + 0.5f;
  const bool in_img =
      px < static_cast<float>(img_w) && py < static_cast<float>(img_h);

  const size_t pix = static_cast<size_t>(t) * n_pix + p;
  const float total = fwd[pix * 8 + 6];
  const float vp[5] = {v[pix * 8 + 0], v[pix * 8 + 1], v[pix * 8 + 2],
                       v[pix * 8 + 3], v[pix * 8 + 4]};
  const size_t last = (static_cast<size_t>(t) * k_total +
                       static_cast<size_t>(n_used - 1) * kChunk) * kRows;
  backprop_tile(cand + last, dcand + last, n_used, px, py, in_img, total, vp);
}

template <int kMaxThreads, int kMinBlocks>
int launch(const void* cand, const void* origins, const void* used,
           const void* fwd, const void* v, void* dcand, int n_tiles,
           int k_total, int tile_size, int img_w, int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  const size_t smem = bwd_smem_bytes(threads);
  const cudaError_t err =
      allow_bwd_smem(splat_topk_bwd_kernel<kMaxThreads, kMinBlocks>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  splat_topk_bwd_kernel<kMaxThreads, kMinBlocks>
      <<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(cand), static_cast<const float*>(origins),
          static_cast<const int*>(used), static_cast<const float*>(fwd),
          static_cast<const float*>(v), static_cast<float*>(dcand), k_total,
          tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_topk_bwd(const void* cand, const void* origins,
                              const void* used, const void* fwd,
                              const void* v, void* dcand, int n_tiles,
                              int k_total, int tile_size, int img_w,
                              int img_h, void* stream) {
  if (tile_size * tile_size <= 256) {
    return launch<256, 3>(cand, origins, used, fwd, v, dcand, n_tiles,
                          k_total, tile_size, img_w, img_h, stream);
  }
  return launch<1024, 1>(cand, origins, used, fwd, v, dcand, n_tiles, k_total,
                         tile_size, img_w, img_h, stream);
}
