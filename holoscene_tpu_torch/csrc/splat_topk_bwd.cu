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
// d opacity, d rgb, d depth) are reduced with warp shuffles, then
// shared-memory atomics into a [128][10] buffer, and written to the chunk's
// rows of dcand [T, K, 16], the layout of the gather, whose transpose is
// then one index_add. Slot (t, k) belongs to one tile, so no global atomics
// are needed and the result does not depend on block scheduling (the order
// of the shared-memory atomics across a block's eight warps does vary).
// Columns 10-15 and every slot beyond the walked chunks stay as the
// wrapper's torch.zeros left them; a dead entry (opacity 0) has alpha 0
// everywhere and receives exact zeros.
//
// Bounds on the card. Like K3 it is bound by per-candidate operations (exp,
// log1p, one division) and here also by the cross-pixel reductions: 10 warp
// reductions per live candidate. Design: one block per tile, one thread per
// pixel, candidates broadcast from shared memory; a candidate no pixel of a
// warp reaches contributes exact zeros, so that warp skips its reduction.
// The per-chunk arithmetic is splat_walk.cuh's, shared with K1-K3.

#include "splat_walk.cuh"

namespace {

using namespace splat_walk;

__global__ void splat_topk_bwd_kernel(const float* __restrict__ cand,
                                      const float* __restrict__ origins,
                                      const int* __restrict__ used,
                                      const float* __restrict__ fwd,
                                      const float* __restrict__ v,
                                      float* __restrict__ dcand, int k_total,
                                      int tile_size, int img_w, int img_h) {
  __shared__ __align__(16) float sc[kChunk * kRows];
  __shared__ float sg[kChunk * kGradRows];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int lane = p & 31;
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
  const int n_used = min(max(used[t], 0), k_total / kChunk);
  const size_t list0 = static_cast<size_t>(t) * k_total * kRows;

  float suffix = 0.f;   // sum log(1 - a) over later candidates
  float s_after = 0.f;  // sum w s over later candidates
  for (int j = 0; j < n_used; ++j) {
    const size_t row0 =
        list0 + static_cast<size_t>(n_used - 1 - j) * kChunk * kRows;
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

extern "C" int splat_topk_bwd(const void* cand, const void* origins,
                              const void* used, const void* fwd,
                              const void* v, void* dcand, int n_tiles,
                              int k_total, int tile_size, int img_w,
                              int img_h, void* stream) {
  const int threads = tile_size * tile_size;
  splat_topk_bwd_kernel<<<n_tiles, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(origins),
      static_cast<const int*>(used), static_cast<const float*>(fwd),
      static_cast<const float*>(v), static_cast<float*>(dcand), k_total,
      tile_size, img_w, img_h);
  return static_cast<int>(cudaGetLastError());
}
