// Device code shared by the four tile-walk kernels (K1/K2 of the flat
// pipeline, K3/K4 of the top-K pipeline): the per-candidate alpha, the
// forward compositing of one staged 128-candidate chunk and the closed-form
// reverse walk of a tile. The kernels differ only in where a tile's chunks
// come from (flat chunk ranges vs. the tile's own [K, 16] list), where its
// pixels lie and how far it walks; the arithmetic per (pixel, candidate) is
// the same and lives here once, so that all four round every alpha
// identically (the build keeps -fmad=false for the same reason).
//
// A candidate is a row of 16 floats:
//   x y conic_a conic_b conic_c opacity r g b depth one pad*5.
// One thread owns one pixel; a chunk is staged in shared memory and every
// thread reads the same row at the same time (a broadcast).
//
// The backward walk (backprop_tile, K2 and K4). On an H100 the walk it
// replaces spent 70% of its time summing each candidate's ten gradient
// terms over the tile's pixels: ten five-step shuffle butterflies (16%) and
// ten shared-memory atomicAdds a warp on addresses all warps of the block
// hit together (54%); the alpha test of all 128 candidates was 13%, the
// per-pixel chain 17%. What this one does about it:
//  - no atomics: within a chunk a warp meets a candidate once, so it STORES
//    its ten partial sums in a slab of its own ([128][10] floats a warp,
//    dynamic shared memory) and records in a 128-bit mask which candidates
//    it reached; after the chunk the block adds the slabs in warp order,
//    skipping slabs whose bit is clear, and writes whole 64-byte rows. The
//    order of every sum is fixed: two launches give the same bits.
//  - ten sums in 12 shuffles: a transposing butterfly in which a lane keeps
//    half of its values and hands the other half to its partner (5, 3, 2,
//    1, 1 exchanges), so the ten sums end in ten different lanes.
//  - alpha first, chain second: candidates are taken in groups of eight;
//    the eight alphas (the very expression of composite_chunk) are
//    independent, so their exps overlap, and one ballot each says which of
//    them any lane of the warp keeps. Only those run the serial part
//    (log1p, the exp of the running suffix, the division) and the sums.
//  - the next chunk in flight: two staging buffers filled by cp.async, the
//    copy of chunk j+1 issued before chunk j is worked on. Only the 12
//    floats of a row that the walk reads are staged (52 KB of shared
//    memory a 256-thread block with the slabs).

#pragma once

#include <cuda_runtime.h>

namespace splat_walk {

constexpr int kChunk = 128;
constexpr int kRows = 16;
constexpr int kGradRows = 10;  // x y conic(3) opacity rgb depth
constexpr float kTermEps = 1e-4f;
constexpr float kAlphaEps = 1.0f / 255.0f;

// Copy one chunk (kChunk rows, 8 KB) into shared memory with 16-byte loads.
// The caller synchronises.
__device__ __forceinline__ void stage_chunk(float* sc, const float* src,
                                            int p, int n_pix) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(sc);
  for (int i = p; i < kChunk * kRows / 4; i += n_pix) d4[i] = s4[i];
}

// Front-to-back compositing of the staged chunk at pixel (px, py), whose
// transmittance at chunk entry is `trans`. Adds to the accumulators and
// returns the chunk's sum of log(1 - alpha). Candidates below the 1/255 cut
// skip the exp/log1p work.
__device__ __forceinline__ float composite_chunk(const float* sc, float px,
                                                 float py, float trans,
                                                 float& acc_r, float& acc_g,
                                                 float& acc_b, float& acc_z) {
  float cum = 0.f;  // sum log(1 - alpha) of this chunk's earlier rows
  for (int k = 0; k < kChunk; ++k) {
    const float* c = sc + k * kRows;
    const float dx = px - c[0];
    const float dy = py - c[1];
    const float power =
        -0.5f * (c[2] * dx * dx + 2.0f * c[3] * dx * dy + c[4] * dy * dy);
    const float a = fminf(0.999f, c[5] * expf(fminf(power, 0.0f)));
    if (a < kAlphaEps) continue;
    const float w = a * expf(cum) * trans;
    acc_r += w * c[6];
    acc_g += w * c[7];
    acc_b += w * c[8];
    acc_z += w * c[9];
    cum += log1pf(-a);
  }
  return cum;
}

// ---------------------------------------------------------------------------
// The backward walk
// ---------------------------------------------------------------------------

constexpr int kStageRows = 12;  // floats of a row the backward walk reads
constexpr int kGroup = 8;       // candidates whose alphas are taken together
constexpr unsigned kFullWarp = 0xffffffffu;

// Dynamic shared memory of a backward block with n_warps warps, in floats:
//   stage [2][kChunk][kStageRows] | slabs [n_warps][kChunk][kGradRows]
//   | masks [n_warps][4] (unsigned)
inline size_t bwd_smem_bytes(int threads) {
  const size_t n_warps = threads / 32;
  return sizeof(float) * (2 * kChunk * kStageRows +
                          n_warps * kChunk * kGradRows + n_warps * 4);
}

// Let a backward kernel use that much dynamic shared memory (above 48 KB a
// kernel has to ask), with the SM's shared memory at its largest so that as
// many blocks as possible fit.
template <typename Kernel>
inline cudaError_t allow_bwd_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Ask for chunk `src` (kChunk rows of kRows floats, contiguous) to be copied
// into `dst` [kChunk][kStageRows], three 16-byte pieces a row, without
// waiting for it.
__device__ __forceinline__ void prefetch_chunk(float* dst, const float* src,
                                               int p, int n_pix) {
  constexpr int kPieces = kStageRows / 4;
  for (int i = p; i < kChunk * kPieces; i += n_pix) {
    const int row = i / kPieces;
    const int q = i - row * kPieces;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + row * kStageRows + q * 4));
    const size_t g = __cvta_generic_to_global(src + row * kRows + q * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(g)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; the caller's barrier makes all visible.
__device__ __forceinline__ void wait_prefetch() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum each of the ten values over the warp's 32 lanes in 12 shuffles. At
// every step a lane keeps half of what it holds and sends the other half to
// its partner, so the sums end spread over the lanes: the lane with
// grad_row(lane) >= 0 returns that row's sum. The order of the additions is
// fixed by the lane numbers alone.
__device__ __forceinline__ float reduce_rows(const float (&g)[kGradRows],
                                             int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
  float h[5], m[3], n[2];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float mine = u4 ? g[5 + i] : g[i];
    const float theirs = u4 ? g[i] : g[5 + i];
    h[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float upper = i < 2 ? h[3 + i] : 0.f;
    const float mine = u3 ? upper : h[i];
    const float theirs = u3 ? h[i] : upper;
    m[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float upper = i < 1 ? m[2] : 0.f;
    const float mine = u2 ? upper : m[i];
    const float theirs = u2 ? m[i] : upper;
    n[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 4);
  }
  const float mine = u1 ? n[1] : n[0];
  const float theirs = u1 ? n[0] : n[1];
  float q = mine + __shfl_xor_sync(kFullWarp, theirs, 2);
  q += __shfl_xor_sync(kFullWarp, q, 1);
  return q;
}

// The gradient row whose sum reduce_rows leaves in this lane, or -1: rows
// 0-4 end in lanes 0-15, rows 5-9 in lanes 16-31, one even lane each.
__device__ __forceinline__ int grad_row(int lane) {
  const int b3 = (lane >> 3) & 1;
  const int low = (lane >> 1) & 3;  // 2 * bit2 + bit1
  if ((lane & 1) || low > 2 - b3) return -1;
  return 5 * (lane >> 4) + 3 * b3 + low;
}

// Reverse walk of the staged chunk `sc` [kChunk][kStageRows] by one warp at
// its lanes' pixels (px, py): rebuilds
//   log T_k = total - sum_{r >= k} log(1 - a_r)
// from the forward's total and the running `suffix` (never a division by
// 1 - a), carries s_after = sum_{r > k} w_r s_r, and forms
//   dL/da_k = T_k s_k - s_after / (1 - a_k),
// masked to alpha >= 1/255 and a_pre < 0.999 (the clamp), the exponent's
// gradient masked to power < 0. For every candidate that some lane keeps the
// warp's ten sums go to slab [kChunk][kGradRows] and the candidate's bit is
// set in mask [4]; the other entries of the slab are left as they were.
__device__ __forceinline__ void backprop_chunk(const float* sc, float* slab,
                                               unsigned* mask, float px,
                                               float py, bool in_img,
                                               float total,
                                               const float (&v)[5],
                                               float& suffix, float& s_after,
                                               int lane, int row) {
  for (int word = kChunk / 32 - 1; word >= 0; --word) {
    unsigned reached = 0;  // bit k % 32: some lane keeps candidate k
    for (int grp = 32 / kGroup - 1; grp >= 0; --grp) {
      const int k0 = word * 32 + grp * kGroup;
      // the group's alphas, independent of each other and of the chain
      float e[kGroup];
      unsigned negative = 0;  // bit i: power < 0 at this pixel
      unsigned bits = 0;      // bit i: some lane keeps candidate k0 + i
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float* c = sc + (k0 + i) * kStageRows;
        const float4 c0 = *reinterpret_cast<const float4*>(c);
        const float2 c1 = *reinterpret_cast<const float2*>(c + 4);
        const float dx = px - c0.x;
        const float dy = py - c0.y;
        const float power = -0.5f * (c0.z * dx * dx + 2.0f * c0.w * dx * dy +
                                     c1.x * dy * dy);
        e[i] = expf(fminf(power, 0.0f));
        const float a = fminf(0.999f, c1.y * e[i]);
        negative |= (power < 0.0f ? 1u : 0u) << i;
        bits |= (__ballot_sync(kFullWarp, a >= kAlphaEps) ? 1u : 0u) << i;
      }
      reached |= bits << (grp * kGroup);
      if (bits == 0) continue;
      // the serial part, last candidate first, only where the warp is live
#pragma unroll
      for (int i = kGroup - 1; i >= 0; --i) {
        if (!(bits & (1u << i))) continue;
        const int k = k0 + i;
        const float* c = sc + k * kStageRows;
        const float4 c0 = *reinterpret_cast<const float4*>(c);
        const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
        const float4 c2 = *reinterpret_cast<const float4*>(c + 8);
        const float dx = px - c0.x;
        const float dy = py - c0.y;
        const float ca = c0.z, cb = c0.w, cc = c1.x;
        const float a_pre = c1.y * e[i];
        const float a = fminf(0.999f, a_pre);
        float g[kGradRows];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) g[r] = 0.f;
        if (a >= kAlphaEps) {
          const float log1m = log1pf(-a);
          const float tr = in_img ? expf(total - suffix - log1m) : 0.0f;
          const float w = a * tr;
          const float s = v[0] * c1.z + v[1] * c1.w + v[2] * c2.x +
                          v[3] * c2.y + v[4] * c2.z;
          const float da =
              a_pre < 0.999f ? tr * s - s_after / (1.0f - a) : 0.0f;
          const float dpow = (negative >> i) & 1u ? da * a : 0.0f;
          g[0] = dpow * (ca * dx + cb * dy);
          g[1] = dpow * (cb * dx + cc * dy);
          g[2] = dpow * (-0.5f * dx * dx);
          g[3] = dpow * (-dx * dy);
          g[4] = dpow * (-0.5f * dy * dy);
          g[5] = da * e[i];
          g[6] = v[0] * w;
          g[7] = v[1] * w;
          g[8] = v[2] * w;
          g[9] = v[3] * w;
          suffix += log1m;
          s_after += w * s;
        }
        const float sum = reduce_rows(g, lane);
        if (row >= 0) slab[k * kGradRows + row] = sum;
      }
    }
    if (lane == 0) mask[word] = reached;
  }
}

// Add the warps' slabs of one chunk in warp order, a slab only where its
// warp reached the candidate, and write the chunk's kChunk gradient rows
// whole (columns kGradRows.. are zeros): thread pairs take a row, one its
// first eight columns, the other the rest.
__device__ __forceinline__ void store_chunk_grads(float* dst,
                                                  const float* slabs,
                                                  const unsigned* masks,
                                                  int n_warps, int p,
                                                  int n_pix) {
  for (int i = p; i < 2 * kChunk; i += n_pix) {
    const int k = i >> 1;
    const int col0 = (i & 1) * 8;
    const int n_cols = (i & 1) ? kGradRows - 8 : 8;
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    for (int wp = 0; wp < n_warps; ++wp) {
      if (!((masks[wp * 4 + (k >> 5)] >> (k & 31)) & 1u)) continue;
      const float* s = slabs + (wp * kChunk + k) * kGradRows + col0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < n_cols) acc[r] += s[r];
      }
    }
    float4* out = reinterpret_cast<float4*>(dst + k * kRows + col0);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// The reverse walk of one tile by its block (one thread per pixel): `used`
// chunks, the last at cand_last and each earlier one kChunk rows before it,
// gradient rows to the same places of dcand. `total` is the forward's
// log-transmittance of the pixel over those chunks, v its cotangents of
// rgb, depth_acc, alpha. `used` is the same for all threads of the block.
__device__ __forceinline__ void backprop_tile(const float* cand_last,
                                              float* dcand_last, int used,
                                              float px, float py, bool in_img,
                                              float total,
                                              const float (&v)[5]) {
  extern __shared__ __align__(16) float bwd_smem[];
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = n_pix >> 5;
  const int row = grad_row(lane);
  constexpr int kStage = kChunk * kStageRows;
  constexpr int kSlab = kChunk * kGradRows;
  constexpr size_t kStep = static_cast<size_t>(kChunk) * kRows;
  float* stage = bwd_smem;
  float* slabs = bwd_smem + 2 * kStage;
  unsigned* masks = reinterpret_cast<unsigned*>(slabs + n_warps * kSlab);

  float suffix = 0.f;   // sum log(1 - a) over later candidates
  float s_after = 0.f;  // sum w s over later candidates
  if (used > 0) prefetch_chunk(stage, cand_last, p, n_pix);
  for (int j = 0; j < used; ++j) {
    wait_prefetch();
    // chunk j has landed for everyone, and everyone is done with chunk
    // j-1: its staging buffer and the slabs are free again
    __syncthreads();
    if (j + 1 < used) {
      prefetch_chunk(stage + ((j + 1) & 1) * kStage,
                     cand_last - (j + 1) * kStep, p, n_pix);
    }
    backprop_chunk(stage + (j & 1) * kStage, slabs + warp * kSlab,
                   masks + warp * 4, px, py, in_img, total, v, suffix,
                   s_after, lane, row);
    __syncthreads();  // the slabs and masks of chunk j are complete
    store_chunk_grads(dcand_last - j * kStep, slabs, masks, n_warps, p,
                      n_pix);
  }
}

}  // namespace splat_walk
