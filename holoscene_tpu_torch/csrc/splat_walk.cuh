// Device code shared by the four tile-walk kernels (K1/K2 of the flat
// pipeline, K3/K4 of the top-K pipeline): the staging of a chunk, the
// forward walk of a tile (composite_tile, K1 and K3) and the closed-form
// reverse walk of a tile (backprop_tile, K2 and K4). The kernels differ
// only in where a tile's chunks come from (flat chunk ranges vs. the tile's
// own [K, 16] list), where its pixels lie and how far it walks; the
// arithmetic per (pixel, candidate) is the same and lives here once, so
// that all four round every alpha identically (the build keeps -fmad=false
// for the same reason).
//
// A candidate is a row of 16 floats:
//   x y conic_a conic_b conic_c opacity r g b depth one pad*5.
// One thread owns one pixel; a chunk is staged in shared memory and every
// thread reads the same row at the same time (a broadcast). Both walks
// stage only the 12 floats of a row they read, in two buffers filled by
// cp.async: the copy of the next chunk is requested before the current one
// is worked on.
//
// The forward walk (composite_tile, K1 and K3). On an H100 the walk it
// replaced evaluated, at every pixel, the alpha of all 128 candidates of
// every walked chunk, and that (with staging and barriers) was 75% / 79% of
// K1 / K3; the serial chain of the live ones (exp of the running sum,
// weight, four sums, log1p) the other 25% / 21%. Yet a warp had a live
// lane for only 32% / 23% of (warp, candidate) pairs. What this one does:
//  - a per-warp test before any alpha: each warp takes the 8 x 4 pixel
//    block of fwd_pixel, tests the chunk's 128 candidates against the
//    rectangle of its 32 pixel centres (warp_may_keep, 4 a lane: the
//    binning's Schur bound with a margin for float rounding) and compacts
//    the rows it keeps into a list; it passes 41% / 30% of the pairs.
//  - alphas, log(1 - alpha) and the exps of the running sum before each
//    candidate are taken four candidates at a time as straight-line code,
//    so their latencies overlap; only the running sum and the four
//    accumulations stay serial. The arithmetic and its order are those of
//    the walk this replaced, so its results are the same bits.
//  - the next chunk in flight; the termination vote is the one barrier a
//    chunk.
// What is left is bound by instruction throughput: with the chain out the
// walk keeps two thirds of its time (the kept alphas, the test, the list);
// without the warp test it is 1.5x / 1.8x slower.
//
// The backward walk (backprop_tile, K2 and K4). On an H100 the walk it
// replaces spent 70% of its time summing each candidate's ten gradient
// terms over the tile's pixels: ten five-step shuffle butterflies (16%) and
// ten shared-memory atomicAdds a warp on addresses all warps of the block
// hit together (54%); the alpha test of all 128 candidates was 13%, the
// per-pixel chain 17%. What this one does about it:
//  - no atomics: within a chunk a warp meets a candidate once, so it STORES
//    its ten partial sums in a slab of its own ([32][10] doubles a warp for
//    the 32 candidates of one mask word, two of them in turn, dynamic
//    shared memory) and records in a 128-bit mask which candidates it
//    reached; after each word the block adds the slabs in warp order,
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
//    floats of a row that the walk reads are staged (53 KB of shared
//    memory a 256-thread block with the slabs).

#pragma once

#include <cuda_runtime.h>

namespace splat_walk {

constexpr int kChunk = 128;
constexpr int kRows = 16;
constexpr int kGradRows = 10;  // x y conic(3) opacity rgb depth
constexpr float kTermEps = 1e-4f;
constexpr float kAlphaEps = 1.0f / 255.0f;

constexpr int kStageRows = 12;  // floats of a row that the walks read
constexpr int kStage = kChunk * kStageRows;
constexpr size_t kStep = static_cast<size_t>(kChunk) * kRows;
constexpr int kGroup = 8;       // candidates whose alphas are taken together
constexpr int kFwdGroup = 4;    // the same in the forward walk
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxWarps = 32;  // warps of a 1024-thread block
// slack of the forward walk's per-warp test, in units of d^T conic d:
// absolute, and relative to the size of the quadratic form's terms
constexpr float kCutMargin = 1e-3f;
constexpr float kCutMarginRel = 1e-5f;

// ---------------------------------------------------------------------------
// Staging, shared by all four walks
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The forward walk
// ---------------------------------------------------------------------------

// The pixel (row-major index in the tile) that thread p of a forward block
// composites: warp w takes the 8 x 4 block (w % (ts / 8), w / (ts / 8)) of
// the tile, lane l its pixel (l % 8, l / 8). A block of 8 x 4 pixel centres
// is a smaller target than a 16 x 2 strip: on training frame 0 the warp
// test passes 41% / 30% of (warp, candidate) pairs of the flat / top-K walk
// against 47% / 34% for strips.
__device__ __forceinline__ int fwd_pixel(int p, int tile_size) {
  const int warp = p >> 5;
  const int lane = p & 31;
  const int per_row = tile_size >> 3;
  return ((warp / per_row) * 4 + (lane >> 3)) * tile_size +
         (warp % per_row) * 8 + (lane & 7);
}

// May candidate row c reach alpha >= 1/255 at some pixel centre of the
// rectangle [x_lo, x_hi] x [y_lo, y_hi]? False always for opacity < 1/255
// (alpha <= opacity, exactly), never for a conic that is not positive
// definite (or not a number), and otherwise only where the Schur lower
// bound of d^T conic d over the rectangle (the binning's cull) exceeds
// thr = 2 ln(255 op) by kCutMargin + kCutMarginRel x the size of the terms
// of d^T conic d over the rectangle: that slack covers the float32
// rounding of a pixel's power, its expf and the product with the opacity,
// so a rejected candidate is one the walk skips at every pixel anyway.
// The determinant and the comparison are taken in double (the products of
// floats are exact there). Plain mirror: ops/splat_flat.py
// warp_may_keep_plain.
__device__ __forceinline__ bool warp_may_keep(const float* c, float x_lo,
                                              float x_hi, float y_lo,
                                              float y_hi) {
  const float4 c0 = *reinterpret_cast<const float4*>(c);
  const float2 c1 = *reinterpret_cast<const float2*>(c + 4);
  const float gx = c0.x, gy = c0.y, ca = c0.z, cb = c0.w, cc = c1.x;
  const float op = c1.y;
  if (op < kAlphaEps) return false;
  const double det = static_cast<double>(ca) * static_cast<double>(cc) -
                     static_cast<double>(cb) * static_cast<double>(cb);
  const double dxm = fmaxf(fmaxf(x_lo - gx, gx - x_hi), 0.0f);
  const double dym = fmaxf(fmaxf(y_lo - gy, gy - y_hi), 0.0f);
  const float ax = fmaxf(fabsf(x_lo - gx), fabsf(x_hi - gx));
  const float ay = fmaxf(fabsf(y_lo - gy), fabsf(y_hi - gy));
  const float spread =
      ca * ax * ax + 2.0f * fabsf(cb) * ax * ay + cc * ay * ay;
  const double limit = 2.0f * logf(255.0f * op) + kCutMargin +
                       kCutMarginRel * spread;
  const bool far = det * dxm * dxm > static_cast<double>(cc) * limit ||
                   det * dym * dym > static_cast<double>(ca) * limit;
  const bool definite = ca > 0.0f && cc > 0.0f && det > 0.0;
  return !(definite && far);
}

// Front-to-back compositing of the staged chunk sc [kChunk][kStageRows] by
// one warp at its lanes' pixels (px, py), whose transmittance at chunk
// entry is `trans`, over the n candidates of `list` (their rows in the
// chunk, ascending: those the warp test kept): adds to the accumulators
// and returns the chunk's sum of log(1 - alpha). The candidates are taken
// kFwdGroup at a time. Their alphas, their log(1 - alpha) and the exps of
// the running sum before each are independent of each other, so they are
// written as straight-line code whose latencies overlap; only the running
// sum itself and the four accumulations are serial, in candidate order. A
// group no lane keeps is skipped after its alphas. The arithmetic is that
// of the plain versions and of the walk this replaced, which visited all
// 128 rows, and so are the results, to the bit.
__device__ __forceinline__ float composite_chunk(const float* sc,
                                                 const unsigned char* list,
                                                 int n, float px, float py,
                                                 float trans, float& acc_r,
                                                 float& acc_g, float& acc_b,
                                                 float& acc_z) {
  float cum = 0.f;  // sum log(1 - alpha) of this chunk's earlier rows
  for (int g = 0; g < n; g += kFwdGroup) {
    // the group's rows, four to a word of the list; a slot past the last
    // candidate reads whatever row its byte names and takes alpha 0
    const unsigned* words = reinterpret_cast<const unsigned*>(list + g);
    int row[kFwdGroup];
    float a[kFwdGroup];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kFwdGroup; ++i) {
      row[i] = ((words[i / 4] >> (8 * (i % 4))) & (kChunk - 1)) * kStageRows;
      const float* c = sc + row[i];
      const float4 c0 = *reinterpret_cast<const float4*>(c);
      const float2 c1 = *reinterpret_cast<const float2*>(c + 4);
      const float dx = px - c0.x;
      const float dy = py - c0.y;
      const float power = -0.5f * (c0.z * dx * dx + 2.0f * c0.w * dx * dy +
                                   c1.x * dy * dy);
      const float alpha = fminf(0.999f, c1.y * expf(fminf(power, 0.0f)));
      a[i] = g + i < n ? alpha : 0.0f;
      any = any || a[i] >= kAlphaEps;
    }
    if (!__any_sync(kFullWarp, any)) continue;
    float lg[kFwdGroup];
#pragma unroll
    for (int i = 0; i < kFwdGroup; ++i) lg[i] = log1pf(-a[i]);
    float before[kFwdGroup];  // the running sum before each candidate
#pragma unroll
    for (int i = 0; i < kFwdGroup; ++i) {
      before[i] = cum;
      if (a[i] >= kAlphaEps) cum += lg[i];
    }
#pragma unroll
    for (int i = 0; i < kFwdGroup; ++i) {
      const float* c = sc + row[i];
      const float4 c1 = *reinterpret_cast<const float4*>(c + 4);
      const float2 c2 = *reinterpret_cast<const float2*>(c + 8);
      const float w = a[i] * expf(before[i]) * trans;
      if (a[i] >= kAlphaEps) {
        acc_r += w * c1.z;
        acc_g += w * c1.w;
        acc_b += w * c2.x;
        acc_z += w * c2.y;
      }
    }
  }
  return cum;
}

// What the forward walk of a tile leaves at one pixel.
struct FwdPixel {
  float r, g, b, z;  // accumulated colour and depth
  float trans;       // transmittance after the walked chunks
  float tot;         // sum log(1 - alpha) over the walked chunks
  int used;          // chunks walked (the same for the whole block)
  bool live;         // the tile's last vote: some pixel has T > 1e-4
};

// The forward walk of one tile by its block (one thread per pixel, at
// (px, py), fwd_pixel's mapping): up to m chunks, the first at `first` and
// each next one kChunk rows further, front to back, until the chunk after
// which no pixel of the tile has T > 1e-4 (one __syncthreads_or a chunk,
// the only block barrier of the walk). Pixels outside the image start at
// T = 0. Chunk j + 1 is in flight (cp.async, two staging buffers) while
// chunk j is composited; when the vote stops the tile that copy is wasted,
// but stays in bounds (j + 1 < m). Each warp first tests the chunk's 128
// candidates against the rectangle of its 32 pixel centres, 4 a lane, and
// composites only those the test keeps.
__device__ __forceinline__ FwdPixel composite_tile(const float* first, int m,
                                                   float px, float py,
                                                   bool in_img) {
  __shared__ __align__(16) float stage[2 * kStage];
  __shared__ __align__(4) unsigned char lists[kMaxWarps][kChunk];  // kept rows
  const int p = threadIdx.x;
  const int n_pix = blockDim.x;
  const int lane = p & 31;
  unsigned char* list = lists[p >> 5];
  float x_lo = px, x_hi = px, y_lo = py, y_hi = py;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x_lo = fminf(x_lo, __shfl_xor_sync(kFullWarp, x_lo, o));
    x_hi = fmaxf(x_hi, __shfl_xor_sync(kFullWarp, x_hi, o));
    y_lo = fminf(y_lo, __shfl_xor_sync(kFullWarp, y_lo, o));
    y_hi = fmaxf(y_hi, __shfl_xor_sync(kFullWarp, y_hi, o));
  }
  FwdPixel out = {0.f, 0.f, 0.f, 0.f, in_img ? 1.0f : 0.0f, 0.f, 0, false};
  if (m > 0) prefetch_chunk(stage, first, p, n_pix);
  wait_prefetch();
  int live = __syncthreads_or(out.trans > kTermEps);
  while (out.used < m && live) {
    const int j = out.used;
    if (j + 1 < m) {
      prefetch_chunk(stage + ((j + 1) & 1) * kStage, first + (j + 1) * kStep,
                     p, n_pix);
    }
    const float* sc = stage + (j & 1) * kStage;
    // the warp test, 4 candidates a lane: the rows the warp composites
    int n = 0;
#pragma unroll
    for (int word = 0; word < kChunk / 32; ++word) {
      const int k = word * 32 + lane;
      const bool kept =
          warp_may_keep(sc + k * kStageRows, x_lo, x_hi, y_lo, y_hi);
      const unsigned mask = __ballot_sync(kFullWarp, kept);
      if (kept) list[n + __popc(mask & ((1u << lane) - 1u))] = k;
      n += __popc(mask);
    }
    __syncwarp();
    const float cum = composite_chunk(sc, list, n, px, py, out.trans, out.r,
                                      out.g, out.b, out.z);
    out.trans *= expf(cum);
    out.tot += cum;
    ++out.used;
    wait_prefetch();
    // chunk j + 1 has landed for everyone, and everyone is done with chunk j
    live = __syncthreads_or(out.trans > kTermEps);
  }
  out.live = live != 0;
  return out;
}

// ---------------------------------------------------------------------------
// The backward walk
// ---------------------------------------------------------------------------


// The precision of the reverse walk after the alphas: the per-pixel chain
// and the ten gradient terms (term_t), and the terms' sums over the tile
// (sum_t: the warp reduction, the slabs, the sum of the warps' slabs).
// Both are double; the defines build the float variants that
// utils/walk_bench.py --gs_train compares (backprop_chunk says why).
#ifdef SPLAT_BWD_FLOAT_TERMS
using term_t = float;
#else
using term_t = double;
#endif
#ifdef SPLAT_BWD_FLOAT_SUMS
using sum_t = float;
#else
using sum_t = double;
#endif

constexpr int kWord = 32;  // candidates of one mask word, one slab

// Dynamic shared memory of a backward block with n_warps warps, in bytes:
//   stage [2][kChunk][kStageRows] float | slabs [2][n_warps][kWord][kGradRows]
//   sum_t | masks [n_warps][4] unsigned
inline size_t bwd_smem_bytes(int threads) {
  const size_t n_warps = threads / 32;
  return sizeof(float) * 2 * kChunk * kStageRows +
         sizeof(sum_t) * 2 * n_warps * kWord * kGradRows +
         sizeof(unsigned) * n_warps * 4;
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

// Sum each of the ten values over the warp's 32 lanes in 12 shuffles. At
// every step a lane keeps half of what it holds and sends the other half to
// its partner, so the sums end spread over the lanes: the lane with
// grad_row(lane) >= 0 returns that row's sum. The order of the additions is
// fixed by the lane numbers alone.
template <typename T>
__device__ __forceinline__ T reduce_rows(const T (&g)[kGradRows], int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
  T h[5], m[3], n[2];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const T mine = u4 ? g[5 + i] : g[i];
    const T theirs = u4 ? g[i] : g[5 + i];
    h[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T upper = i < 2 ? h[3 + i] : T(0);
    const T mine = u3 ? upper : h[i];
    const T theirs = u3 ? h[i] : upper;
    m[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T upper = i < 1 ? m[2] : T(0);
    const T mine = u2 ? upper : m[i];
    const T theirs = u2 ? m[i] : upper;
    n[i] = mine + __shfl_xor_sync(kFullWarp, theirs, 4);
  }
  const T mine = u1 ? n[1] : n[0];
  const T theirs = u1 ? n[0] : n[1];
  T q = mine + __shfl_xor_sync(kFullWarp, theirs, 2);
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

// Add the warps' slabs of mask word `word` in warp order, a slab only where
// its warp reached the candidate, and write the word's kWord gradient rows
// of the chunk at dst whole (columns kGradRows.. are zeros): thread pairs
// take a row, one its first eight columns, the other the rest.
__device__ __forceinline__ void store_word_grads(float* dst,
                                                 const sum_t* slabs,
                                                 const unsigned* masks,
                                                 int n_warps, int word, int p,
                                                 int n_pix) {
  for (int i = p; i < 2 * kWord; i += n_pix) {
    const int kw = i >> 1;
    const int col0 = (i & 1) * 8;
    const int n_cols = (i & 1) ? kGradRows - 8 : 8;
    sum_t acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = sum_t(0);
    for (int wp = 0; wp < n_warps; ++wp) {
      if (!((masks[wp * 4 + word] >> kw) & 1u)) continue;
      const sum_t* s = slabs + (wp * kWord + kw) * kGradRows + col0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < n_cols) acc[r] += s[r];
      }
    }
    float4* out =
        reinterpret_cast<float4*>(dst + (word * kWord + kw) * kRows + col0);
    out[0] = make_float4(static_cast<float>(acc[0]), static_cast<float>(acc[1]),
                         static_cast<float>(acc[2]), static_cast<float>(acc[3]));
    out[1] = make_float4(static_cast<float>(acc[4]), static_cast<float>(acc[5]),
                         static_cast<float>(acc[6]), static_cast<float>(acc[7]));
  }
}

// Reverse walk of the staged chunk `sc` [kChunk][kStageRows] by the block,
// each warp at its lanes' pixels (px, py): rebuilds
//   log T_k = total - sum_{r >= k} log(1 - a_r)
// from the forward's total and the running `suffix` (never a division by
// 1 - a), carries s_after = sum_{r > k} w_r s_r, and forms
//   dL/da_k = T_k s_k - s_after / (1 - a_k),
// masked to alpha >= 1/255 and a_pre < 0.999 (the clamp), the exponent's
// gradient masked to power < 0. The candidates go a mask word (kWord) at a
// time: for every candidate of the word that some lane keeps the warp's ten
// sums go to its slab of the word [kWord][kGradRows] (`slabs` holds both
// buffers of all warps) and the candidate's bit is set in its mask [4];
// then the block adds the word's slabs into dst, the chunk's gradient rows
// (store_word_grads). Slabs alternate between words, so one barrier a word
// keeps a slab from being written while it is read.
// Both sums are kept as the plain version keeps them: a partial over the
// chunk's later candidates beside the sum over the later chunks, which takes
// the chunk's partial once, at its end. A single running sum over a tile's
// thousands of live candidates rounds far from plain's: on an H100, at
// chip_smoke.py phase 16's frame (tiles of up to 70 chunks), it put K2 up
// to 1.2e-2 off plain.
// Everything after the alpha is taken in double: log(1 - a), the two sums,
// T_k, w, s, dL/da, the ten terms, their sums over the warp and over the
// warps. At chip_smoke.py phase 17's gs_train frame, opaque gaussians
// wider than the view sit in front of the camera with their centres far
// outside it, so a conic gradient sums dpow * dx^2 with dx of hundreds of
// pixels over the tile, and the sum cancels: with a float32 chain K2 was
// 41.2 off plain's float64 sums (float32 plain 20.1 off); with the chain
// in double and the terms and sums in float, one value of ~133 was still
// 0.665 off (its tolerance 5e-4 + 5e-3 |exact| = 0.666) in one run of
// seven. utils/walk_bench.py --gs_train measures each float variant at
// that frame; on an H100 80GB HBM3 at 700 W, at two such frames, K2's
// worst value as a share of its tolerance: 0.66 / 0.35 with the terms and
// sums in float (SPLAT_BWD_FLOAT_TERMS + _SUMS), 0.57 / 0.30 with only
// the terms in float (they and log1pf carry most of it), 0.05 / 0.17 with
// only the sums in float, 0.0000 with neither. The double walk costs K2 0.48
// -> 0.77 ms at that frame and 0.51 -> 0.93 ms at chip_smoke.py phase 8's.
__device__ __forceinline__ void backprop_chunk(const float* sc, float* dst,
                                               sum_t* slabs, unsigned* masks,
                                               float px, float py,
                                               bool in_img, float total,
                                               const float (&v)[5],
                                               double& suffix,
                                               double& s_after, int p,
                                               int n_pix) {
  const int lane = p & 31, warp = p >> 5, n_warps = n_pix >> 5;
  const int row = grad_row(lane);
  // log T before this chunk's candidates
  const double head = static_cast<double>(total) - suffix;
  double part = 0.0;    // sum log(1 - a), later in the chunk
  double s_part = 0.0;  // sum w s, later in the chunk
  for (int word = kChunk / kWord - 1; word >= 0; --word) {
    sum_t* buf = slabs + (word & 1) * n_warps * kWord * kGradRows;
    sum_t* slab = buf + warp * kWord * kGradRows;
    unsigned reached = 0;  // bit k % 32: some lane keeps candidate k
    for (int grp = kWord / kGroup - 1; grp >= 0; --grp) {
      const int k0 = word * kWord + grp * kGroup;
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
        const term_t dx = px - c0.x;
        const term_t dy = py - c0.y;
        const term_t ca = c0.z, cb = c0.w, cc = c1.x;
        const float a_pre = c1.y * e[i];
        const float a = fminf(0.999f, a_pre);
        term_t g[kGradRows];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) g[r] = term_t(0);
        if (a >= kAlphaEps) {
          const double ad = a;
#ifdef SPLAT_BWD_FLOAT_TERMS
          const double incl = part + static_cast<double>(log1pf(-a));
#else
          const double incl = part + log1p(-ad);
#endif
          const double tr = in_img ? exp(head - incl) : 0.0;
          const double w = ad * tr;
          const double s = static_cast<double>(v[0]) * c1.z +
                           static_cast<double>(v[1]) * c1.w +
                           static_cast<double>(v[2]) * c2.x +
                           static_cast<double>(v[3]) * c2.y +
                           static_cast<double>(v[4]) * c2.z;
          const double da = a_pre < 0.999f
                                ? tr * s - (s_part + s_after) / (1.0 - ad)
                                : 0.0;
          const term_t dpow = (negative >> i) & 1u
                                  ? static_cast<term_t>(da * ad)
                                  : term_t(0);
          g[0] = dpow * (ca * dx + cb * dy);
          g[1] = dpow * (cb * dx + cc * dy);
          g[2] = dpow * (term_t(-0.5) * dx * dx);
          g[3] = dpow * (-dx * dy);
          g[4] = dpow * (term_t(-0.5) * dy * dy);
          g[5] = static_cast<term_t>(da * e[i]);
          g[6] = static_cast<term_t>(v[0] * w);
          g[7] = static_cast<term_t>(v[1] * w);
          g[8] = static_cast<term_t>(v[2] * w);
          g[9] = static_cast<term_t>(v[3] * w);
          part = incl;
          s_part += w * s;
        }
        sum_t gs[kGradRows];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) gs[r] = static_cast<sum_t>(g[r]);
        const sum_t sum = reduce_rows(gs, lane);
        if (row >= 0) slab[(k - word * kWord) * kGradRows + row] = sum;
      }
    }
    if (lane == 0) masks[warp * 4 + word] = reached;
    __syncthreads();  // the word's slabs and masks are complete
    store_word_grads(dst, buf, masks, n_warps, word, p, n_pix);
  }
  suffix += part;
  s_after += s_part;
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
  const int n_warps = n_pix >> 5;
  float* stage = bwd_smem;
  sum_t* slabs = reinterpret_cast<sum_t*>(bwd_smem + 2 * kStage);
  unsigned* masks =
      reinterpret_cast<unsigned*>(slabs + 2 * n_warps * kWord * kGradRows);

  double suffix = 0.0;   // sum log(1 - a) over later candidates
  double s_after = 0.0;  // sum w s over later candidates
  if (used > 0) prefetch_chunk(stage, cand_last, p, n_pix);
  for (int j = 0; j < used; ++j) {
    wait_prefetch();
    // chunk j has landed for everyone, and everyone is done with chunk
    // j-1: its staging buffer is free again
    __syncthreads();
    if (j + 1 < used) {
      prefetch_chunk(stage + ((j + 1) & 1) * kStage,
                     cand_last - (j + 1) * kStep, p, n_pix);
    }
    backprop_chunk(stage + (j & 1) * kStage, dcand_last - j * kStep, slabs,
                   masks, px, py, in_img, total, v, suffix, s_after, p,
                   n_pix);
  }
}

}  // namespace splat_walk
