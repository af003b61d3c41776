// H4: the transpose of the candidate gather (payload rows -> flat slots or
// top-K list entries), summed in a fixed order, for sm_90a.
//
// Replaces no Pallas kernel: JAX computes this VJP in XLA, as
// _planned_take_sliced (holoscene_tpu/ops/splat_flat.py) with the
// transpose plan of build_flat_bins: a gather of the cotangent by `perm`,
// a two-level cumsum and differences at `bounds`, never a scatter. The
// port's first version was index_select's autograd transpose, an
// index_add whose float atomics sum in no fixed order, so two runs of
// Stage 4 or gs_train from one seed parted in the last bits of the
// gradients. Plain PyTorch twin (the same additions in the same order):
// planned_take_bwd_plain in holoscene_tpu_torch/ops/splat_flat.py.
//
// What it computes. perm [c] holds the slots sorted by payload row (stably,
// so ascending within a row's run) and bounds [n + 2] each row's run in
// perm. For every row s < n and column col < kCols:
//   out[s, col] = ((0 + ct[perm[b], col]) + ct[perm[b + 1], col]) + ...
// over j in [bounds[s], bounds[s + 1]) in ascending j, in float32; columns
// kCols..15 and the trash row n are written as zeros (the walks write no
// gradient there, and the payload drops row n's). No atomics: each output
// value is one thread's sequential sum, so the bits do not change from
// launch to launch and equal the plain twin's.
//
// Bounds on the card. Bytes: every live slot's 64-byte cotangent row and
// its perm entry are read once, bounds once, and the [n + 1, 16] output is
// written once; there are no operations to speak of. What kept the first
// design (a half-warp a row) at 23-41% of that bound is latency: each row
// waited on three dependent loads (bounds, then perm, then the cotangent
// rows), runs are short (~0.8-1.5 live slots a row), so an SM had only
// ~128 rows, ~8 KB, in flight per round trip. And the work is uneven:
// rows with no live slot (73% at a Stage-4 frame, 92% of gs_train's
// capacity) sit beside runs of up to 64 slots, clustered by row index.
//
// Design. A block's share of the work is an equal share of the merge path
// of rows and live slots (row r's header at r + bounds[r]; n + 1 +
// bounds[n] items in all): the rows whose headers lie in its share, found
// by a kThreads-ary search of bounds by the whole block (a probe a thread
// a round; the first round's probes, the same for every block, load
// bounds[n] beside them). So a dense span of rows and a span of empty
// ones cost a block alike. A row's run is never split: the block that
// owns its header sums all of it, in order. The block takes its rows
// kThreads at a time, a thread a row: one coalesced load of bounds gives
// the tile's slot span, contiguous in perm, which is walked in chunks of
// kChunk slots; for each chunk every thread loads the perm entries of its
// slots (coalesced, one chunk ahead of their copies, so no copy waits on
// its index load) and issues three 16-byte cp.async copies a slot
// (columns 0-11) into shared memory, so the whole chunk is in flight at
// once; the chunks are double-buffered (commit / wait groups), chunk k +
// 1's copies in flight while chunk k is summed. Each row's owner adds its
// run's slots from shared memory in ascending order (three float4
// accumulators, carried across chunks; no sum across slots is
// reassociated) and writes its row as four 16-byte stores. The trash
// row's run (every dead slot) is never read. Registers bound the
// occupancy that hides the dependent loads (bounds, the search, perm,
// the rows): builds that kept more of the search in registers (70-96),
// or were capped below 54 and spilled, ran slower despite a round trip or
// two less, and 128-thread blocks with a slot a thread beat 64 and 256
// threads and two slots a thread (utils/take_bench.py on an H100).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRow = 16;     // payload row width (CAND_ROWS), floats
constexpr int kVecs = kRow / 4;   // float4s a row
constexpr int kParts = 3;    // float4s staged a slot: columns 0-11
constexpr int kThreads = 128;   // rows a tile, probes a search round
constexpr int kChunk = kThreads;  // slots a chunk: one a thread
// columns summed: kCols = 11 (BWD_COLS, as JAX's 11): all of parts 0 and 1,
// three of part 2; column 11 is staged (16-byte copies) but not summed

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest complete (this thread's copies)
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// This thread's perm entry of the chunk of slots [lo, hi) (-1 past hi).
__device__ __forceinline__ int load_perm(const int* __restrict__ perm,
                                         int lo, int hi) {
  const int i = lo + static_cast<int>(threadIdx.x);
  return i < hi ? __ldg(perm + i) : -1;
}

// The copies of this thread's slot of a chunk (perm entry src) into buf:
// the chunk's slot i's columns 0-11 at buf[kParts * i ...].
__device__ __forceinline__ void stage_chunk(float4* buf,
                                            const float4* __restrict__ ct,
                                            int src) {
  if (src < 0) return;
  const float4* row = ct + static_cast<int64_t>(src) * kVecs;
  float4* dst = buf + kParts * threadIdx.x;
#pragma unroll
  for (int p = 0; p < kParts; ++p) cp_async16(dst + p, row + p);
}

// Probe k of kThreads over [lo, hi): lo first, evenly spaced, all < hi.
__device__ __forceinline__ int probe(int lo, int hi, int k) {
  return lo + static_cast<int>(static_cast<long long>(hi - lo) * k /
                               kThreads);
}

// [lo, hi] narrowed to the bracket of the first probe at or past the
// target, c probes lying before it.
__device__ __forceinline__ void narrow(int& lo, int& hi, int c) {
  const int next_lo = c > 0 ? probe(lo, hi, c - 1) + 1 : lo;
  hi = c < kThreads ? probe(lo, hi, c) : hi;
  lo = next_lo;
}

// The block's rows: [first, last), the rows r in [0, n] whose headers r +
// bounds[r] lie in its share of the merge path (n + 1 where none lies
// past). Both ends searched at once by the whole block; the first round's
// probes serve both and load bounds[n], which sizes the shares, beside
// them.
__device__ int2 block_rows(const int* __restrict__ bounds, int n) {
  int lo0 = 0, hi0 = n + 1;
  const int q = probe(lo0, hi0, threadIdx.x);
  const long long header = q + static_cast<long long>(__ldg(bounds + q));
  const long long items = n + 1LL + __ldg(bounds + n);
  const long long share = (items + gridDim.x - 1) / gridDim.x;
  const long long d0 = blockIdx.x * share;
  const long long d1 = d0 + share;
  const int c0 = __syncthreads_count(header < d0);
  const int c1 = __syncthreads_count(header < d1);
  int lo1 = lo0, hi1 = hi0;
  narrow(lo0, hi0, c0);
  narrow(lo1, hi1, c1);
  while (lo0 < hi0 || lo1 < hi1) {           // uniform across the block
    const int q0 = probe(lo0, hi0, threadIdx.x);
    const int q1 = probe(lo1, hi1, threadIdx.x);
    const bool before0 = lo0 < hi0 && q0 + static_cast<long long>(
                                          __ldg(bounds + q0)) < d0;
    const bool before1 = lo1 < hi1 && q1 + static_cast<long long>(
                                          __ldg(bounds + q1)) < d1;
    const int b0 = __syncthreads_count(before0);
    const int b1 = __syncthreads_count(before1);
    if (lo0 < hi0) narrow(lo0, hi0, b0);
    if (lo1 < hi1) narrow(lo1, hi1, b1);
  }
  return make_int2(lo0, lo1);
}

constexpr int kBufVecs = kParts * kChunk;   // float4s a chunk buffer

__global__ void __launch_bounds__(kThreads)
planned_take_bwd_kernel(const float4* __restrict__ ct,
                        const int* __restrict__ perm,
                        const int* __restrict__ bounds,
                        float4* __restrict__ out, int n) {
  __shared__ float4 buf[2 * kBufVecs];      // chunk k at buf[(k & 1) ...]
  __shared__ int run[kThreads + 1];         // a tile's bounds
  const int t = threadIdx.x;
  const int2 span = block_rows(bounds, n);
  for (int r0 = span.x; r0 < span.y; r0 += kThreads) {
    const int owned = min(kThreads, span.y - r0);  // rows written
    const int rows = min(owned, n - r0);    // rows summed: not the trash row
    if (t <= rows) run[t] = bounds[r0 + t];
    if (t == 0 && rows == kThreads) run[kThreads] = bounds[r0 + kThreads];
    __syncthreads();
    const int lo = run[0];
    const int hi = run[rows];
    const int mine_lo = t < rows ? run[t] : 0;
    const int mine_hi = t < rows ? run[t + 1] : 0;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a1 = a0;
    float4 a2 = a0;
    if (lo < hi) {                           // uniform across the block
      stage_chunk(buf, ct, load_perm(perm, lo, min(lo + kChunk, hi)));
      cp_async_commit();
      int src = load_perm(perm, lo + kChunk, min(lo + 2 * kChunk, hi));
      int stage = 0;
      for (int c0 = lo; c0 < hi; c0 += kChunk) {
        const int c1 = c0 + kChunk;
        if (c1 < hi) stage_chunk(buf + (stage ^ 1) * kBufVecs, ct, src);
        cp_async_commit();                   // an empty group at the end
        if (c1 + kChunk < hi) {              // the perm one chunk ahead
          src = load_perm(perm, c1 + kChunk, min(c1 + 2 * kChunk, hi));
        }
        cp_async_wait_but_newest();
        __syncthreads();                     // chunk c0 has landed
        const int j0 = max(mine_lo, c0);
        const int j1 = min(mine_hi, c1);
        const float4* s = buf + stage * kBufVecs + kParts * (j0 - c0);
        for (int j = j0; j < j1; ++j, s += kParts) {
          const float4 x = s[0];
          const float4 y = s[1];
          const float4 z = s[2];
          a0.x += x.x; a0.y += x.y; a0.z += x.z; a0.w += x.w;
          a1.x += y.x; a1.y += y.y; a1.z += y.z; a1.w += y.w;
          a2.x += z.x; a2.y += z.y; a2.z += z.z;
        }
        __syncthreads();                     // its buffer free again
        stage ^= 1;
      }
    }
    if (t < owned) {                         // row n: zeros
      float4* o = out + static_cast<int64_t>(r0 + t) * kVecs;
      o[0] = a0;
      o[1] = a1;
      o[2] = make_float4(a2.x, a2.y, a2.z, 0.f);
      o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();                         // run free for the next tile
  }
}

}  // namespace

// ct [c, 16] f32 (16-byte aligned), perm [c] int32, bounds [n + 2] int32,
// out [n + 1, 16] f32 (every value written), on `stream`. Returns
// cudaGetLastError().
extern "C" int planned_take_bwd(const void* ct, const void* perm,
                                const void* bounds, void* out, int n,
                                void* stream) {
  // an eighth more blocks than tiles of rows: a share's rows vary with the
  // local density of live slots and seldom then need a second tile
  const long long rows = n + 1LL;
  const int blocks = static_cast<int>((rows + rows / 8 + kThreads - 1) /
                                      kThreads);
  planned_take_bwd_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ct), static_cast<const int*>(perm),
      static_cast<const int*>(bounds), static_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
