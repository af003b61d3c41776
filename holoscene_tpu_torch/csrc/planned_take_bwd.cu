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
// written once; there are no operations to speak of. Design: a half-warp
// a row, a lane a column (64-byte coalesced row reads and writes); the
// half-warp loads 16 perm entries at a time, one a lane, and hands them
// round by shuffle, so the dependent index loads of a run overlap. The
// trash row's run (every dead slot) is never walked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRow = 16;       // payload row width (CAND_ROWS)
constexpr int kCols = 11;      // columns summed (BWD_COLS, as JAX's 11)
constexpr int kThreads = 256;  // 16 rows a block

__global__ void __launch_bounds__(kThreads)
planned_take_bwd_kernel(const float* __restrict__ ct,
                        const int* __restrict__ perm,
                        const int* __restrict__ bounds,
                        float* __restrict__ out, int n) {
  const int row = blockIdx.x * (kThreads / kRow) + threadIdx.x / kRow;
  const int col = threadIdx.x % kRow;
  if (row > n) return;  // a half-warp leaves whole
  const unsigned half = 0xFFFFu << (threadIdx.x & 16);
  float acc = 0.0f;
  if (row < n) {
    const int begin = bounds[row];
    const int end = bounds[row + 1];
    for (int base = begin; base < end; base += kRow) {
      const int m = min(kRow, end - base);
      const int mine = col < m ? perm[base + col] : 0;
      for (int k = 0; k < m; ++k) {
        const int src = __shfl_sync(half, mine, k, kRow);
        if (col < kCols) {
          acc += ct[static_cast<int64_t>(src) * kRow + col];
        }
      }
    }
  }
  out[static_cast<int64_t>(row) * kRow + col] = acc;
}

}  // namespace

// ct [c, 16] f32, perm [c] int32, bounds [n + 2] int32, out [n + 1, 16]
// f32 (every value written), on `stream`. Returns cudaGetLastError().
extern "C" int planned_take_bwd(const void* ct, const void* perm,
                                const void* bounds, void* out, int n,
                                void* stream) {
  const int per_block = kThreads / kRow;
  const int blocks = (n + 1 + per_block - 1) / per_block;
  planned_take_bwd_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ct), static_cast<const int*>(perm),
      static_cast<const int*>(bounds), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
