// T1: hit selection of the gaussian ray tracer, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes this as XLA, the
// streaming top-K scan `select_block` inside trace_gaussians
// (holoscene_tpu/ops/gs_trace.py:133-158; 3DGRT, which it stands for, finds
// the hits with an OptiX BVH). Plain PyTorch twin: select_hits_plain in
// holoscene_tpu_torch/ops/gs_trace.py.
//
// What it computes. Ray r has origin o and unit direction d; gaussian g has
// mean mu, opacity op and the canonical transform A = diag(1/s) R^T (row
// major), packed by the wrapper as 13 floats (mu, A, op). In g's unit
// frame the ray is gro = A (o - mu), grdu = A d; with n = max(|grdu|,
// 1e-12), grd = grdu / n, t_proj = -grd . gro and the squared distance of
// the line to the centre gd = |grd x gro|^2 (processHit's form; the JAX
// package writes |gro|^2 - t_proj^2, equal in exact arithmetic but
// cancelling two ~1e9 terms in float32 for a flat particle, scale 1e-4,
// a few units away, so its hit test is noise there), the response is
// exp(s_deg * gd^(deg/2)) (deg 1, 2, 4, 8; s from processHit's particle
// response) and alpha = min(0.99, resp * op). The hit is accepted when
// resp > min_kernel, alpha > min_alpha and t_proj > near, at the world
// distance t = t_proj / n (|R^T d| = 1). Output per ray: the gaussian
// indices of its K accepted hits of least t, ascending, ties to the smaller
// index (int32 [R, K], 0 past the count), and the count (int32 [R]). Every
// float operation is the one the plain version does, in its order (no
// contraction: the library is built with -fmad=false), so the sets are the
// same bits.
//
// Bounds on the card. Per (ray, gaussian) pair 65 float32 operations up
// to the acceptance test (degree 2): operations, not memory (a ray reads
// 24 bytes and writes 4 K + 4, a gaussian 52 bytes a block). The JAX scan
// keeps [R, block] intermediates and a top-K merge a block; a plain PyTorch
// version has to chunk the rays for the same reason. Design (simple on
// purpose): one ray a thread, 128 rays a block; the gaussians streamed
// through shared memory 128 at a time (all threads read the same one: a
// broadcast); a gaussian whose opacity cannot pass min_alpha (dead slots,
// alpha <= op) is skipped by the whole block at once; each thread keeps its
// K best as a sorted buffer in local memory (L1) with insertion. No BVH, no
// culling: every ray tests every gaussian.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 128;     // rays (threads) a block
constexpr int kTile = 128;     // gaussians a shared-memory tile
constexpr int kFloats = 13;    // mu(3), A(9), op
constexpr int kMaxHits = 256;  // largest K the local buffer holds

template <int kDeg>
__device__ __forceinline__ float response(float gd) {
  if (kDeg == 2) return expf(-0.5f * gd);
  if (kDeg == 4) return expf(static_cast<float>(-1.0 / 18.0) * gd * gd);
  if (kDeg == 8) {
    const float gd2 = gd * gd;
    return expf(static_cast<float>(-4.5 / 6561.0) * gd2 * gd2);
  }
  return expf(-1.5f * sqrtf(fmaxf(gd, 1e-20f)));
}

template <int kDeg>
__global__ void __launch_bounds__(kRays)
gs_trace_select_kernel(const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const float* __restrict__ g13, int n_rays,
                       int n_gauss, int k, float min_kernel,
                       float min_alpha, float near, int* __restrict__ idx,
                       int* __restrict__ count) {
  __shared__ float sg[kTile * kFloats];
  const int r = blockIdx.x * kRays + threadIdx.x;
  const bool active = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = rays_o[3 * r];
    oy = rays_o[3 * r + 1];
    oz = rays_o[3 * r + 2];
    dx = rays_d[3 * r];
    dy = rays_d[3 * r + 1];
    dz = rays_d[3 * r + 2];
  }
  float bt[kMaxHits];
  int bi[kMaxHits];
  int cnt = 0;

  for (int base = 0; base < n_gauss; base += kTile) {
    const int nt = min(kTile, n_gauss - base);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * kFloats; i += kRays) {
      sg[i] = g13[static_cast<size_t>(base) * kFloats + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nt; ++j) {
      const float* g = sg + j * kFloats;
      const float op = g[12];
      if (!(op > min_alpha)) continue;   // alpha <= op: never accepted
      const float ocx = ox - g[0];
      const float ocy = oy - g[1];
      const float ocz = oz - g[2];
      const float gx = (g[3] * ocx + g[4] * ocy) + g[5] * ocz;
      const float gy = (g[6] * ocx + g[7] * ocy) + g[8] * ocz;
      const float gz = (g[9] * ocx + g[10] * ocy) + g[11] * ocz;
      const float ux = (g[3] * dx + g[4] * dy) + g[5] * dz;
      const float uy = (g[6] * dx + g[7] * dy) + g[8] * dz;
      const float uz = (g[9] * dx + g[10] * dy) + g[11] * dz;
      const float n = fmaxf(sqrtf((ux * ux + uy * uy) + uz * uz), 1e-12f);
      const float rx = ux / n, ry = uy / n, rz = uz / n;
      const float tp = -((rx * gx + ry * gy) + rz * gz);
      const float cx = ry * gz - rz * gy;
      const float cy = rz * gx - rx * gz;
      const float cz = rx * gy - ry * gx;
      const float gd = (cx * cx + cy * cy) + cz * cz;
      const float resp = response<kDeg>(gd);
      const float alpha = fminf(0.99f, resp * op);
      if (!(resp > min_kernel && alpha > min_alpha && tp > near)) continue;
      const float t = tp / n;
      if (cnt == k && !(t < bt[k - 1])) continue;
      int pos = cnt < k ? cnt : k - 1;
      while (pos > 0 && bt[pos - 1] > t) {   // equal t stays in front
        bt[pos] = bt[pos - 1];
        bi[pos] = bi[pos - 1];
        --pos;
      }
      bt[pos] = t;
      bi[pos] = base + j;
      if (cnt < k) ++cnt;
    }
  }
  if (!active) return;
  int* out = idx + static_cast<size_t>(r) * k;
  for (int i = 0; i < k; ++i) out[i] = i < cnt ? bi[i] : 0;
  count[r] = cnt;
}

template <int kDeg>
int launch(const void* rays_o, const void* rays_d, const void* g13,
           int n_rays, int n_gauss, int k, float min_kernel, float min_alpha,
           float near, void* idx, void* count, void* stream) {
  gs_trace_select_kernel<kDeg>
      <<<(n_rays + kRays - 1) / kRays, kRays, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
          static_cast<const float*>(g13), n_rays, n_gauss, k, min_kernel,
          min_alpha, near, static_cast<int*>(idx), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gs_trace_select(const void* rays_o, const void* rays_d,
                               const void* g13, int n_rays, int n_gauss,
                               int k, float min_kernel, float min_alpha,
                               float near, int degree, void* idx, void* count,
                               void* stream) {
  if (k < 1 || k > kMaxHits || n_rays < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (degree) {
    case 1:
      return launch<1>(rays_o, rays_d, g13, n_rays, n_gauss, k, min_kernel,
                       min_alpha, near, idx, count, stream);
    case 2:
      return launch<2>(rays_o, rays_d, g13, n_rays, n_gauss, k, min_kernel,
                       min_alpha, near, idx, count, stream);
    case 4:
      return launch<4>(rays_o, rays_d, g13, n_rays, n_gauss, k, min_kernel,
                       min_alpha, near, idx, count, stream);
    case 8:
      return launch<8>(rays_o, rays_d, g13, n_rays, n_gauss, k, min_kernel,
                       min_alpha, near, idx, count, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
