// T1: hit selection of the gaussian ray tracer, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes this as XLA, the
// streaming top-K scan `select_block` inside trace_gaussians
// (holoscene_tpu/ops/gs_trace.py:133-158; 3DGRT, which it stands for, finds
// the hits with an OptiX BVH). Plain PyTorch twin: select_hits_plain in
// holoscene_tpu_torch/ops/gs_trace.py; plain mirror of the cull:
// cull_spheres / ray_bundles / bundle_survivors there.
//
// What it computes. Ray r has origin o and unit direction d; gaussian g has
// mean mu, opacity op and the canonical transform A = diag(1/s) R^T (row
// major), packed by the wrapper as 13 floats (mu, A, op). In g's unit
// frame the ray is gro = A (o - mu), grdu = A d; with n = max(|grdu|,
// 1e-12), grd = grdu / n, t_proj = -grd . gro and the squared distance of
// the line to the centre gd = |grd x gro|^2 (processHit's form; the JAX
// package writes |gro|^2 - t_proj^2, equal in exact arithmetic but
// cancelling two ~1e9 terms in float32 for a flat particle), the response
// is exp(s_deg * gd^(deg/2)) (deg 1, 2, 4, 8) and alpha = min(0.99, resp *
// op). The hit is accepted when resp > min_kernel, alpha > min_alpha and
// t_proj > near, at the world distance t = t_proj / n. Output per ray: the
// gaussian indices of its K accepted hits of least t, ascending, ties to
// the smaller index (int32 [R, K], 0 past the count), and the count (int32
// [R]). Every float operation of that test is the one the plain version
// does, in its order (no contraction: the library is built with
// -fmad=false), so the sets are the same bits.
//
// What bounds it. The exact test is 65 float32 operations a (ray,
// gaussian) pair; a ray keeps a few dozen hits of ~10^5 gaussians. The
// kernel's first design tested every pair (5.7e11 operations a 65,536-ray
// launch at phase 17 of chip_smoke.py: 8.5 ms at the card's float32 rate,
// 56.5 ms measured). The work the function needs is the pairs whose ray meets the
// gaussian's bounding sphere, ~10^2 a ray, so the bound is the bytes
// (rays and packed gaussians read once, indices and counts written once;
// the spheres are this design's own intermediate, not counted).
// The bit-exact contract rules out the tensor cores (a TF32 / bf16 product
// of rays x transforms would change the indices): the lever is to run the
// exact test on fewer pairs.
//
// Design: a block of 128 rays (a thread a ray; trace_image hands them over
// as 16 x 8 pixel tiles) in two passes.
//  (a) The block's bundle, reduced in shared memory: the origin of its
//      first ray c and the largest distance ro of an origin from it (0 for
//      one camera), the axis a = the normalised sum of the directions (a
//      fixed tree, the same order as the mirror) and cos T = the least
//      cos(d, a) less 2^-20, at most 1 - 2^-20. The block culls only when
//      near >= 0, every ray is finite with |d| > 0, the sum is not 0 and
//      cos T >= 1/16 (a cone wider than ~86 degrees, e.g. fisheye rays
//      past theta = pi/2 beside forward ones, tests every live gaussian).
//      The cull keeps what the forward cone can meet: an accepted pair has
//      t_proj > near, which puts its nearest point in front of the origin
//      only when near >= 0 (near < 0 accepts gaussians just behind it).
//  (b) The spheres (mu, radius; [N, 4] float32, 16 bytes a gaussian,
//      radius < 0 for a gaussian that can never be accepted) stream
//      through a two-stage shared-memory ring of 768 (cp.async, the next
//      stage loading while this one is tested). A sphere survives when it
//      can touch the cone widened by ro: the sphere of radius rr = radius +
//      ro meets the forward cone (apex c, axis a, half-angle T) only if its
//      centre lies in the cone of the same angle whose apex is moved back
//      by rr / sin T (the cone eroded by rr is the original one) and in the
//      half-space a . (mu - c) >= -rr; both with a slack of 2^-18 (|w| +
//      2 rr / sin T) for this test's own float32 rounding (w = mu - the
//      moved apex; ~20 eps of the same terms). Warp ballots and one shared
//      atomic a warp append the survivors, with their depth a . (mu - c),
//      to a shared list of up to 2048.
//  (c) When the list cannot take another stage (and at the end), the block
//      sorts it by depth (bitonic), gathers 128 survivors at a time into
//      shared memory, and every ray runs the exact test on them in that
//      order. Each thread keeps its K best hits as a sorted buffer of
//      64-bit keys in local memory (t's bits made monotone, the index below
//      them); in depth order a new hit mostly lands near the buffer's end
//      (in index order each one shifts half the buffer). The keys order
//      ties by index, so the K least (t, index) are plain's stable-sort set
//      whatever the order of the list.
//
// The sphere (the wrapper, cull_spheres, in float64, rounded up to
// float32). The test can pass only if resp > thr = max(min_kernel,
// min_alpha / op) (alpha = min(0.99, resp op) > min_alpha, min_alpha <
// 0.99); op <= min_alpha can never pass (radius -1). With expf's error (2
// ulp), the rounding of resp op and of the comparison, an accepted pair has
// |s_n| gd^(n/2) < L = -ln(thr) + 2^-20, so gd < gd_max = (L (1 + 2^-20) /
// |s_n|)^(2/n) in the unit frame. A world distance D from mu is one of at
// least D / s_max there, s_max = ||A^-1|| (bounded by Gershgorin's row sums
// of (A^-1)^T A^-1; A^-1 from the adjugate). The float32 test is the exact
// test of a ray moved by c eps |o - mu|: o - mu (eps), the two 3x3
// products (A^-1 dA, norm <= 9 eps), the normalisation (R diag(eps) R^T),
// the cross product (eps (|r_i g_j| + |r_j g_i|), which maps back to
// ~3 eps |o - mu| in world units), c ~ 30; and t_proj's sign near the
// origin moves the nearest point by <= 3 eps kappa |o - mu| with kappa =
// s_max sigma_max(A), where |o - mu| <= radius then. So radius = s_max
// sqrt(gd_max) (1 + 2^-10 + 2^-19 kappa) + 2^-16 (|mu| + max |o|): every
// pair that the exact test accepts, at a near >= 0, passes the cull (held
// on the CPU by tests/test_torch_gs_trace_cull.py, adversarially at the
// threshold).
//
// Ablation (a trace_bench variant): T1_NO_INSERT keeps the count only, no
// K-buffer insertion (the insertion's share). Other experiments are edited
// copies of this directory, passed to trace_bench as --variant.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 128;                  // rays (threads) a block
constexpr int kWarps = kRays / 32;
constexpr int kStage = 768;                 // spheres a ring stage
constexpr int kPerWarp = kStage / kWarps;   // spheres a warp a stage
constexpr int kBatch = 128;                 // survivors an exact pass
constexpr int kList = 2048;                 // survivors the list holds
static_assert(kPerWarp % 32 == 0 && kBatch <= kList, "T1 sizes");
static_assert((kList & (kList - 1)) == 0 && kList > kStage, "T1 list");
constexpr int kFloats = 13;                 // mu(3), A(9), op
constexpr int kMaxHits = 256;               // largest K the buffer holds
constexpr float kCosSlack = 9.5367431640625e-07f;     // 2^-20
constexpr float kCosMax = 1.f - 9.5367431640625e-07f;
constexpr float kMinCos = 0.0625f;
constexpr float kTol = 3.814697265625e-06f;           // 2^-18
constexpr float kHuge = 1e18f;              // a radius that culls nothing
constexpr float kFar = 3e38f;               // the largest key of a survivor
constexpr float kPad = 3.40282347e38f;      // the key past the list

struct Bundle {
  float cx, cy, cz, ro, ax, ay, az, cos_t, inv_sin;
  bool cull;
};

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

// one 64-bit key ordered as (t, index): t's bits made monotone (+0 for
// -0, which compares equal), the index below them
__device__ __forceinline__ unsigned long long hit_key(float t, int gi) {
  const unsigned tb = __float_as_uint(t + 0.f);
  const unsigned mono = tb ^ ((tb >> 31) ? 0xffffffffu : 0x80000000u);
  return (static_cast<unsigned long long>(mono) << 32) |
         static_cast<unsigned>(gi);
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

// (a): every thread returns the same bundle
__device__ Bundle block_bundle(const float* __restrict__ rays_o, bool active,
                               float ox, float oy, float oz, float dx,
                               float dy, float dz, float near,
                               float (*red)[kRays]) {
  const int tid = threadIdx.x;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * kRays;
  Bundle b;
  b.cx = rays_o[3 * r0];
  b.cy = rays_o[3 * r0 + 1];
  b.cz = rays_o[3 * r0 + 2];
  const float d2n = (dx * dx + dy * dy) + dz * dz;
  const bool ok = !active || (finite3(ox, oy, oz) && isfinite(d2n) &&
                              d2n > 0.f);
  const bool all_ok = __syncthreads_and(ok);
  float e = 0.f;
  if (active) {
    const float ex = ox - b.cx, ey = oy - b.cy, ez = oz - b.cz;
    e = sqrtf((ex * ex + ey * ey) + ez * ez);
  }
  red[0][tid] = active ? dx : 0.f;
  red[1][tid] = active ? dy : 0.f;
  red[2][tid] = active ? dz : 0.f;
  red[3][tid] = e;
  __syncthreads();
  for (int s = kRays / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[0][tid] = red[0][tid] + red[0][tid + s];
      red[1][tid] = red[1][tid] + red[1][tid + s];
      red[2][tid] = red[2][tid] + red[2][tid + s];
      red[3][tid] = fmaxf(red[3][tid], red[3][tid + s]);
    }
    __syncthreads();
  }
  const float sx = red[0][0], sy = red[1][0], sz = red[2][0];
  const float ro = red[3][0];
  const float sn = sqrtf((sx * sx + sy * sy) + sz * sz);
  b.ax = sx / sn;
  b.ay = sy / sn;
  b.az = sz / sn;
  b.ro = ro + ro * kCosSlack;
  __syncthreads();
  red[0][tid] = active ? ((dx * b.ax + dy * b.ay) + dz * b.az) / sqrtf(d2n)
                       : 2.f;
  __syncthreads();
  for (int s = kRays / 2; s > 0; s >>= 1) {
    if (tid < s) red[0][tid] = fminf(red[0][tid], red[0][tid + s]);
    __syncthreads();
  }
  b.cos_t = fminf(red[0][0] - kCosSlack, kCosMax);
  b.inv_sin = 1.f / sqrtf((1.f - b.cos_t) * (1.f + b.cos_t));
  b.cull = all_ok && sn > 0.f && b.cos_t >= kMinCos && near >= 0.f;
  __syncthreads();
  return b;
}

// (b): can a ray of the bundle meet this sphere? `key` is its centre's
// depth along the axis, the order of the exact test
__device__ __forceinline__ bool survives(float4 sp, const Bundle& b,
                                         float& key) {
  const float vx = sp.x - b.cx, vy = sp.y - b.cy, vz = sp.z - b.cz;
  const float va = (vx * b.ax + vy * b.ay) + vz * b.az;
  key = isfinite(va) ? fminf(va, kFar) : kFar;
  const float radius = sp.w;
  if (!(radius >= 0.f)) return false;
  if (!b.cull) return true;
  const float rr = radius + b.ro;
  if (!(rr < kHuge)) return true;
  const float s = rr * b.inv_sin;
  const float wx = vx + s * b.ax, wy = vy + s * b.ay, wz = vz + s * b.az;
  const float wa = (wx * b.ax + wy * b.ay) + wz * b.az;
  const float wn = sqrtf((wx * wx + wy * wy) + wz * wz);
  const float tol = kTol * (wn + 2.f * s);
  return (va + rr) + tol >= 0.f && wa + tol >= b.cos_t * wn;
}

__device__ __forceinline__ void load_stage(float4* dst,
                                           const float4* __restrict__ sph,
                                           int base, int n_gauss) {
  for (int i = threadIdx.x; i < kStage; i += kRays) {
    const int gi = base + i;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    const int bytes = gi < n_gauss ? 16 : 0;   // 0: zero-fill, no read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(sph + (gi < n_gauss ? gi : 0)), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// the list's n entries in ascending key (bitonic, padded to a power of 2)
__device__ void sort_list(float* key, int* gid, int n) {
  int p = 2;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += kRays) key[i] = kPad;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kRays) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const float klo = key[lo], khi = key[hi];
        if ((klo > khi) == ((lo & size) == 0)) {
          key[lo] = khi;
          key[hi] = klo;
          const int g = gid[lo];
          gid[lo] = gid[hi];
          gid[hi] = g;
        }
      }
      __syncthreads();
    }
  }
}

template <int kDeg>
__global__ void __launch_bounds__(kRays)
gs_trace_select_kernel(const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const float* __restrict__ g13,
                       const float4* __restrict__ spheres, int n_rays,
                       int n_gauss, int k, float min_kernel,
                       float min_alpha, float near, int* __restrict__ idx,
                       int* __restrict__ count) {
  extern __shared__ __align__(16) float4 smem[];
  float4* ring = smem;                                   // 2 x kStage
  float* lkey = reinterpret_cast<float*>(ring + 2 * kStage);   // kList
  int* lgid = reinterpret_cast<int*>(lkey + kList);            // kList
  float* sg = reinterpret_cast<float*>(lgid + kList);  // kBatch x kFloats
  __shared__ float red[4][kRays];
  __shared__ int n_list;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * kRays + tid;
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
  const int n_stages = (n_gauss + kStage - 1) / kStage;
  if (n_stages > 0) load_stage(ring, spheres, 0, n_gauss);
  if (tid == 0) n_list = 0;
  const Bundle b = block_bundle(rays_o, active, ox, oy, oz, dx, dy, dz,
                                near, red);

  unsigned long long buf[kMaxHits];   // (t, index) keys, ascending
  int cnt = 0;
  for (int st = 0; st < n_stages; ++st) {
    const bool last = st + 1 == n_stages;
    if (!last) {
      load_stage(ring + ((st + 1) & 1) * kStage, spheres, (st + 1) * kStage,
                 n_gauss);
      wait_stage<1>();
    } else {
      wait_stage<0>();
    }
    __syncthreads();
    // (b) cull this stage: warp w takes its kPerWarp spheres and appends
    // its survivors to the list (in any order: see (c))
    const int base = st * kStage + warp * kPerWarp;
    const float4* mine = ring + (st & 1) * kStage + warp * kPerWarp;
    unsigned keep[kPerWarp / 32];
    float key[kPerWarp / 32];
    int kept = 0;
#pragma unroll
    for (int j = 0; j < kPerWarp / 32; ++j) {
      const int i = j * 32 + lane;
      const bool in = base + i < n_gauss;
      keep[j] = __ballot_sync(
          0xffffffffu, survives(mine[in ? i : 0], b, key[j]) && in);
      kept += __popc(keep[j]);
    }
    int at = 0;
    if (lane == 0 && kept) at = atomicAdd(&n_list, kept);
    at = __shfl_sync(0xffffffffu, at, 0);
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kPerWarp / 32; ++j) {
      if ((keep[j] >> lane) & 1u) {
        const int pos = at + __popc(keep[j] & below);
        lkey[pos] = key[j];
        lgid[pos] = base + j * 32 + lane;
      }
      at += __popc(keep[j]);
    }
    __syncthreads();
    const int n = n_list;
    if (!(last || n > kList - kStage)) continue;
    // (c) the list in ascending depth, then the exact test on it
    sort_list(lkey, lgid, n);
    for (int done = 0; done < n; done += kBatch) {
      const int nb = min(kBatch, n - done);
      for (int i = tid; i < nb * kFloats; i += kRays) {
        const int j = i / kFloats;
        sg[i] = g13[static_cast<size_t>(lgid[done + j]) * kFloats +
                    (i - j * kFloats)];
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < nb; ++j) {
          const float* g = sg + j * kFloats;
          const float op = g[12];
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
          // the K least (t, index): plain's stable sort keeps equal t in
          // index order, and the list is in depth order
          const unsigned long long key = hit_key(tp / n, lgid[done + j]);
          if (cnt == k && !(key < buf[k - 1])) continue;
#ifndef T1_NO_INSERT
          int pos = cnt < k ? cnt : k - 1;
          while (pos > 0 && buf[pos - 1] > key) {
            buf[pos] = buf[pos - 1];
            --pos;
          }
          buf[pos] = key;
#else
          if (cnt < k) buf[cnt] = key;
#endif
          if (cnt < k) ++cnt;
        }
      }
      __syncthreads();
    }
    if (tid == 0) n_list = 0;
    __syncthreads();
  }
  if (!active) return;
  int* out = idx + static_cast<size_t>(r) * k;
  for (int i = 0; i < k; ++i) {
    out[i] = i < cnt ? static_cast<int>(buf[i] & 0xffffffffull) : 0;
  }
  count[r] = cnt;
}

constexpr int kSmemBytes =
    2 * kStage * 16 + kList * 8 + kBatch * kFloats * 4;

template <int kDeg>
int launch(const void* rays_o, const void* rays_d, const void* g13,
           const void* spheres, int n_rays, int n_gauss, int k,
           float min_kernel, float min_alpha, float near, void* idx,
           void* count, void* stream) {
  const cudaError_t st = cudaFuncSetAttribute(
      gs_trace_select_kernel<kDeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (st != cudaSuccess) return static_cast<int>(st);
  gs_trace_select_kernel<kDeg>
      <<<(n_rays + kRays - 1) / kRays, kRays, kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
          static_cast<const float*>(g13), static_cast<const float4*>(spheres),
          n_rays, n_gauss, k, min_kernel, min_alpha, near,
          static_cast<int*>(idx), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gs_trace_select(const void* rays_o, const void* rays_d,
                               const void* g13, const void* spheres,
                               int n_rays, int n_gauss, int k,
                               float min_kernel, float min_alpha, float near,
                               int degree, void* idx, void* count,
                               void* stream) {
  if (k < 1 || k > kMaxHits || n_rays < 1 ||
      reinterpret_cast<size_t>(spheres) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (degree) {
    case 1:
      return launch<1>(rays_o, rays_d, g13, spheres, n_rays, n_gauss, k,
                       min_kernel, min_alpha, near, idx, count, stream);
    case 2:
      return launch<2>(rays_o, rays_d, g13, spheres, n_rays, n_gauss, k,
                       min_kernel, min_alpha, near, idx, count, stream);
    case 4:
      return launch<4>(rays_o, rays_d, g13, spheres, n_rays, n_gauss, k,
                       min_kernel, min_alpha, near, idx, count, stream);
    case 8:
      return launch<8>(rays_o, rays_d, g13, spheres, n_rays, n_gauss, k,
                       min_kernel, min_alpha, near, idx, count, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
