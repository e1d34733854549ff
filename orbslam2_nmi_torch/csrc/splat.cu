// Point splat of render mode 4 (RENDER_POINT_CLOUD): S renders of a point
// cloud, one per translation candidate, z-buffered by a min over packed int32
// keys and widened by a point_size x point_size min-pool.
//
// Replaces no TPU kernel: the JAX package renders this path with XLA ops
// (orbslam2_nmi_tpu/ops/render.py `_splat`: a scatter-min over S x P keys and
// a reduce_window), and the port did the same with torch ops. The two kernels
// compute exactly the function of `splat_keys_plain` and `resolve_keys_plain`
// in orbslam2_nmi_torch/ops/render.py, which the CPU takes.
//
//   splat_scatter_kernel  one thread a point: it reads the point's xyz and
//       gray once, rotates it into the camera frame once, then for each of
//       the S candidates adds the candidate's translation, projects, tests
//       and quantizes, and folds key = zq * 256 + gray8 into the [S, H, W]
//       buffer with atomicMin. A point that fails the test writes nothing.
//   splat_resolve_kernel  one thread an output pixel: the min over the
//       point_size x point_size window (XLA's "SAME" padding: (k - 1) / 2
//       before, the rest after, empty outside), then key % 256 as f32, or the
//       background where no key landed.
//
// Why it stays bit for bit. The rotation is se3.mv_fma's chain: each product
// of two float32 taken in float64 (exact there), added to the running sum in
// float64, and the sum rounded to float32 at each step; fmaf would round once
// where the chain rounds twice, so it is not used. The projection is the
// plain version's f32 operations in its order (fx * x / z + cx, an IEEE
// division), round-half-even to int (__float2int_rn = torch.round, then the
// cast), the depth (z - near) * inv_range * 2^22 truncated and clamped, with
// inv_range the host's f32 reciprocal of far - near. The file is built with
// -fmad=false, so no product and sum are fused. The minimum is order-free, so
// the buffer equals the plain scatter_reduce_("amin") whatever order the
// atomics land in.
//
// What bounds it on an H100. By bytes (what a sweep must move: 16 bytes a
// point read, S f32 renders written) the main path's 27 renders of 2.18 M
// points at 960x540 take ~0.027 ms at 3.35 TB/s; the key buffer adds a 56 MB
// fill, the atomics and the resolve's 56 MB read. By instructions, each of
// the S x P candidates costs two IEEE divisions and ~30 more operations;
// only those that land in view reach an atomic. Points are stored face by
// face, so a warp's lanes land on neighbouring pixels of one render at once
// and its atomics share few L2 lines. Measured (PERF.md): the scatter is
// bound by those instructions (without its atomics it keeps ~70 % of its
// time; a load-and-compare before each atomic saved ~3 %, so it is left
// out), the resolve by its k^2 key loads through L1 (its time grows with k^2).

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;  // the empty key
constexpr int kDepthLevels = 1 << 22;
constexpr int kScatterThreads = 256;
constexpr int kResolveX = 32;
constexpr int kResolveY = 8;

// sum_k r[k] v[k] as se3._fma_dot computes it
__device__ __forceinline__ float fma_chain(const float* r, float x, float y, float z) {
  float acc = (float)((double)r[0] * (double)x);
  acc = (float)((double)r[1] * (double)y + (double)acc);
  return (float)((double)r[2] * (double)z + (double)acc);
}

__global__ void __launch_bounds__(kScatterThreads)
splat_scatter_kernel(const float* __restrict__ points, const float* __restrict__ gray,
                     const float* __restrict__ rot, const float* __restrict__ trans, int P,
                     int S, int H, int W, float fx, float fy, float cx, float cy, float near,
                     float far, float inv_range, int* __restrict__ keys) {
  const int p = blockIdx.x * kScatterThreads + threadIdx.x;
  if (p >= P) return;
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = __ldg(rot + i);
  const float px = points[3 * p], py = points[3 * p + 1], pz = points[3 * p + 2];
  const float rx = fma_chain(r, px, py, pz);
  const float ry = fma_chain(r + 3, px, py, pz);
  const float rz = fma_chain(r + 6, px, py, pz);
  // torch.clamp(gray, 0, 255) cast to int: NaN -> 0 both ways
  const int g8 = (int)fminf(fmaxf(gray[p], 0.0f), 255.0f);
  const long long plane = (long long)H * W;
  for (int s = 0; s < S; ++s) {
    const float x = rx + __ldg(trans + 3 * s);
    const float y = ry + __ldg(trans + 3 * s + 1);
    const float z = rz + __ldg(trans + 3 * s + 2);
    if (!(z > near && z < far)) continue;
    const float zs = z > 1e-6f ? z : 1e-6f;
    const int ui = __float2int_rn(fx * x / zs + cx);
    const int vi = __float2int_rn(fy * y / zs + cy);
    if (ui < 0 || ui >= W || vi < 0 || vi >= H) continue;
    const int zq = min(max((int)((z - near) * inv_range * (float)kDepthLevels), 0),
                       kDepthLevels - 1);
    atomicMin(keys + s * plane + (long long)vi * W + ui, zq * 256 + g8);
  }
}

__global__ void __launch_bounds__(kResolveX * kResolveY)
splat_resolve_kernel(const int* __restrict__ keys, int H, int W, int k, float background,
                     float* __restrict__ out) {
  const int u = blockIdx.x * kResolveX + threadIdx.x;
  const int v = blockIdx.y * kResolveY + threadIdx.y;
  if (u >= W || v >= H) return;
  const long long plane = (long long)blockIdx.z * H * W;
  const int* img = keys + plane;
  const int lo = (k - 1) / 2;
  int m = kBig;
  for (int dv = 0; dv < k; ++dv) {
    const int vv = v - lo + dv;
    if (vv < 0 || vv >= H) continue;
    const int* row = img + (long long)vv * W;
    for (int du = 0; du < k; ++du) {
      const int uu = u - lo + du;
      if (uu >= 0 && uu < W) m = min(m, __ldg(row + uu));
    }
  }
  out[plane + (long long)v * W + u] = m < kBig ? (float)(m & 255) : background;
}

}  // namespace

extern "C" {

// points [P, 3] f32, gray [P] f32, rot [3, 3] f32 (row-major), trans [S, 3]
// f32 (each candidate's t); keys [S, H, W] int32, filled with 2^30 by the
// caller, folded by atomicMin. P > 0 and S > 0 (the caller launches nothing
// for an empty cloud).
int nmi_splat_scatter(const void* points, const void* gray, const void* rot, const void* trans,
                      int P, int S, int H, int W, float fx, float fy, float cx, float cy,
                      float near, float far, float inv_range, void* keys, void* stream) {
  splat_scatter_kernel<<<(P + kScatterThreads - 1) / kScatterThreads, kScatterThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)points, (const float*)gray, (const float*)rot, (const float*)trans, P, S, H,
      W, fx, fy, cx, cy, near, far, inv_range, (int*)keys);
  return (int)cudaGetLastError();
}

// keys [S, H, W] int32; out [S, H, W] f32; point_size >= 1.
int nmi_splat_resolve(const void* keys, int S, int H, int W, int point_size, float background,
                      void* out, void* stream) {
  const dim3 grid((W + kResolveX - 1) / kResolveX, (H + kResolveY - 1) / kResolveY, S);
  splat_resolve_kernel<<<grid, dim3(kResolveX, kResolveY), 0, (cudaStream_t)stream>>>(
      (const int*)keys, H, W, point_size, background, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
