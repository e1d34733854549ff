// Tiled triangle rasterizer: packed z-buffer keys per (candidate pose, tile).
//
// Replaces the Pallas kernel `_rasterize_keys` (orbslam2_nmi_tpu/ops/raster.py:
// 464-508, body `_raster_kernel` :314-461) and computes the function of its
// plain PyTorch version `rasterize_keys_plain` in orbslam2_nmi_torch/ops/raster.py.
//
// For candidate s and 16x128 screen tile t, each of the tile's binned
// triangles is re-projected with the candidate's pose; a pixel is covered when
// all three edge functions are >= 0 and every vertex lies past `near`. The
// z-buffer is a min over two packed int32 keys per pixel,
//     (2^20 - 1 - q(1/z)) * 2^11 + q(u or v),
// so the nearest surface wins and carries its quantized texture coordinate in
// the low 11 bits; SENTINEL (2^31 - 1) marks a pixel that no triangle covers.
// The outputs are key_u and the winners' u, v = (key & 2047) * (1 / 2047).
//
// What bounds it on an H100: by the card's peak rates, bytes. On the main
// path its three [S, tiles, 16, 128] outputs are ~180 MB (54 us at 3.35 TB/s),
// while the coverage tests that the data needs (each live triangle against the
// tile's pixels inside its screen bounding box) number ~3.3e7, a few
// microseconds of f32 operations; chip_smoke.py computes both from its run.
// What sets this kernel's time is the issue rate of the sweep's instructions:
// about 20 a test and 44 more where any lane of a warp is covered (the IEEE
// division, the quantizing, two atomics); the writes overlap it (PERF.md).
//
// Design: one block of 128 threads (4 warps) per (tile, candidate), which
// keeps the tile's two z-buffers (key_u, key_v: int32 [2048] each, 16 KB) in
// shared memory. The block walks its tile's triangle slab [16, capacity] in
// chunks of 128: each thread projects one triangle and sets up its five
// planes (E0, E1, 1/z, u/z, v/z) in the tile-local pixel frame, exactly as
// raster.py:350-392 does, and its screen bounding box grown by one pixel on
// each side and clipped to the tile. It appends the triangle to a
// shared-memory list only if it is valid, in front of `near`, not
// degenerate, and its box is not empty. Then each warp takes the listed
// triangles in turn, and its 32 lanes sweep that triangle's box in blocks of
// 8x4 pixels, testing coverage and folding the two keys of each covered
// pixel into the shared z-buffers with atomicMin. A block lies wholly inside
// or outside a large triangle more often than a run of 32 pixels of a row
// does, so fewer warps take the shading branch with most lanes idle.
//
// Why the result stays bit for bit: a pixel center more than a pixel outside
// the box fails an edge test by far more than f32 rounding, so the box loses
// no covered pixel (tests/test_torch_raster.py checks it on the CPU); the
// minimum is commutative, so the keys equal the plain version's in any
// order. Last, the block writes keys, u and v once each, 16 bytes a thread,
// coalesced. Planes are evaluated in plain f32 as (a*x + b*y) + c; the
// reference's bf16x3 split matrix product was a device of the TPU's matrix
// unit, not part of the function. Built with -fmad=false, every operation
// rounds as in the plain version. The intrinsics are kernel arguments.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kPix = kTileH * kTileW;
constexpr int kChunk = 128;  // triangles set up per pass (one per thread)
constexpr int kThreads = 128;  // = kChunk: every thread sets up a triangle
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7fffffff;
constexpr int kDepthMax = (1 << 20) - 1;
constexpr float kUvMax = 2047.0f;
// u = q * (1/2047): the reference's compiler turned its division by the
// constant into this product, which differs from q / 2047 by an ulp at times
constexpr float kInvUvMax = 1.0f / 2047.0f;

struct Tri {
  float e0a, e0b, e0c, e1a, e1b, e1c, area, zia, zib, zic, uza, uzb, uzc, vza, vzb, vzc;
  int x0, y0, w, h;  // the box grown by a pixel and clipped: first column and row, size
};

struct Projected {
  float sx, sy, z;
};

__device__ __forceinline__ Projected project(const float* m, float X, float Y, float Z,
                                             float fx, float fy, float cx, float cy,
                                             float ox, float oy) {
  const float zc = m[6] * X + m[7] * Y + m[8] * Z + m[11];
  const float zs = fmaxf(zc, 1e-6f);
  const float sx = fx * (m[0] * X + m[1] * Y + m[2] * Z + m[9]) / zs + cx;
  const float sy = fy * (m[3] * X + m[4] * Y + m[5] * Z + m[10]) / zs + cy;
  return {sx - ox, sy - oy, zc};
}

__global__ void __launch_bounds__(kThreads)
rasterize_keys_kernel(const float* __restrict__ tri, const float* __restrict__ poses,
                      int n_tiles, int capacity, int tiles_x, float fx, float fy, float cx,
                      float cy, float near, float qscale, int* __restrict__ keys,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ Tri tris[kChunk];
  __shared__ __align__(16) int key_u[kPix];
  __shared__ __align__(16) int key_v[kPix];
  __shared__ int n_live;
  __shared__ float m[12];

  const int tile = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 12) m[threadIdx.x] = poses[s * 12 + threadIdx.x];
  for (int p = threadIdx.x; p < kPix; p += kThreads) key_u[p] = key_v[p] = kSentinel;
  const float ox = (float)((tile % tiles_x) * kTileW) + 0.5f;
  const float oy = (float)((tile / tiles_x) * kTileH) + 0.5f;
  const float* td = tri + (size_t)tile * 16 * capacity;

  for (int c0 = 0; c0 < capacity; c0 += kChunk) {
    if (threadIdx.x == 0) n_live = 0;
    __syncthreads();
    if (threadIdx.x < kChunk) {
      const int j = c0 + threadIdx.x;
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = td[k * capacity + j];
      const Projected p0 = project(m, d[0], d[1], d[2], fx, fy, cx, cy, ox, oy);
      const Projected p1 = project(m, d[3], d[4], d[5], fx, fy, cx, cy, ox, oy);
      const Projected p2 = project(m, d[6], d[7], d[8], fx, fy, cx, cy, ox, oy);
      bool ok = d[15] > 0.5f && p0.z > near && p1.z > near && p2.z > near;
      // edge i opposite vertex i; orientation fixed via the area's sign
      const float A0 = p1.sy - p2.sy, B0 = p2.sx - p1.sx, C0 = p1.sx * p2.sy - p2.sx * p1.sy;
      const float A1 = p2.sy - p0.sy, B1 = p0.sx - p2.sx, C1 = p2.sx * p0.sy - p0.sx * p2.sy;
      const float A2 = p0.sy - p1.sy, B2 = p1.sx - p0.sx, C2 = p0.sx * p1.sy - p1.sx * p0.sy;
      const float area2 = A0 * p0.sx + B0 * p0.sy + C0;
      ok = ok && fabsf(area2) > 1e-9f;
      // the pixel centers (integer points of the tile-local frame) within a
      // pixel of the triangle's screen bounding box; no other can be covered
      const float xmin = fminf(fminf(p0.sx, p1.sx), p2.sx), xmax = fmaxf(fmaxf(p0.sx, p1.sx), p2.sx);
      const float ymin = fminf(fminf(p0.sy, p1.sy), p2.sy), ymax = fmaxf(fmaxf(p0.sy, p1.sy), p2.sy);
      const float bx0 = fmaxf(ceilf(xmin) - 1.0f, 0.0f);
      const float bx1 = fminf(floorf(xmax) + 1.0f, (float)(kTileW - 1));
      const float by0 = fmaxf(ceilf(ymin) - 1.0f, 0.0f);
      const float by1 = fminf(floorf(ymax) + 1.0f, (float)(kTileH - 1));
      ok = ok && bx0 <= bx1 && by0 <= by1;
      if (ok) {
        const float sgn = area2 >= 0.0f ? 1.0f : -1.0f;
        const float inv = 1.0f / area2;
        const float zi0 = 1.0f / fmaxf(p0.z, 1e-6f);
        const float zi1 = 1.0f / fmaxf(p1.z, 1e-6f);
        const float zi2 = 1.0f / fmaxf(p2.z, 1e-6f);
        const float u0 = d[9] * zi0, u1 = d[11] * zi1, u2 = d[13] * zi2;
        const float v0 = d[10] * zi0, v1 = d[12] * zi1, v2 = d[14] * zi2;
        Tri q;
        q.e0a = A0 * sgn; q.e0b = B0 * sgn; q.e0c = C0 * sgn;
        q.e1a = A1 * sgn; q.e1b = B1 * sgn; q.e1c = C1 * sgn;
        q.area = fabsf(area2);
        q.zia = (A0 * zi0 + A1 * zi1 + A2 * zi2) * inv;
        q.zib = (B0 * zi0 + B1 * zi1 + B2 * zi2) * inv;
        q.zic = (C0 * zi0 + C1 * zi1 + C2 * zi2) * inv;
        q.uza = (A0 * u0 + A1 * u1 + A2 * u2) * inv;
        q.uzb = (B0 * u0 + B1 * u1 + B2 * u2) * inv;
        q.uzc = (C0 * u0 + C1 * u1 + C2 * u2) * inv;
        q.vza = (A0 * v0 + A1 * v1 + A2 * v2) * inv;
        q.vzb = (B0 * v0 + B1 * v1 + B2 * v2) * inv;
        q.vzc = (C0 * v0 + C1 * v1 + C2 * v2) * inv;
        q.x0 = (int)bx0;
        q.y0 = (int)by0;
        q.w = (int)bx1 - q.x0 + 1;
        q.h = (int)by1 - q.y0 + 1;
        tris[atomicAdd(&n_live, 1)] = q;
      }
    }
    __syncthreads();
    const int n = n_live;
    // lane l sweeps pixel (l & 7, l >> 3) of each 8x4 block of the box
    const int lx = lane & 7, ly = lane >> 3;
    for (int t = warp; t < n; t += kWarps) {
      const Tri q = tris[t];
      for (int by = ly; by - ly < q.h; by += 4) {
        for (int bx = lx; bx - lx < q.w; bx += 8) {
          if (by >= q.h || bx >= q.w) continue;
          const int ix = q.x0 + bx, iy = q.y0 + by;
          const float px = (float)ix, py = (float)iy;
          const float e0 = q.e0a * px + q.e0b * py + q.e0c;
          const float e1 = q.e1a * px + q.e1b * py + q.e1c;
          if (e0 >= 0.0f && e1 >= 0.0f && q.area - e0 - e1 >= 0.0f) {
            const float zi = q.zia * px + q.zib * py + q.zic;
            const float uz = q.uza * px + q.uzb * py + q.uzc;
            const float vz = q.vza * px + q.vzb * py + q.vzc;
            const int qd = (int)fminf(fmaxf(zi * qscale, 0.0f), (float)kDepthMax);
            const int dk = (kDepthMax - qd) << 11;
            const float rcp = kUvMax / fmaxf(zi, 1e-12f);
            const int uq = (int)fminf(fmaxf(uz * rcp, 0.0f), kUvMax);
            const int vq = (int)fminf(fmaxf(vz * rcp, 0.0f), kUvMax);
            const int p = iy * kTileW + ix;
            atomicMin(&key_u[p], dk + uq);
            atomicMin(&key_v[p], dk + vq);
          }
        }
      }
    }
    __syncthreads();  // the z-buffers are complete / the next chunk overwrites `tris`
  }

  const size_t base = ((size_t)s * n_tiles + tile) * kPix;
  const int4* ku = reinterpret_cast<const int4*>(key_u);
  const int4* kv = reinterpret_cast<const int4*>(key_v);
#pragma unroll
  for (int k = 0; k < kPix / 4 / kThreads; ++k) {
    const int i4 = threadIdx.x + k * kThreads;
    const int4 a = ku[i4], b = kv[i4];
    reinterpret_cast<int4*>(keys + base)[i4] = a;
    reinterpret_cast<float4*>(u_out + base)[i4] =
        make_float4((float)(a.x & 2047) * kInvUvMax, (float)(a.y & 2047) * kInvUvMax,
                    (float)(a.z & 2047) * kInvUvMax, (float)(a.w & 2047) * kInvUvMax);
    reinterpret_cast<float4*>(v_out + base)[i4] =
        make_float4((float)(b.x & 2047) * kInvUvMax, (float)(b.y & 2047) * kInvUvMax,
                    (float)(b.z & 2047) * kInvUvMax, (float)(b.w & 2047) * kInvUvMax);
  }
}

}  // namespace

extern "C" {

// tri [n_tiles, 16, capacity] f32, poses [S, 12] f32 (R row-major | t);
// keys [S, n_tiles, 16, 128] int32, u and v the same shape in f32 (16-byte
// aligned, as torch.empty gives them).
int nmi_rasterize_keys(const void* tri, const void* poses, int S, int n_tiles, int capacity,
                       int tiles_x, float fx, float fy, float cx, float cy, float near,
                       float qscale, void* keys, void* u, void* v, void* stream) {
  rasterize_keys_kernel<<<dim3(n_tiles, S), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)poses, n_tiles, capacity, tiles_x, fx, fy, cx, cy, near,
      qscale, (int*)keys, (float*)u, (float*)v);
  return (int)cudaGetLastError();
}

}  // extern "C"
