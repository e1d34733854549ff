// Tiled triangle rasterizer with two epilogues: packed z-buffer keys, or the
// texture sampled into the gray image.
//
// Replaces three Pallas kernels of orbslam2_nmi_tpu/ops/raster.py:
//   B3  `_rasterize_keys` (:464-508, body `_raster_kernel` :314-461);
//   B4  the whole-texture sampler `_sample_texture_matmul` (:714-734, body
//       `_sample_kernel` :560-612);
//   B5  the windowed sampler `_sample_texture_windowed` (:681-711, body
//       `_sample_window_kernel` :615-666, windows sliced by `_gather_windowsT`
//       :669-678). It equals B4 on every hit pixel by construction (its
//       windows hold every texel a tile's hit pixels read), so indexing the
//       resident texture with global texel indices computes both; the windows
//       are not built.
// One sweep body, `raster_tile`, is instantiated by two kernels:
//   rasterize_keys_kernel  writes key_u and the winners' u, v, each
//       [S, tiles, 16, 128]: the function of `rasterize_keys_plain` in
//       orbslam2_nmi_torch/ops/raster.py (B3's parity surface);
//   render_gray_kernel     samples the texture at each pixel's winning UV and
//       writes the cropped [S, H, W] gray image: the function of
//       `render_gray_plain` (the main path: B3, then B4/B5, then the untiling).
//
// The sweep. For candidate s and 16x128 screen tile t, each of the tile's
// binned triangles is re-projected with the candidate's pose; a pixel is
// covered when all three edge functions are >= 0 and every vertex lies past
// `near`. The z-buffer is a min over two packed int32 keys per pixel,
//     (2^20 - 1 - q(1/z)) * 2^11 + q(u or v),
// so the nearest surface wins and carries its quantized texture coordinate in
// the low 11 bits; SENTINEL (2^31 - 1) marks a pixel that no triangle covers.
// A winner's u, v = (key & 2047) * (1 / 2047).
//
// The sampler. No hit (key_u == SENTINEL) -> `background`; else texel
// coordinates tu = clip(u, 0, 1) * (tw - 1), tv = clip(1 - v, 0, 1) * (th - 1)
// (GL v flip), x0 = clip(floor(tu), 0, tw - 2), y0 likewise, and
//     c_j  = bf16(T[y0, x0+j]) * bf16(1 - ay) + bf16(T[y0+1, x0+j]) * bf16(ay)
//     gray = c_0 * (1 - ax) + c_1 * ax.
// The texels and the two y-weights are rounded to bf16 (round to nearest
// even) because the reference's row-select matrix product took them in bf16
// (raster.py:582,594,638,650); products and sums are f32, each rounded on its
// own (__fmul_rn/__fadd_rn, and the file is built with -fmad=false).
//
// What bounds it on an H100. By the card's peak rates, bytes: the gray
// epilogue reads the triangle slab, the poses and the texture once and writes
// S*H*W floats (~58 MB on the main path, ~17 us at 3.35 TB/s); the keys
// epilogue writes three [S, tiles, 16, 128] arrays (~180 MB). The coverage
// tests that the data needs (each live triangle against the tile's pixels
// inside its screen bounding box) number ~3.3e7, a few microseconds of f32
// operations; chip_smoke.py computes both from its run. What sets the time is
// the issue rate of the sweep's instructions: about 20 a test and 44 more
// where any lane of a warp is covered (the IEEE division, the quantizing, two
// atomics); the writes overlap it (PERF.md).
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
// The epilogues read the finished z-buffers from shared memory. The keys
// epilogue writes keys, u and v once each, 16 bytes a thread, coalesced. The
// gray epilogue gives thread c column c of the tile: it decodes each row's
// u and v as the keys epilogue does, reads the four taps of the texture
// (256 KB to 1 MB, resident in L2) through the read-only path, and writes the
// pixel straight into the image, so a warp stores 32 consecutive floats of a
// row; rows past H and columns past W (the padded last tiles) are not
// written. The keys, u and v never leave the SM, which saves the 180 MB that
// the separate sampler read back and its tiled gray's second pass.
//
// Why the result stays bit for bit: a pixel center more than a pixel outside
// the box fails an edge test by far more than f32 rounding, so the box loses
// no covered pixel (tests/test_torch_raster.py checks it on the CPU); the
// minimum is commutative, so the keys equal the plain version's in any
// order. Planes are evaluated in plain f32 as (a*x + b*y) + c; the
// reference's bf16x3 split matrix product was a device of the TPU's matrix
// unit, not part of the function. Built with -fmad=false, every operation
// rounds as in the plain version. The intrinsics are kernel arguments.

#include <cuda_bf16.h>
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

// B3's parity surface: key_u and the winners' u, v, each [S, n_tiles, 16, 128]
struct KeysOut {
  int* keys;
  float* u;
  float* v;
};

// The main path: the texture [*, tex_stride] (true size th x tw) sampled into
// the gray image [S, H, W]
struct GrayOut {
  const float* tex;
  int tex_stride, th, tw;
  float background;
  int H, W;
  float* gray;
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

__device__ __forceinline__ float decode_uv(int key) { return (float)(key & 2047) * kInvUvMax; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the bilinear tap of one hit pixel, in the plain version's operation order
__device__ __forceinline__ float sample(const GrayOut& o, float u, float v) {
  const float tu = __fmul_rn(fminf(fmaxf(u, 0.0f), 1.0f), (float)(o.tw - 1));
  const float tv = __fmul_rn(fminf(fmaxf(__fsub_rn(1.0f, v), 0.0f), 1.0f), (float)(o.th - 1));
  const float x0f = fminf(fmaxf(floorf(tu), 0.0f), (float)(o.tw - 2));
  const float y0f = fminf(fmaxf(floorf(tv), 0.0f), (float)(o.th - 2));
  const float ax = __fsub_rn(tu, x0f);
  const float ay = __fsub_rn(tv, y0f);
  const float* row0 = o.tex + (size_t)(int)y0f * o.tex_stride + (int)x0f;
  const float* row1 = row0 + o.tex_stride;
  const float w0 = bf16_round(__fsub_rn(1.0f, ay));
  const float w1 = bf16_round(ay);
  const float c0 = __fadd_rn(__fmul_rn(bf16_round(__ldg(row0)), w0),
                             __fmul_rn(bf16_round(__ldg(row1)), w1));
  const float c1 = __fadd_rn(__fmul_rn(bf16_round(__ldg(row0 + 1)), w0),
                             __fmul_rn(bf16_round(__ldg(row1 + 1)), w1));
  return __fadd_rn(__fmul_rn(c0, __fsub_rn(1.0f, ax)), __fmul_rn(c1, ax));
}

__device__ __forceinline__ void write_out(const KeysOut& o, const int* key_u, const int* key_v,
                                          int tile, int s, int n_tiles, int tiles_x) {
  const size_t base = ((size_t)s * n_tiles + tile) * kPix;
  const int4* ku = reinterpret_cast<const int4*>(key_u);
  const int4* kv = reinterpret_cast<const int4*>(key_v);
#pragma unroll
  for (int k = 0; k < kPix / 4 / kThreads; ++k) {
    const int i4 = threadIdx.x + k * kThreads;
    const int4 a = ku[i4], b = kv[i4];
    reinterpret_cast<int4*>(o.keys + base)[i4] = a;
    reinterpret_cast<float4*>(o.u + base)[i4] =
        make_float4(decode_uv(a.x), decode_uv(a.y), decode_uv(a.z), decode_uv(a.w));
    reinterpret_cast<float4*>(o.v + base)[i4] =
        make_float4(decode_uv(b.x), decode_uv(b.y), decode_uv(b.z), decode_uv(b.w));
  }
}

__device__ __forceinline__ void write_out(const GrayOut& o, const int* key_u, const int* key_v,
                                          int tile, int s, int n_tiles, int tiles_x) {
  const int x = (tile % tiles_x) * kTileW + threadIdx.x;
  const int y0 = (tile / tiles_x) * kTileH;
  if (x >= o.W) return;  // a column of the padded last tile
  const int rows = min(kTileH, o.H - y0);
  float* dst = o.gray + ((size_t)s * o.H + y0) * o.W + x;
#pragma unroll 4
  for (int iy = 0; iy < rows; ++iy) {
    const int p = iy * kTileW + threadIdx.x;
    const int ku = key_u[p];
    dst[(size_t)iy * o.W] =
        ku == kSentinel ? o.background : sample(o, decode_uv(ku), decode_uv(key_v[p]));
  }
}

template <class Out>
__device__ __forceinline__ void raster_tile(const float* __restrict__ tri,
                                            const float* __restrict__ poses, int n_tiles,
                                            int capacity, int tiles_x, float fx, float fy,
                                            float cx, float cy, float near, float qscale,
                                            const Out& out) {
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
  write_out(out, key_u, key_v, tile, s, n_tiles, tiles_x);
}

__global__ void __launch_bounds__(kThreads)
rasterize_keys_kernel(const float* __restrict__ tri, const float* __restrict__ poses,
                      int n_tiles, int capacity, int tiles_x, float fx, float fy, float cx,
                      float cy, float near, float qscale, KeysOut out) {
  raster_tile(tri, poses, n_tiles, capacity, tiles_x, fx, fy, cx, cy, near, qscale, out);
}

__global__ void __launch_bounds__(kThreads)
render_gray_kernel(const float* __restrict__ tri, const float* __restrict__ poses, int n_tiles,
                   int capacity, int tiles_x, float fx, float fy, float cx, float cy, float near,
                   float qscale, GrayOut out) {
  raster_tile(tri, poses, n_tiles, capacity, tiles_x, fx, fy, cx, cy, near, qscale, out);
}

// ---------------------------------------------------------------------------
// The binning: the per-tile triangle lists and the [tiles, 16, capacity] slab
// that the sweep above reads, built on the card.
//
// No TPU kernel stood behind it: the JAX package binned on the host in numpy
// (orbslam2_nmi_tpu/ops/raster.py `bin_mesh`), and so does the port's plain
// version (orbslam2_nmi_torch/ops/raster.py `bin_mesh` with a host device),
// which these two kernels reproduce bit for bit:
//   bin_count_kernel  one thread per face: projects its three vertices at the
//       centre pose in float64 (the vertices are float32, converted exactly),
//       applies the near/far cull, the per-axis margins and the screen cull
//       with the host's formulas in the host's operation order, writes the
//       face's tile span (origin and size; 0 x 0 when culled) and adds it to
//       every tile it covers. The atomics' old values give the largest count
//       and the entries past MAX_CAPACITY (the overflow, which does not
//       depend on the capacity: capacity < MAX_CAPACITY only when no tile
//       holds more); warp reductions give the largest span. The host reads
//       back those four ints and sizes the slab by its own rule.
//   bin_fill_kernel   one block per tile: walks the faces in id order twice.
//       The host's lists come from (face, tile) pairs emitted pass by pass
//       over the span offsets (dy, dx), faces in id order within a pass, then
//       a stable sort by tile, so a tile's list is ordered by (dy, dx, face
//       id). The first walk counts the tile's faces per pass and a prefix sum
//       gives each pass its first slot; the second walk compacts each chunk's
//       matches in id order and gives every match its pass's next slot. Slots
//       past the capacity are dropped, as the host drops them. The block
//       writes each kept face's slab column straight from the resident
//       vertices, UVs and faces, and fills the empty slots as the host does
//       (face 0's vertices and UVs, the valid row 0, id 0).
// The projection takes the host's fused multiply-adds: numpy's float64 matrix
// product (OpenBLAS) accumulates v0 r0, then fma(v1, r1, .), then
// fma(v2, r2, .), and the translation after. Every other operation is one
// IEEE operation as in numpy (-fmad=false; float64 division is correctly
// rounded on the card).
//
// What bounds it. The count kernel reads each face's three vertices (~1.7 MB
// for the 71,442-face prior) and does ~200 float64 operations a face; the
// fill kernel's walks read the 8-byte spans once per tile twice (~310 MB from
// L2 at 272 tiles, 960x540) and write the slab (n_tiles * 16 * capacity
// floats, ~9 MB at capacity 512). The walks set its time; a per-tile walk
// keeps it free of a global sort and of atomics on the lists.

constexpr int kMaxCapacity = 2048;  // ops/raster.py MAX_CAPACITY
constexpr int kCountThreads = 256;
constexpr int kFillThreads = 512;
constexpr int kFillWarps = kFillThreads / 32;
constexpr int kBinParams = 21;

// The pose and intrinsics of one binning, in float64 as the host computes
struct BinParams {
  double r[9];  // R of the centre Tcw, row-major
  double t[3];
  double fx, fy, cx, cy;
  double near, far;
  double off[3];  // |max_offset| per camera axis
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp_tile(long long t, int n) {
  return (int)(t < 0 ? 0 : (t > n - 1 ? n - 1 : t));
}

__global__ void __launch_bounds__(kCountThreads)
bin_count_kernel(const float* __restrict__ verts, const int* __restrict__ faces, int n_faces,
                 BinParams p, int height, int width, int tiles_y, int tiles_x,
                 int2* __restrict__ spans, int* __restrict__ counts, int* __restrict__ record) {
  const int f = blockIdx.x * kCountThreads + threadIdx.x;
  int sx = 0, sy = 0, top = 0, over = 0;
  if (f < n_faces) {
    double u[3], v[3], z[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* x = verts + 3 * (size_t)faces[3 * (size_t)f + k];
      const double X = x[0], Y = x[1], Z = x[2];
      double pc[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        pc[j] = fma(Z, p.r[3 * j + 2], fma(Y, p.r[3 * j + 1], X * p.r[3 * j])) + p.t[j];
      z[k] = pc[2];
      const double zs = pc[2] > 1e-6 ? pc[2] : 1e-6;
      u[k] = p.fx * pc[0] / zs + p.cx;
      v[k] = p.fy * pc[1] / zs + p.cy;
    }
    int tx_lo = 0, ty_lo = 0;
    const double zmn = fmin(fmin(z[0], z[1]), z[2]);
    if (zmn > p.near && zmn < p.far) {
      const double zmin = fmax(zmn, 1e-3);
      const double z_after = fmax(zmin - p.off[2], 0.5 * zmin);
      const double radial = p.off[2] / z_after;
      const double du = fmax(fmax(fabs(u[0] - p.cx), fabs(u[1] - p.cx)), fabs(u[2] - p.cx));
      const double dv = fmax(fmax(fabs(v[0] - p.cy), fabs(v[1] - p.cy)), fabs(v[2] - p.cy));
      const double mx = 2.0 + p.fx * p.off[0] / z_after + du * radial;
      const double my = 2.0 + p.fy * p.off[1] / z_after + dv * radial;
      const long long x_lo = (long long)floor(fmin(fmin(u[0], u[1]), u[2]) - mx);
      const long long x_hi = (long long)ceil(fmax(fmax(u[0], u[1]), u[2]) + mx);
      const long long y_lo = (long long)floor(fmin(fmin(v[0], v[1]), v[2]) - my);
      const long long y_hi = (long long)ceil(fmax(fmax(v[0], v[1]), v[2]) + my);
      if (x_hi >= 0 && x_lo < width && y_hi >= 0 && y_lo < height) {
        tx_lo = clamp_tile(floor_div(x_lo, kTileW), tiles_x);
        ty_lo = clamp_tile(floor_div(y_lo, kTileH), tiles_y);
        sx = clamp_tile(floor_div(x_hi, kTileW), tiles_x) - tx_lo + 1;
        sy = clamp_tile(floor_div(y_hi, kTileH), tiles_y) - ty_lo + 1;
        for (int dy = 0; dy < sy; ++dy) {
          for (int dx = 0; dx < sx; ++dx) {
            const int old = atomicAdd(&counts[(ty_lo + dy) * tiles_x + tx_lo + dx], 1);
            top = max(top, old + 1);
            over += old >= kMaxCapacity;
          }
        }
      }
    }
    spans[f] = make_int2(tx_lo | (ty_lo << 16), sx | (sy << 16));
  }
  top = (int)__reduce_max_sync(0xffffffffu, (unsigned)top);
  sx = (int)__reduce_max_sync(0xffffffffu, (unsigned)sx);
  sy = (int)__reduce_max_sync(0xffffffffu, (unsigned)sy);
  over = (int)__reduce_add_sync(0xffffffffu, (unsigned)over);
  if ((threadIdx.x & 31) == 0 && top > 0) {
    atomicMax(&record[0], top);
    atomicMax(&record[1], sx);
    atomicMax(&record[2], sy);
    if (over) atomicAdd(&record[3], over);
  }
}

// the pass (dy * max_sx + dx) in which face span `s` reaches tile (ty, tx),
// or -1 where it does not reach it (a culled face's span is 0 x 0)
__device__ __forceinline__ int pass_of(int2 s, int ty, int tx, int max_sx) {
  const int dx = tx - (s.x & 0xffff), dy = ty - (s.x >> 16);
  return ((unsigned)dx < (unsigned)(s.y & 0xffff) && (unsigned)dy < (unsigned)(s.y >> 16))
             ? dy * max_sx + dx
             : -1;
}

// face f's slab column (rows x0 y0 z0 x1 y1 z1 x2 y2 z2 u0 v0 u1 v1 u2 v2
// valid) at `col`, rows `capacity` apart
__device__ __forceinline__ void put_face(const float* __restrict__ verts,
                                         const float* __restrict__ uvs,
                                         const int* __restrict__ faces, int f, float valid,
                                         float* col, int capacity) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = faces[3 * (size_t)f + k];
    col[(size_t)(3 * k) * capacity] = verts[3 * (size_t)i];
    col[(size_t)(3 * k + 1) * capacity] = verts[3 * (size_t)i + 1];
    col[(size_t)(3 * k + 2) * capacity] = verts[3 * (size_t)i + 2];
    col[(size_t)(9 + 2 * k) * capacity] = uvs[2 * (size_t)i];
    col[(size_t)(10 + 2 * k) * capacity] = uvs[2 * (size_t)i + 1];
  }
  col[(size_t)15 * capacity] = valid;
}

__global__ void __launch_bounds__(kFillThreads)
bin_fill_kernel(const float* __restrict__ verts, const float* __restrict__ uvs,
                const int* __restrict__ faces, int n_faces, const int2* __restrict__ spans,
                int tiles_x, int max_sx, int n_passes, int capacity, float* __restrict__ tri_data,
                int* __restrict__ tri_ids) {
  extern __shared__ int base[];  // [n_passes]: the tile's faces per pass, then the next slots
  __shared__ int warp_n[kFillWarps];
  __shared__ int list_q[kFillThreads], list_f[kFillThreads];
  __shared__ int carry;
  const int tile = blockIdx.x, ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n_passes; i += kFillThreads) base[i] = 0;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();

  // walk 1: the tile's faces per pass
  for (int c0 = 0; c0 < n_faces; c0 += kFillThreads) {
    const int f = c0 + threadIdx.x;
    if (f < n_faces) {
      const int q = pass_of(spans[f], ty, tx, max_sx);
      if (q >= 0) atomicAdd(&base[q], 1);
    }
  }
  __syncthreads();

  // each pass's first slot: an exclusive prefix sum, kFillThreads passes at a time
  for (int c0 = 0; c0 < n_passes; c0 += kFillThreads) {
    const int i = c0 + threadIdx.x;
    const int x = i < n_passes ? base[i] : 0;
    int s = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane == 31) warp_n[warp] = s;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_n[w];
    if (i < n_passes) base[i] = before + s - x;
    __syncthreads();
    if (threadIdx.x == kFillThreads - 1) carry = before + s;
    __syncthreads();
  }
  const int total = carry;

  // walk 2: each chunk's matches in id order, each at its pass's next slot
  float* td = tri_data + (size_t)tile * 16 * capacity;
  int* ids = tri_ids + (size_t)tile * capacity;
  for (int c0 = 0; c0 < n_faces; c0 += kFillThreads) {
    const int f = c0 + threadIdx.x;
    const int q = f < n_faces ? pass_of(spans[f], ty, tx, max_sx) : -1;
    const int n = __syncthreads_count(q >= 0);
    if (n == 0) continue;
    const unsigned ballot = __ballot_sync(0xffffffffu, q >= 0);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    if (q >= 0) {
      int at = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) at += warp_n[w];
      list_q[at] = q;
      list_f[at] = f;
    }
    __syncthreads();
    int mine = -1;
    if ((int)threadIdx.x < n) {
      mine = list_q[threadIdx.x];
      int slot = base[mine];
      for (int j = 0; j < (int)threadIdx.x; ++j) slot += list_q[j] == mine;
      if (slot < capacity) {
        put_face(verts, uvs, faces, list_f[threadIdx.x], 1.0f, td + slot, capacity);
        ids[slot] = list_f[threadIdx.x];
      }
    }
    __syncthreads();  // every slot is taken before the cursors move
    if (mine >= 0) atomicAdd(&base[mine], 1);
  }

  // the empty slots, as the host fills them
  for (int s = min(total, capacity) + threadIdx.x; s < capacity; s += kFillThreads) {
    put_face(verts, uvs, faces, 0, 0.0f, td + s, capacity);
    ids[s] = 0;
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
      qscale, KeysOut{(int*)keys, (float*)u, (float*)v});
  return (int)cudaGetLastError();
}

// tri and poses as above; tex [*, tex_stride] f32 whose true size is (th, tw);
// gray [S, H, W] f32 with H <= 16 * (n_tiles / tiles_x) and W <= 128 * tiles_x.
int nmi_render_gray(const void* tri, const void* poses, int S, int n_tiles, int capacity,
                    int tiles_x, float fx, float fy, float cx, float cy, float near,
                    float qscale, const void* tex, int tex_stride, int th, int tw,
                    float background, int H, int W, void* gray, void* stream) {
  render_gray_kernel<<<dim3(n_tiles, S), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)poses, n_tiles, capacity, tiles_x, fx, fy, cx, cy, near,
      qscale, GrayOut{(const float*)tex, tex_stride, th, tw, background, H, W, (float*)gray});
  return (int)cudaGetLastError();
}

// verts [V, 3] f32, faces [F, 3] int32, params the kBinParams doubles of
// BinParams on the host; spans [F] int2 (tx_lo | ty_lo << 16, sx | sy << 16),
// counts [tiles_y * tiles_x] and record [4] (largest count, largest span in x
// and in y, overflow) int32, both zeroed by the caller.
int nmi_bin_count(const void* verts, const void* faces, int n_faces, const void* params,
                  int height, int width, int tiles_y, int tiles_x, void* spans, void* counts,
                  void* record, void* stream) {
  BinParams p;
  const double* v = (const double*)params;
  static_assert(sizeof(BinParams) == kBinParams * sizeof(double), "BinParams layout");
  for (int i = 0; i < kBinParams; ++i) reinterpret_cast<double*>(&p)[i] = v[i];
  bin_count_kernel<<<(n_faces + kCountThreads - 1) / kCountThreads, kCountThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)verts, (const int*)faces, n_faces, p, height, width, tiles_y, tiles_x,
      (int2*)spans, (int*)counts, (int*)record);
  return (int)cudaGetLastError();
}

// verts, faces and spans as above, uvs [V, 2] f32; n_passes = max span in y
// times max_sx; tri_data [n_tiles, 16, capacity] f32 and tri_ids
// [n_tiles, capacity] int32, every element written.
int nmi_bin_fill(const void* verts, const void* uvs, const void* faces, int n_faces,
                 const void* spans, int n_tiles, int tiles_x, int max_sx, int n_passes,
                 int capacity, void* tri_data, void* tri_ids, void* stream) {
  const int smem = n_passes * (int)sizeof(int);
  if (smem > 40 * 1024) {  // with the static arrays past the 48 KB a launch gets unasked
    const cudaError_t err = cudaFuncSetAttribute(
        bin_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  bin_fill_kernel<<<n_tiles, kFillThreads, smem, (cudaStream_t)stream>>>(
      (const float*)verts, (const float*)uvs, (const int*)faces, n_faces, (const int2*)spans,
      tiles_x, max_sx, n_passes, capacity, (float*)tri_data, (int*)tri_ids);
  return (int)cudaGetLastError();
}

// The resources of one of the two kernels (gray != 0: render_gray_kernel):
// registers a thread, static shared memory a block, and the blocks that fit
// on one SM at once. Returns the CUDA error code.
int nmi_raster_resources(int gray, int* regs, int* smem, int* blocks_per_sm) {
  const void* fn = gray ? (const void*)render_gray_kernel : (const void*)rasterize_keys_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0);
}

}  // extern "C"
