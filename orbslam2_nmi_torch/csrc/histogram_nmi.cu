// Joint and marginal entropies of 8-bit gray-level images, for NMI scoring.
//
// nmi_joint_entropy replaces the Pallas kernel `joint_entropy_grid_pallas`
// (orbslam2_nmi_tpu/ops/histogram_nmi.py:236-290, body :151-233), and
// nmi_marginal_entropy replaces `marginal_entropy_pallas` (:329-357, body
// :293-326). Both compute exactly the function of their plain PyTorch versions
// in orbslam2_nmi_torch/ops/histogram_nmi.py.
//
// What bounds them on an H100: the joint kernel builds S*R histograms of 256x256
// bins from P pixels each, S*R*P increments (3.8e8 at the main path's 27x27
// pairs of 960x540 images), while the inputs are only (S+R)*P bytes (28 MB)
// because the bins are packed to uint8. By bytes it would take ~8 us; it is
// bounded by the rate and latency of shared-memory atomics and the
// instructions that decode each pixel into its bin. The TPU form (an int8
// one-hot matrix product, 2*S*R*P*256 ops) would cost ~1e2 times the
// increments, so it is not carried over.
//
// Design of the joint kernel (PERF.md has the measurements):
//  * One block of 1024 threads per (s, r) pair holds the pair's whole 256x256
//    histogram in 128 KB of shared memory, as 16-bit counts packed two to a
//    word, and reads each pixel of the pair once, 16 bytes a thread (two
//    loads of each image in flight) when the rows are 16-byte aligned, a byte
//    at a time otherwise. A u32 histogram (256 KB) does not fit a block's
//    227 KB; splitting it over a cluster of 2 CTAs, each adding into the
//    other's half through distributed shared memory, measured 2.6 ms on the
//    main path, 8x this design: the remote adds set its time.
//  * Bin (a, b) is half a & 1 of word ((a >> 1) << 8) | (b ^ ((a >> 1) & 31)).
//    The XOR spreads a column of bins (for example b = 0, the warps' zero
//    borders) over all 32 banks. Four pixels are decoded at once with byte
//    operations (__byte_perm).
//  * Exact counts past 16 bits: every add returns the old word; the add that
//    takes a count to 2^14 subtracts 2^14 again and records it in a small
//    open-addressed table of (bin, times) in shared memory, which leaves
//    49,152 adds of headroom on the bin while the subtraction is on its way.
//    At most P / 2^14 bins can spill, so the table's 2048 slots hold P < 2^25
//    (the wrapper checks).
//  * No warp aggregation of equal keys: merging a warp's equal bins with
//    __match_any_sync before each add made the kernel 10x slower on the main
//    path's images (tools/ablate_kernels.py), and merging only the keys with
//    a 0 component doubled the time of an earlier form of it (PERF.md).
//  * Epilogue: the spilled bins first (each folded whole, then cleared), then
//    every word; -p log2 p of counts below 1024 comes from a table that each
//    block fills once. With mask_zero (the reference's nmi_prop_BG=false) the
//    pixels where either bin is 0 are skipped while counting, and the row
//    and column sums (the masked marginals Ha, Hb) are gathered in the same
//    scan with shared atomics.
//  * Each term p*log2(p), p = count * inv_n, is rounded in f32 as in the plain
//    version and summed in f64, so the sum's order (which atomics do not fix)
//    moves the result by far less than the tests' 1e-5.
//
// The marginal kernel reads (S+R)*P bytes (28 MB on the main path, 8.4 us at
// the HBM rate) and does one shared-memory add per pixel, so bytes and the
// rate of those adds bound it. Its design:
//  * One launch for both image sets (renders and warps), grid (C, S+R): a
//    cluster of C CTAs per image, so the main path's 54 images fill 216 CTAs
//    (C = 4) instead of two launches of 27 blocks on 27 SMs.
//  * Each CTA counts a contiguous share of the image's 16-byte words (16-byte
//    loads) into one 256-bin u32 histogram in shared memory; rank 0 also
//    counts the bytes before the first 16-byte boundary and after the last
//    whole word, so any P and any row alignment take the vector path for all
//    but 30 bytes. Random grays cost more than flat ones (bank conflicts, not
//    adds to one address): per-warp copies of the histogram and two loads in
//    flight were no faster on the main path or on flat images, and one add of
//    16 for 16 equal bytes was slower on flat ones (tools/ablate_kernels.py).
//  * Each CTA adds its 256 counts into rank 0's histogram through distributed
//    shared memory: 256 remote adds a CTA, not one a pixel (B1's cluster
//    design lost by its per-pixel remote adds).
//  * A CTA whose share is empty (P < 16 * C) still reaches both cluster.sync()
//    calls: no CTA returns before the second.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kJointThreads = 1024;
constexpr int kMarginalThreads = 512;
constexpr int kMarginalCluster = 4;  // CTAs an image; above 8 is a non-portable cluster size
constexpr int kWords = kBins * kBins / 2;  // two u16 counts per u32 word
constexpr unsigned kSpill = 0x4000u;       // a count reaching this moves it to the spill table
constexpr int kSpillSlots = 2048;          // more than P / kSpill bins can spill (P < 2^25)
constexpr unsigned kEmpty = 0xffffffffu;
constexpr int kTable = 1024;               // p log2 p of the counts below this, tabulated
// words [kWords], spill_key [kSpillSlots], spill_n [kSpillSlots], row_sum [256], col_sum [256]
constexpr size_t kJointSmem = (kWords + 2 * kSpillSlots + 2 * kBins) * sizeof(unsigned);
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ double plogp(unsigned count, float inv_n) {
  const float p = (float)count * inv_n;
  return (double)(p * (logf(p) * kLog2e));
}

// Sum of `v` over the block; the result is valid in thread 0.
__device__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

// The joint histogram in shared memory. Bin (a, b) is the u16 in half a & 1
// (bits 16 * (a & 1) up) of word ((a >> 1) << 8) | (b ^ ((a >> 1) & 31)):
// the XOR spreads a column of bins over all 32 banks.
struct JointSmem {
  unsigned* words;      // [kWords]
  unsigned* spill_key;  // [kSpillSlots] open-addressed (word << 1) | half, or kEmpty
  unsigned* spill_n;    // [kSpillSlots] times kSpill moved out of that bin
};

// Inline: built as a call (__noinline__), with the table reached through
// generic pointers, it miscounted on the card (PERF.md).
__device__ __forceinline__ void spill(const JointSmem& sm, unsigned w, unsigned sh) {
  atomicAdd(&sm.words[w], 0u - (kSpill << sh));
  const unsigned key = (w << 1) | (sh >> 4);
  for (unsigned h = (key * 2654435761u) >> 21;; h = (h + 1u) & (kSpillSlots - 1)) {
    const unsigned prev = atomicCAS(&sm.spill_key[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicAdd(&sm.spill_n[h], 1u);
      return;
    }
  }
}

// Counts one pixel into half `sh` (0 or 16) of word `w`. The add that takes
// the count to kSpill moves kSpill of it to the spill table at once, so the
// count stays below 2^16 unless 2^16 - 2^14 more adds land on that one bin
// before the subtraction does; adds to one address serialize, so that would
// take some 49,000 cycles between two instructions of a ready warp.
__device__ __forceinline__ void add_bin(const JointSmem& sm, unsigned w, unsigned sh) {
  const unsigned old = atomicAdd(&sm.words[w], 1u << sh);
  if (((old >> sh) & 0xffffu) == kSpill - 1u) spill(sm, w, sh);
}

// Four pixels, one per byte of wa (renders) and wb (warps).
template <bool kMaskZero>
__device__ __forceinline__ void count_word(const JointSmem& sm, unsigned wa, unsigned wb) {
  const unsigned ah = (wa >> 1) & 0x7f7f7f7fu;       // a >> 1
  const unsigned lo = wb ^ (ah & 0x1f1f1f1fu);       // b ^ ((a >> 1) & 31)
  const unsigned w01 = __byte_perm(lo, ah, 0x5140);  // words of pixels 0 and 1
  const unsigned w23 = __byte_perm(lo, ah, 0x7362);  // and of pixels 2 and 3
  const unsigned hs = (wa & 0x01010101u) << 4;       // half shifts, 16 * (a & 1)
  const unsigned live = kMaskZero ? (__vcmpne4(wa, 0u) & __vcmpne4(wb, 0u)) : 0xffffffffu;
  if (live & 0xffu) add_bin(sm, w01 & 0xffffu, hs & 0xffu);
  if (live & 0xff00u) add_bin(sm, w01 >> 16, (hs >> 8) & 0xffu);
  if (live & 0xff0000u) add_bin(sm, w23 & 0xffffu, (hs >> 16) & 0xffu);
  if (live & 0xff000000u) add_bin(sm, w23 >> 16, hs >> 24);
}

template <bool kMaskZero>
__device__ __forceinline__ void count_16(const JointSmem& sm, const uint4& x, const uint4& y) {
  count_word<kMaskZero>(sm, x.x, y.x);
  count_word<kMaskZero>(sm, x.y, y.y);
  count_word<kMaskZero>(sm, x.z, y.z);
  count_word<kMaskZero>(sm, x.w, y.w);
}

// -p log2 p of count c (c > 0), from the table below kTable.
__device__ __forceinline__ double neg_plogp(unsigned c, const double* table, float inv_n) {
  return c < (unsigned)kTable ? table[c] : -plogp(c, inv_n);
}

template <bool kMaskZero>
__global__ void __launch_bounds__(kJointThreads)
joint_entropy_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                     int R, long long P, float inv_n, float* __restrict__ out, int SR) {
  extern __shared__ __align__(16) unsigned smem[];
  const JointSmem sm = {smem, smem + kWords, smem + kWords + kSpillSlots};
  unsigned* row_sum = smem + kWords + 2 * kSpillSlots;  // [256] masked Ha counts
  unsigned* col_sum = row_sum + kBins;                  // [256] masked Hb counts
  __shared__ double table[kTable];                      // -p log2 p of counts 0 .. kTable - 1
  __shared__ double scratch[32];

  const int pair = blockIdx.x;
  const uint8_t* pa = a + (size_t)(pair / R) * P;
  const uint8_t* pb = b + (size_t)(pair % R) * P;
  const bool vec = (P % 16) == 0 && ((((uintptr_t)pa) | ((uintptr_t)pb)) % 16) == 0;

  uint4* s4 = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < (int)(kJointSmem / 16); i += kJointThreads) {
    const bool keys = i >= kWords / 4 && i < (kWords + kSpillSlots) / 4;
    s4[i] = keys ? make_uint4(kEmpty, kEmpty, kEmpty, kEmpty) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int c = threadIdx.x; c < kTable; c += kJointThreads)
    table[c] = c == 0 ? 0.0 : -plogp((unsigned)c, inv_n);
  __syncthreads();

  if (vec) {
    // two 16-byte loads of each image in flight per thread
    const uint4* va = reinterpret_cast<const uint4*>(pa);
    const uint4* vb = reinterpret_cast<const uint4*>(pb);
    const long long n16 = P / 16;
    for (long long i = threadIdx.x; i < n16; i += 2 * kJointThreads) {
      const bool two = i + kJointThreads < n16;
      const uint4 x = va[i], y = vb[i];
      const uint4 x1 = two ? va[i + kJointThreads] : x, y1 = two ? vb[i + kJointThreads] : y;
      count_16<kMaskZero>(sm, x, y);
      if (two) count_16<kMaskZero>(sm, x1, y1);
    }
  } else {
    for (long long i = threadIdx.x; i < P; i += kJointThreads) {
      const unsigned ai = pa[i], bi = pb[i];
      if (!kMaskZero || (ai != 0u && bi != 0u))
        add_bin(sm, ((ai >> 1) << 8) | (bi ^ ((ai >> 1) & 31u)), (ai & 1u) << 4);
    }
  }
  __syncthreads();

  // spilled bins first: the thread of each used slot folds its bin's whole
  // count and clears the bin's half, which the scan below then skips
  double h_ab = 0.0;
  for (int h = threadIdx.x; h < kSpillSlots; h += kJointThreads) {
    const unsigned key = sm.spill_key[h];
    if (key == kEmpty) continue;
    const unsigned w = key >> 1, sh = (key & 1u) << 4;
    const unsigned c = ((sm.words[w] >> sh) & 0xffffu) + kSpill * sm.spill_n[h];
    h_ab -= plogp(c, inv_n);
    if (kMaskZero) {
      atomicAdd(&row_sum[((w >> 8) << 1) | (key & 1u)], c);
      atomicAdd(&col_sum[(w & 255u) ^ ((w >> 8) & 31u)], c);
    }
    atomicAnd(&sm.words[w], ~(0xffffu << sh));
  }
  __syncthreads();
  // the 32 words of a warp share a >> 1 (256 words each)
  for (int w = threadIdx.x; w < kWords; w += kJointThreads) {
    const unsigned v = sm.words[w], c0 = v & 0xffffu, c1 = v >> 16;
    if (c0) h_ab += neg_plogp(c0, table, inv_n);
    if (c1) h_ab += neg_plogp(c1, table, inv_n);
    if (kMaskZero) {
      const unsigned ah = (unsigned)w >> 8;
      if (v) atomicAdd(&col_sum[((unsigned)w & 255u) ^ (ah & 31u)], c0 + c1);
      unsigned r0 = c0, r1 = c1;
      for (int o = 16; o > 0; o >>= 1) {
        r0 += __shfl_down_sync(0xffffffffu, r0, o);
        r1 += __shfl_down_sync(0xffffffffu, r1, o);
      }
      if ((threadIdx.x & 31) == 0) {
        if (r0) atomicAdd(&row_sum[ah << 1], r0);
        if (r1) atomicAdd(&row_sum[(ah << 1) | 1u], r1);
      }
    }
  }
  double h_a = 0.0, h_b = 0.0;
  if (kMaskZero) {
    __syncthreads();
    if (threadIdx.x < kBins) {
      if (row_sum[threadIdx.x] != 0u) h_a = -plogp(row_sum[threadIdx.x], inv_n);
      if (col_sum[threadIdx.x] != 0u) h_b = -plogp(col_sum[threadIdx.x], inv_n);
    }
  }
  h_ab = block_sum(h_ab, scratch);
  if (kMaskZero) {
    h_a = block_sum(h_a, scratch);
    h_b = block_sum(h_b, scratch);
  }
  if (threadIdx.x == 0) {
    out[pair] = (float)h_ab;
    if (kMaskZero) {
      out[SR + pair] = (float)h_a;
      out[2 * SR + pair] = (float)h_b;
    }
  }
}

// Counts the 16 bytes of x into hist.
__device__ __forceinline__ void count_bytes_16(unsigned* hist, const uint4& x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicAdd(&hist[(w[j] >> (8 * k)) & 255u], 1u);
}

// Grid (kMarginalCluster, S + R), one cluster per image: images 0 .. S-1 are
// the rows of a, the rest those of b. out[image] = -sum p log2 p.
__global__ void __launch_bounds__(kMarginalThreads)
marginal_entropy_kernel(const uint8_t* __restrict__ a, int S, const uint8_t* __restrict__ b,
                        long long P, float inv_n, float* __restrict__ out) {
  __shared__ unsigned hist[kBins];   // this CTA's counts
  __shared__ unsigned total[kBins];  // the image's histogram, gathered in rank 0
  __shared__ double scratch[32];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int image = blockIdx.y;
  const uint8_t* p = image < S ? a + (size_t)image * P : b + (size_t)(image - S) * P;
  for (int i = threadIdx.x; i < kBins; i += kMarginalThreads) hist[i] = total[i] = 0u;
  // every CTA of the cluster is running, and rank 0's total is 0, before any remote add
  cluster.sync();

  // bytes [0, head) and [rest, P) lie outside the whole 16-byte words
  const long long head = min(P, (long long)((16u - ((uintptr_t)p & 15u)) & 15u));
  const long long n16 = (P - head) / 16, rest = head + 16 * n16;
  const long long share = (n16 + kMarginalCluster - 1) / kMarginalCluster;
  const long long lo = min(n16, (long long)rank * share), hi = min(n16, lo + share);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (long long i = lo + threadIdx.x; i < hi; i += kMarginalThreads) count_bytes_16(hist, v[i]);
  if (rank == 0) {
    for (long long i = threadIdx.x; i < head; i += kMarginalThreads) atomicAdd(&hist[p[i]], 1u);
    for (long long i = rest + threadIdx.x; i < P; i += kMarginalThreads)
      atomicAdd(&hist[p[i]], 1u);
  }
  __syncthreads();

  unsigned* gathered = cluster.map_shared_rank(total, 0);
  for (int i = threadIdx.x; i < kBins; i += kMarginalThreads)
    if (hist[i] != 0u) atomicAdd(&gathered[i], hist[i]);
  // every remote add has landed; after this only rank 0 reads its own memory
  cluster.sync();
  if (rank != 0) return;
  double h = 0.0;
  for (int i = threadIdx.x; i < kBins; i += kMarginalThreads)
    if (total[i] != 0u) h -= plogp(total[i], inv_n);
  h = block_sum(h, scratch);
  if (threadIdx.x == 0) out[image] = (float)h;
}

template <bool kMaskZero>
cudaError_t launch_joint(const void* a, const void* b, int S, int R, long long P, float inv_n,
                         void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(joint_entropy_kernel<kMaskZero>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kJointSmem);
  if (err != cudaSuccess) return err;
  joint_entropy_kernel<kMaskZero><<<S * R, kJointThreads, kJointSmem, stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, R, P, inv_n, (float*)out, S * R);
  return cudaGetLastError();
}

cudaError_t launch_marginal(const void* a, int S, const void* b, int R, long long P, float inv_n,
                            void* out, cudaStream_t stream) {
  if (kMarginalCluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        marginal_entropy_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kMarginalCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMarginalCluster, S + R, 1);
  cfg.blockDim = dim3(kMarginalThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, marginal_entropy_kernel, (const uint8_t*)a, S,
                                             (const uint8_t*)b, P, inv_n, (float*)out);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

const char* nmi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// a [S, P] and b [R, P] uint8 bins; out [S*R] (or [3, S*R] with mask_zero) f32.
int nmi_joint_entropy(const void* a, const void* b, int S, int R, long long P, float inv_n,
                      int mask_zero, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(mask_zero ? launch_joint<true>(a, b, S, R, P, inv_n, out, st)
                         : launch_joint<false>(a, b, S, R, P, inv_n, out, st));
}

// a [S, P] and b [R, P] uint8 bins (b unread when R = 0); out [S+R] f32, the
// entropies of a's rows, then b's.
int nmi_marginal_entropy(const void* a, int S, const void* b, int R, long long P, float inv_n,
                         void* out, void* stream) {
  return (int)launch_marginal(a, S, b, R, P, inv_n, out, (cudaStream_t)stream);
}

}  // extern "C"
