// Two cost probes of the DIA SpMV for Hopper (sm_90a), in f32.
//
// Replaces the TPU probes of scripts/tpu_dia_variants.py, which took
// apart the cost of the Pallas DIA kernel (K1):
//
//   dia_noshift (tpu_dia_variants.py:68): K1 with every diagonal's
//     slice aligned at the row itself, so
//         y[i] = sum_k data[k, i] * x[i]
//     summed in offset order with acc = data[0, i] * x[i] first. Wrong
//     on purpose: its gap to K1 at the same shape is what the d shifted
//     reads of x cost.
//   dia_roll2d (tpu_dia_variants.py:110): the correct y = A x, with x
//     viewed as rows of 128. On the TPU each block of rows x 128 outputs
//     held its x window in VMEM, read once from device memory, and built
//     every shifted operand with sublane and lane rolls. The rolls are a
//     TPU register-layout device and do not carry over; the question
//     does: does reading x from a window staged once per tile of
//     rows x 128 outputs beat K1's reads of x through L1/L2?
//
// What bounds them: memory. Each reads d + 1 f32 values and writes one
// per row: (d + 2) * 4 * n bytes, 28 MB for the 5-point Laplacian at
// n = 10^6, 8.4 us at an H100 SXM's 3.35 TB/s; the d multiply-adds per
// row are far below the f32 rate. So the lever is bytes in flight on
// every SM.
//
// noshift: K1's own body and grid (dia_rows.cuh: for the same n and d
// the same block size, the same staging of loads through shared memory
// or registers, d unrolled as in K1), with the shifted reads of x
// replaced by one read of x[i] per row; so its gap to K1 measures the
// shifted reads and nothing else.
//
// roll2d: one tile of T = rows x 128 outputs per thread-block cluster
// of C CTAs (C in 1, 2, 4, 8, 16, from the wrapper's plan,
// ops/dia_variants.py::roll2d_plan), so the grid is tiles x C CTAs and
// fills the card at every rows rather than shrinking with it; the plan
// takes C and the block size (256-1024 threads) so that all tiles run in
// one wave, asking the card how many clusters it holds at once.
//   * The window. The tile's window is its T outputs plus a halo of H =
//     max|off| rounded up to 4 floats on each side: W = T + 2H values of
//     x, read once from device memory. CTA c of the cluster holds window
//     positions [c S, (c + 1) S), S = round_up(W / C, 4) >= T / C: one
//     bulk copy (TMA, cp.async.bulk ... mbarrier::complete_tx) issued by
//     one thread, for the part that lies in [0, n & ~3); the few values
//     in [n & ~3, n) by plain loads and everything outside [0, n) as
//     plain stores of zero, into regions the copy does not write. That
//     zero is the plain version's zero padding. After one cluster
//     barrier (a CTA barrier when C = 1) every CTA reads x[i + off] at
//     window position H + (i - first) + off: from its own share by a
//     plain shared load, from a neighbour's through distributed shared
//     memory (mapa + ld.shared::cluster); a second cluster barrier keeps
//     each CTA's window alive until its neighbours are done.
//   * The data planes go K1's way: each thread issues all d plane loads
//     of an output before its adds, the first output's before the wait
//     for the window, and at d = 5 the next output's before this one's
//     window reads. The other way, a producer warp streaming the planes
//     by bulk copies through a ring of stages in shared memory (legal
//     only where 4 divides n: plane k starts at k n floats), was slower
//     at rows 32 and 256 on an H100 when both were timed in one run
//     (PERF.md), and is gone.
//   * d = 5 and d = 27 (the shapes the chip run times) are unrolled;
//     any other d runs one diagonal at a time through the same code.
// What still holds it (PERF.md): the window's round trip, the cluster
// barrier and the window reads form a phase that the single wave of
// tiles cannot overlap with other tiles' plane loads, as K1's waves of
// small blocks do.
//
// Numerics: every product and sum is a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into an FMA, added
// in offset order from the first term, so both kernels are bitwise equal
// to their plain PyTorch versions, and roll2d is bitwise equal to K1's
// plain version (the same products added in the same order). Where x
// comes from (TMA, DSMEM) never changes the order of the adds.

#include <cuda_runtime.h>

#include <cstdint>

#include "dia_rows.cuh"

namespace {

constexpr int kMaxDiags = 64;
constexpr int kMaxSharedBytes = 227 * 1024;

// roll2d
constexpr uint32_t kCopyPiece = 1u << 15;  // bytes per bulk copy instruction

struct Roll2dArgs {
  const float* data;
  const float* x;
  float* y;
  int64_t n;
  int tile;     // T = rows * 128 outputs per cluster
  int per_cta;  // T / C outputs per CTA
  int halo;     // H: max|off| rounded up to 4
  int share;    // S: window values each CTA holds
  int count;    // d
  int64_t off[kMaxDiags];
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the phase of parity `parity`. A wait that
// has not ended after 2^31 cycles (about a second) traps: the launch then
// fails with an error instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1ll << 31)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) global ->
// this CTA's shared memory, counted on mbarrier bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  for (uint32_t done = 0; done < bytes; done += kCopyPiece) {
    const uint32_t piece = bytes - done < kCopyPiece ? bytes - done : kCopyPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + done),
        "l"(reinterpret_cast<const char*>(src) + done), "r"(piece), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The f32 at shared address `addr` of CTA `rank` of this cluster.
__device__ __forceinline__ float load_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

__device__ __forceinline__ float load_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Window position w = q S + r + p of the CTA-local output p (p < T / C <=
// S, so r + p < 2 S): the CTA that holds it and the address there; a
// plain shared load where that is this CTA (`rank`), which costs less
// than the cluster's path.
__device__ __forceinline__ float window_at(uint32_t window, int2 qr, int p,
                                           int share, uint32_t rank) {
  const int t = qr.y + p;
  const bool next = t >= share;
  const uint32_t owner = uint32_t(qr.x + (next ? 1 : 0));
  const uint32_t addr = window + 4u * uint32_t(next ? t - share : t);
  return owner == rank ? load_shared(addr) : load_cluster(addr, owner);
}

// y at CTA-local output p from its d plane values a[] (kD > 0): all
// window reads, then the d terms in offset order, from the first.
template <int kD>
__device__ __forceinline__ float row_sum(const Roll2dArgs& A, const int2* qr,
                                         uint32_t window, uint32_t rank, int p,
                                         const float (&a)[kD]) {
  float b[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) b[k] = window_at(window, qr[k], p, A.share, rank);
  float acc = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < kD; ++k) acc = __fadd_rn(acc, __fmul_rn(a[k], b[k]));
  return acc;
}

// Block sizes a count takes: up to 1024 threads, 512 at d = 27 (its 54
// values a thread need more than 64 registers).
__host__ __device__ constexpr int max_threads(int kD) { return kD == 27 ? 512 : 1024; }

// One tile of T = rows x 128 outputs per cluster of C CTAs (cluster g =
// blockIdx.x / C); CTA c computes outputs [c T/C, (c + 1) T/C) of it and
// holds window positions [c S, (c + 1) S). Dynamic shared memory: the
// window share, S floats.
template <int kD>
__global__ void __launch_bounds__(max_threads(kD))
    roll2d_kernel(const __grid_constant__ Roll2dArgs A) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int2 qr[kMaxDiags];
  const int d = kD > 0 ? kD : A.count;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int C = A.tile / A.per_cta;
  const uint32_t c = cluster_rank();
  const int64_t first = int64_t(blockIdx.x / C) * A.tile;
  const int64_t out0 = first + int64_t(c) * A.per_cta;  // this CTA's first output
  const int64_t left = A.n - out0;
  const int valid = left <= 0 ? 0 : (left < A.per_cta ? int(left) : A.per_cta);
  float* window = reinterpret_cast<float*>(smem);
  const uint32_t window_addr = shared_addr(window);
  const uint32_t win_bar = shared_addr(&bar);

  // Window positions [c S, (c + 1) S) are x[g0 .. g0 + S). The bulk
  // copy takes x[b0 .. b1), that range within [0, n & ~3) (empty: b0 =
  // b1 = g0); plain stores fill the rest.
  const int64_t g0 = first - A.halo + int64_t(c) * A.share;
  const int64_t g1 = g0 + A.share;
  const int64_t n4 = A.n & ~int64_t(3);
  int64_t b0 = g0 < 0 ? 0 : g0;
  int64_t b1 = g1 < n4 ? g1 : n4;
  if (b1 <= b0) b0 = b1 = g0;

  if (tid == 0) {
    bar_init(win_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < d; k += threads) {
    // w = H + c T/C + off_k + p for output p; H + off_k >= 0.
    const int64_t base = int64_t(A.halo) + int64_t(c) * A.per_cta + A.off[k];
    qr[k] = make_int2(int(base / A.share), int(base % A.share));
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = uint32_t(b1 - b0) * 4u;
    bar_expect(win_bar, bytes);
    if (bytes) bulk_copy(window_addr + uint32_t(b0 - g0) * 4u, A.x + b0, bytes, win_bar);
  }
  auto plane_at = [&](int p, int k) {
    return __ldg(A.data + int64_t(k) * A.n + out0 + p);
  };
  // The first output's plane loads go out before the wait for the window.
  float a[kD > 0 ? kD : 1];
  if constexpr (kD > 0) {
    if (tid < valid) {
#pragma unroll
      for (int k = 0; k < kD; ++k) a[k] = plane_at(tid, k);
    }
  }
  // Plain stores into the parts of the share the copy does not write.
  for (int64_t l = tid; l < b0 - g0; l += threads) {
    const int64_t x = g0 + l;
    window[l] = x >= 0 && x < A.n ? A.x[x] : 0.0f;
  }
  for (int64_t l = (b1 - g0) + tid; l < A.share; l += threads) {
    const int64_t x = g0 + l;
    window[l] = x >= 0 && x < A.n ? A.x[x] : 0.0f;
  }
  bar_wait(win_bar, 0);
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();  // a cluster of one: the plain stores are this CTA's
  }
  if constexpr (kD > 0) {
    // d = 5: two outputs' plane loads in flight, the next one's issued
    // before this one's window reads. d = 27 keeps one (a second would
    // take 79 registers a thread and halve the CTAs an SM holds).
    constexpr bool kNext = kD <= 8;
    for (int p = tid; p < valid; p += threads) {
      float next[kD];
      if (kNext && p + threads < valid) {
#pragma unroll
        for (int k = 0; k < kD; ++k) next[k] = plane_at(p + threads, k);
      }
      A.y[out0 + p] = row_sum<kD>(A, qr, window_addr, c, p, a);
      if (p + threads < valid) {
#pragma unroll
        for (int k = 0; k < kD; ++k) a[k] = kNext ? next[k] : plane_at(p + threads, k);
      }
    }
  } else {  // any other d: one diagonal at a time
    for (int p = tid; p < valid; p += threads) {
      float acc = __fmul_rn(plane_at(p, 0), window_at(window_addr, qr[0], p, A.share, c));
      for (int k = 1; k < d; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(plane_at(p, k),
                                       window_at(window_addr, qr[k], p, A.share, c)));
      }
      A.y[out0 + p] = acc;
    }
  }
  // No CTA leaves while a neighbour may still read its window.
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

using Roll2dKernel = void (*)(const Roll2dArgs);

// The kernel for d = count, its attributes set for `smem` bytes and
// `cluster`, and its launch configuration for `ctas` CTAs of `threads`.
cudaError_t roll2d_config(int count, int cluster, int threads, size_t smem,
                          int64_t ctas, cudaStream_t stream,
                          Roll2dKernel& kernel, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute* attr) {
  kernel = count == 5    ? roll2d_kernel<5>
           : count == 27 ? roll2d_kernel<27>
                         : roll2d_kernel<0>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

size_t roll2d_smem(int share) { return (size_t(share) * 4 + 127) / 128 * 128; }

}  // namespace

extern "C" {

// P3 on K1's body (dia_rows.cuh) with the shifted reads removed; block
// size and staging as K1 takes them (ops/dia_spmv.py::launch_config).
int spectra_dia_noshift_f32(const float* data, const float* x, float* y,
                            int64_t n, int count, int threads, int staged,
                            void* stream) {
  if (count < 1 || count > kMaxDiags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t zeros[kMaxDiags] = {};
  spectra_dia::Args<float> A{data, x, y, n, n, 0, 0};
  return spectra_dia::launch<float, false>(A, zeros, count, threads, staged,
                                           stream);
}

// P4 with the plan of ops/dia_variants.py::roll2d_plan: tiles of `tile`
// outputs (a multiple of 128), one a cluster of `cluster` CTAs of
// `threads` (256, 512 or 1024; at most 512 at d = 27), a halo of `halo`
// floats (a multiple of 4, >= every |offset|), `share` window floats a
// CTA (a multiple of 4, cluster * share >= tile + 2 halo, share >= tile /
// cluster). x must be 16-byte aligned.
int spectra_dia_roll2d_f32(const float* data, const float* x, float* y,
                           int64_t n, const int64_t* offsets, int count,
                           int tile, int cluster, int halo, int share,
                           int threads, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 ||
                          cluster == 8 || cluster == 16;
  if (n < 1 || count < 1 || count > kMaxDiags || tile < 128 || tile % 128 ||
      !cluster_ok || halo < 0 ||
      halo % 4 || share < 4 || share % 4 || share < tile / cluster ||
      int64_t(share) * cluster < int64_t(tile) + 2 * int64_t(halo) ||
      (threads != 256 && threads != 512 && threads != 1024) ||
      threads > max_threads(count == 27 ? 27 : 0) ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Roll2dArgs A;
  A.data = data;
  A.x = x;
  A.y = y;
  A.n = n;
  A.tile = tile;
  A.per_cta = tile / cluster;
  A.halo = halo;
  A.share = share;
  A.count = count;
  for (int k = 0; k < count; ++k) {
    A.off[k] = offsets[k];
    const int64_t a = offsets[k] < 0 ? -offsets[k] : offsets[k];
    if (a > halo) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = roll2d_smem(share);
  if (smem > size_t(kMaxSharedBytes) - 1024) {  // 1 KB of static shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + tile - 1) / tile;
  if (tiles * cluster > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Roll2dKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = roll2d_config(count, cluster, threads, smem, tiles * cluster,
                                  static_cast<cudaStream_t>(stream), kernel, cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, A);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// How many clusters of P4's launch with these parameters the card holds
// at once (cudaOccupancyMaxActiveClusters), into *clusters; the plan
// (ops/dia_variants.py::card_plan) sizes its grid by it.
int spectra_dia_roll2d_clusters_f32(int count, int cluster, int threads,
                                    int share, int* clusters) {
  Roll2dKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = roll2d_config(count, cluster, threads, roll2d_smem(share),
                                  cluster, nullptr, kernel, cfg, attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return static_cast<int>(err);
}

}  // extern "C"
