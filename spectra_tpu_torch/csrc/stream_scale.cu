// Streaming-bandwidth probe for Hopper (sm_90a): y = 2 * x over f32.
//
// Replaces scripts/tpu_pallas_stream_probe.py::scale_pallas, the TPU
// probe that measured what a Pallas pipeline could stream through HBM.
// Here it measures what a plain CUDA kernel can stream through the
// card's device memory, the yardstick beside the data-sheet rate for
// every "fraction of the memory bound" the port reports.
//
// What bounds it: memory only. It reads 4 bytes and writes 4 bytes per
// element and does one multiply (exact: a power of two), so 2^28
// elements move 2 GiB, 641 us at an H100 SXM's 3.35 TB/s.
//
// What the design does about it: 16-byte loads and stores (float4), so
// every warp moves 512 contiguous bytes per instruction, and four such
// loads started by each thread before its first store, so enough bytes
// are in flight to cover the memory latency; a grid-stride loop over
// groups of four, then a scalar loop for the tail. The wrapper passes
// 16-byte-aligned tensors (PyTorch's allocations are).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 loads in flight per thread
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float4 twice(float4 v) {
  v.x = __fmul_rn(v.x, 2.0f);
  v.y = __fmul_rn(v.y, 2.0f);
  v.z = __fmul_rn(v.z, 2.0f);
  v.w = __fmul_rn(v.w, 2.0f);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    scale2_kernel(const float4* __restrict__ x4, float4* __restrict__ y4,
                  int64_t n4, const float* __restrict__ x,
                  float* __restrict__ y, int64_t n) {
  const int64_t threads = int64_t(gridDim.x) * blockDim.x;
  const int64_t start = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = n4 / (kUnroll * threads);  // full rounds
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t base = g * kUnroll * threads + start;
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x4[base + u * threads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y4[base + u * threads] = twice(v[u]);
  }
  for (int64_t i = groups * kUnroll * threads + start; i < n4; i += threads) {
    y4[i] = twice(x4[i]);
  }
  for (int64_t i = 4 * n4 + start; i < n; i += threads) {
    y[i] = __fmul_rn(x[i], 2.0f);
  }
}

}  // namespace

extern "C" {

int spectra_stream_scale2_f32(const float* x, float* y, int64_t n,
                              void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  int64_t blocks = (n4 / kUnroll + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scale2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4,
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
