// Streaming-bandwidth probe for Hopper (sm_90a): y = 2 * x over f32.
//
// Replaces scripts/tpu_pallas_stream_probe.py::scale_pallas, the TPU
// probe that measured what a Pallas pipeline could stream through HBM.
// Here it measures what a hand-written CUDA kernel can stream through
// the card's device memory, the yardstick beside the data-sheet rate for
// every "fraction of the memory bound" the port reports.
//
// What bounds it: memory only. It reads 4 bytes and writes 4 bytes per
// element and does one multiply (exact: a power of two), so 2^28
// elements move 2 GiB, 641 us at an H100 SXM's 3.35 TB/s.
//
// The layout of PyTorch's own vectorized elementwise kernels: one float4
// per thread, 128-thread blocks, one block per 2 KB tile and a grid that
// covers x once, plain loads and stores. Each warp instruction moves 512
// contiguous bytes. On an H100 this ran at torch.mul's rate, where larger
// tiles, a grid of resident blocks striding over tiles, evict-first and
// streaming cache hints, and a double-buffered bulk copy (cp.async.bulk)
// through shared memory were all 1-8 % slower (PERF.md). The n mod 4 tail
// is done by the first threads of the grid, one float each. The wrapper
// passes 16-byte-aligned tensors (PyTorch's allocations are).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    scale2(const float4* __restrict__ x4, float4* __restrict__ y4, int64_t n4,
           const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    float4 v = x4[i];
    v.x = __fmul_rn(v.x, 2.0f);
    v.y = __fmul_rn(v.y, 2.0f);
    v.z = __fmul_rn(v.z, 2.0f);
    v.w = __fmul_rn(v.w, 2.0f);
    y4[i] = v;
  }
  if (4 * n4 + i < n) y[4 * n4 + i] = __fmul_rn(x[4 * n4 + i], 2.0f);
}

}  // namespace

extern "C" {

int spectra_stream_scale2_f32(const float* x, float* y, int64_t n,
                              void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // n < 4: the tail alone
  scale2<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4, x,
      y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
