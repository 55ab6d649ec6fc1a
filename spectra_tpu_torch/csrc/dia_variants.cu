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
//     viewed as rows of 128. On the TPU each block held an x window of
//     (rows + 2 pad_rows) x 128 in VMEM and built every shifted operand
//     with sublane and lane rolls. The rolls are a TPU register-layout
//     device and do not carry over; the idea does: each block stages
//     its x window once in shared memory and reads the d shifted
//     operands from there instead of from L1/L2.
//
// What bounds them: memory. Each reads d + 1 f32 values and writes one
// per row: (d + 2) * 4 * n bytes, 28 MB for the 5-point Laplacian at
// n = 10^6, 8.4 us at an H100 SXM's 3.35 TB/s; the d multiply-adds per
// row are far below the f32 rate.
//
// What the design does about it:
//   noshift: one thread per row in a grid-stride loop; d coalesced
//     loads of data and one of x.
//   roll2d: a block owns rows x 128 outputs. It copies the window of
//     (rows + 2 pad_rows) x 128 x values, pad_rows * 128 before its
//     first output and after its last (zero outside [0, n)), into
//     dynamic shared memory with coalesced 16-byte loads, synchronizes,
//     then each thread does the d multiply-adds of its outputs in offset
//     order, reading x[i + off] at window position
//     pad_rows * 128 + (i - first) + off, consecutive across a warp (no
//     bank conflicts). pad_rows * 128 >= max|off| + 128 keeps every read
//     inside the window. rows is a parameter: the window takes
//     (rows + 2 pad_rows) * 512 bytes, 143,360 at rows = 256 and
//     pad_rows = 12; above 48 KB the launch raises the kernel's dynamic
//     shared-memory limit, and a window above the 227 KB a block may use
//     is refused.
//
// Numerics: every product and sum is a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into an FMA, so
// both kernels are bitwise equal to their plain PyTorch versions, and
// roll2d is bitwise equal to K1's plain version (the same products added
// in the same order).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kMaxSharedBytes = 227 * 1024;

struct DiaOffsets {
  int count;
  int64_t off[kMaxDiags];
};

__global__ void __launch_bounds__(kThreads)
    noshift_kernel(const float* __restrict__ data, const float* __restrict__ x,
                   float* __restrict__ y, int64_t n, int count) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xi = x[i];
    float acc = __fmul_rn(data[i], xi);
    for (int k = 1; k < count; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(data[k * n + i], xi));
    }
    y[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    roll2d_kernel(const float* __restrict__ data, const float* __restrict__ x,
                  float* __restrict__ y, int64_t n, DiaOffsets offs,
                  int rows, int pad_rows) {
  extern __shared__ float4 window4[];
  float* window = reinterpret_cast<float*>(window4);
  const int64_t first = int64_t(blockIdx.x) * rows * kLanes;
  const int64_t base = first - int64_t(pad_rows) * kLanes;  // multiple of 128
  const int win4 = (rows + 2 * pad_rows) * kLanes / 4;
  for (int t = threadIdx.x; t < win4; t += blockDim.x) {
    const int64_t j = base + 4 * int64_t(t);
    float4 v;
    if (j >= 0 && j + 3 < n) {
      v = reinterpret_cast<const float4*>(x)[j / 4];
    } else {
      v.x = (j >= 0 && j < n) ? x[j] : 0.0f;
      v.y = (j + 1 >= 0 && j + 1 < n) ? x[j + 1] : 0.0f;
      v.z = (j + 2 >= 0 && j + 2 < n) ? x[j + 2] : 0.0f;
      v.w = (j + 3 >= 0 && j + 3 < n) ? x[j + 3] : 0.0f;
    }
    window4[t] = v;
  }
  __syncthreads();
  const int centre = pad_rows * kLanes;
  for (int e = threadIdx.x; e < rows * kLanes; e += blockDim.x) {
    const int64_t i = first + e;
    if (i >= n) break;
    float acc = 0.0f;
    for (int k = 0; k < offs.count; ++k) {
      const float term =
          __fmul_rn(data[k * n + i], window[centre + e + offs.off[k]]);
      acc = k == 0 ? term : __fadd_rn(acc, term);
    }
    y[i] = acc;
  }
}

}  // namespace

extern "C" {

int spectra_dia_noshift_f32(const float* data, const float* x, float* y,
                            int64_t n, int count, void* stream) {
  if (n < 1 || count < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  noshift_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(data, x, y, n, count);
  return static_cast<int>(cudaGetLastError());
}

// x must be 16-byte aligned. pad_rows * 128 must exceed every |offset|
// by at least 128 (the wrapper computes it as the TPU probe did).
int spectra_dia_roll2d_f32(const float* data, const float* x, float* y,
                           int64_t n, const int64_t* offsets, int count,
                           int rows, int pad_rows, void* stream) {
  if (n < 1 || count < 1 || count > kMaxDiags || rows < 1 || pad_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = int64_t(rows + 2 * pad_rows) * kLanes * sizeof(float);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  DiaOffsets offs;
  offs.count = count;
  for (int k = 0; k < count; ++k) {
    offs.off[k] = offsets[k];
    const int64_t a = offsets[k] < 0 ? -offsets[k] : offsets[k];
    if (a + kLanes > int64_t(pad_rows) * kLanes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      roll2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t row_count = (n + kLanes - 1) / kLanes;
  const int64_t blocks = (row_count + rows - 1) / rows;
  roll2d_kernel<<<static_cast<unsigned>(blocks), kThreads,
                  static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(data, x, y, n, offs,
                                                       rows, pad_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
