// DIA (diagonal-storage) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces spectra_tpu/ops/dia_pallas.py::dia_spmv_pallas, the TPU
// kernel behind DiaMatrix.matvec. It computes, for row-aligned DIA
// storage data[k, i] = A[i, i + off_k],
//
//     y[i] = sum_k data[k, i] * x[i + off_k],   0 <= i < n_rows,
//
// where terms with i + off_k outside [0, n_cols) count as zero, and the
// sum runs in offset order starting from k = 0, as the Pallas kernel
// accumulates it. The reference zero-pads x; this kernel guards the
// index instead and never reads out of bounds.
//
// What bounds it: memory. Each output row does d multiply-adds against
// d + 2 values moved, so for d diagonals and n rows the kernel must move
// (d + 2) * n * sizeof(T) bytes (data once, x once, y once): 56 MB in
// f64 for the 5-point Laplacian at n = 10^6, about 16.7 us at an H100
// SXM's 3.35 TB/s, against 10^7 flops that the f64 units finish in
// under 0.3 us.
//
// What the design does about it: one thread per output row in a
// grid-stride loop. Consecutive threads read consecutive data[k * n + i]
// and consecutive (shifted) x[i + off_k], so every load is coalesced.
// The d shifted reads of x overlap; the re-reads of neighbouring rows
// and of the +-g stencil rows come from L1 and L2 (the 8 MB x of the
// 10^6-row case fits the 50 MB L2), so DRAM traffic stays near the
// (d + 2) * n bound. The offsets travel by value in the launch
// parameters (at most 64: 512 bytes of int64, far under the launch
// parameter limit, and above the 40 diagonals a multigrid level may
// have), so one build serves every stencil; the TPU kernel had to fix
// them at trace time. A shared-memory x window or TMA is left for later
// tuning.
//
// Numerics: built with -fmad=false, every term is a rounded multiply
// followed by a rounded add, so the result is bitwise equal to the
// plain PyTorch version (separate * and + in the same order).
//
// X and Y may hold several columns (matmat): element (i, c) lives at
// i * ncol + c in both, and blockIdx.y selects the column.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

struct DiaOffsets {
  int count;
  int64_t off[kMaxDiags];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, int64_t n_rows, int64_t n_cols,
                    int64_t ncol, DiaOffsets offs) {
  const int64_t c = blockIdx.y;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    T acc = T(0);
    for (int k = 0; k < offs.count; ++k) {
      const int64_t j = i + offs.off[k];
      if (j >= 0 && j < n_cols) {
        acc = acc + data[k * n_rows + i] * x[j * ncol + c];
      }
    }
    y[i * ncol + c] = acc;
  }
}

template <typename T>
int launch(const T* data, const T* x, T* y, int64_t n_rows, int64_t n_cols,
           int64_t ncol, const int64_t* offsets, int count, void* stream) {
  if (count < 1 || count > kMaxDiags || n_rows < 1 || ncol < 1 ||
      ncol > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DiaOffsets offs;
  offs.count = count;
  for (int k = 0; k < count; ++k) offs.off[k] = offsets[k];
  int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ncol));
  dia_spmv_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      data, x, y, n_rows, n_cols, ncol, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spectra_dia_spmv_f64(const double* data, const double* x, double* y,
                         int64_t n_rows, int64_t n_cols, int64_t ncol,
                         const int64_t* offsets, int count, void* stream) {
  return launch<double>(data, x, y, n_rows, n_cols, ncol, offsets, count,
                        stream);
}

int spectra_dia_spmv_f32(const float* data, const float* x, float* y,
                         int64_t n_rows, int64_t n_cols, int64_t ncol,
                         const int64_t* offsets, int count, void* stream) {
  return launch<float>(data, x, y, n_rows, n_cols, ncol, offsets, count,
                       stream);
}

}  // extern "C"
