// The row body shared by K1 (dia_spmv.cu) and its cost probe P3
// (dia_noshift in dia_variants.cu), so that the probe's gap to K1
// measures the shifted reads of x and nothing else.
//
// For row-aligned DIA storage data[k, i] = A[i, i + off_k] a thread
// computes one row,
//
//     y[i] = sum_k data[k, i] * x[i + off_k]        (kShift, K1)
//     y[i] = sum_k data[k, i] * x[i]                (!kShift, P3)
//
// every term a rounded product (__dmul_rn / __fmul_rn) added in offset
// order (__dadd_rn / __fadd_rn), which nvcc never contracts into an FMA.
// K1 starts each row from +0 and adds every term, reading x as zero
// outside [0, n_cols): that is what the plain PyTorch version computes
// on its zero-padded x, so the two agree bitwise whatever the data holds
// at out-of-range positions. P3 starts from its first term, as its plain
// version does.
//
// Loads in flight. A row's loads depend on nothing but its index, and
// each thread issues all loads of a group of diagonals before that
// group's arithmetic: all of them for the counts the solver paths launch
// (d = 5, 7, 9 and 27, unrolled), groups of kGenericGroup for any other
// count. Two ways to issue them:
//   * registers (kAsync false): plain loads into registers. ptxas
//     interleaves them with the multiply-adds to save registers (32 a
//     thread at d = 27, about two diagonals ahead), so a row waits on a
//     few trips to memory in turn; with enough rows on the card the other
//     warps hide that. The large matrices take this path.
//   * staged (kAsync true): every value goes global -> shared memory by
//     cp.async (8 or 4 bytes each, an out-of-range x as a zero fill of
//     the copy), one wait, then the arithmetic from shared memory. All
//     of a row's loads are in flight at once whatever ptxas schedules, at
//     the price of 2 * d * sizeof(T) bytes of shared memory a thread. The
//     small matrices (the north star's 31^3 and 16^3 multigrid levels),
//     whose rows are too few to hide the latency with warps, take this
//     path.
// A thread whose columns all lie in [0, n_cols) reads x without a guard;
// a thread at the matrix's edge clamps the column into range and zeroes
// the value (a select, or the copy's zero fill), so every load is
// unconditional.
//
// Grid: thread t of block b takes row (b + s * gridDim.x) * blockDim.x +
// t on trip s of a grid-stride loop, so each warp's loads are coalesced.
// One vector only: K1 on a block of columns is dia_block.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spectra_dia {

constexpr int kMaxDiags = 64;
constexpr int kMaxThreads = 256;
constexpr int kGenericGroup = 8;
constexpr int64_t kMaxBlocks = 1 << 20;

struct Offsets {
  int count;
  int64_t off[kMaxDiags];
};

template <typename T>
struct Args {
  const T* data;
  const T* x;
  T* y;
  int64_t n_rows;
  int64_t n_cols;
  int64_t min_off;
  int64_t max_off;
};

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// Diagonals of one group: all of an unrolled count, else kGenericGroup.
__host__ __device__ constexpr int group_size(int d) {
  return d > 0 ? d : kGenericGroup;
}

// One value global -> shared by cp.async (cached in L1); with keep false
// it writes +0 and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool keep) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to),
               "l"(src), "n"(sizeof(T)), "r"(keep ? int(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Where a thread stages a group (kAsync): data value g at base[g *
// stride], x value g at base[x_at + g * stride]; a thread reads back
// only what it copied.
template <typename T>
struct Stage {
  T* base;     // shared memory + threadIdx.x
  int stride;  // blockDim.x
  int x_at;    // group_size(kD) * blockDim.x
};

// Column j of x, clamped into [0, n_cols) with kGuard; `in` says
// whether j itself lies there.
template <typename T, bool kGuard>
__device__ __forceinline__ const T* x_at(const Args<T>& A, int64_t j,
                                         bool& in) {
  in = true;
  if constexpr (kGuard) {
    in = j >= 0 && j < A.n_cols;
    j = j < 0 ? 0 : (j < A.n_cols ? j : A.n_cols - 1);
  }
  return A.x + j;
}

// Diagonals k0 .. k0 + kG - 1 of row i: all loads, then the terms in
// offset order.
template <typename T, int kG, bool kShift, bool kGuard, bool kAsync>
__device__ __forceinline__ void diag_group(const Args<T>& A,
                                           const Offsets& offs, int k0,
                                           int64_t i, T xi,
                                           const Stage<T>& st, T& acc) {
  T a[kG];
  T b[kG];
  if constexpr (kAsync) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      copy_async(st.base + g * st.stride, A.data + (k0 + g) * A.n_rows + i, true);
      if constexpr (kShift) {
        bool in;
        const T* src = x_at<T, kGuard>(A, i + offs.off[k0 + g], in);
        copy_async(st.base + st.x_at + g * st.stride, src, in);
      }
    }
    wait_async();
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      a[g] = st.base[g * st.stride];
      b[g] = kShift ? st.base[st.x_at + g * st.stride] : xi;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) a[g] = __ldg(A.data + (k0 + g) * A.n_rows + i);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if constexpr (kShift) {
        bool in;
        const T v = __ldg(x_at<T, kGuard>(A, i + offs.off[k0 + g], in));
        b[g] = in ? v : T(0);
      } else {
        b[g] = xi;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const T t = mul_rn(a[g], b[g]);
    acc = (kShift || k0 + g > 0) ? add_rn(acc, t) : t;
  }
}

// Row i. kD > 0: the diagonal count, known at compile time; 0:
// offs.count.
template <typename T, int kD, bool kShift, bool kGuard, bool kAsync>
__device__ __forceinline__ T row_body(const Args<T>& A, const Offsets& offs,
                                      int64_t i, const Stage<T>& st) {
  const T xi = kShift ? T(0) : __ldg(A.x + i);
  T acc = T(0);
  if constexpr (kD > 0) {
    diag_group<T, kD, kShift, kGuard, kAsync>(A, offs, 0, i, xi, st, acc);
  } else {
    int k0 = 0;
    for (; k0 + kGenericGroup <= offs.count; k0 += kGenericGroup) {
      diag_group<T, kGenericGroup, kShift, kGuard, kAsync>(A, offs, k0, i, xi,
                                                           st, acc);
    }
    for (; k0 < offs.count; ++k0) {
      diag_group<T, 1, kShift, kGuard, kAsync>(A, offs, k0, i, xi, st, acc);
    }
  }
  return acc;
}

template <typename T, int kD, bool kShift, bool kAsync>
__global__ void __launch_bounds__(kMaxThreads)
    dia_rows_kernel(const __grid_constant__ Args<T> A,
                    const __grid_constant__ Offsets offs) {
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  const Stage<T> st{reinterpret_cast<T*>(stage_bytes) + threadIdx.x,
                    int(blockDim.x), group_size(kD) * int(blockDim.x)};
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < A.n_rows; i += int64_t(gridDim.x) * blockDim.x) {
    const bool inside =
        !kShift || (i + A.min_off >= 0 && i + A.max_off < A.n_cols);
    A.y[i] = inside ? row_body<T, kD, kShift, false, kAsync>(A, offs, i, st)
                    : row_body<T, kD, kShift, true, kAsync>(A, offs, i, st);
  }
}

template <typename T, int kD, bool kShift, bool kAsync>
cudaError_t start(const Args<T>& A, const Offsets& offs, int blocks,
                  int threads, cudaStream_t stream) {
  auto* kernel = dia_rows_kernel<T, kD, kShift, kAsync>;
  size_t smem = 0;
  if constexpr (kAsync) {
    smem = size_t(2) * group_size(kD) * threads * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return err;
    }
  }
  kernel<<<blocks, threads, smem, stream>>>(A, offs);
  return cudaGetLastError();
}

template <typename T, bool kShift, bool kAsync>
cudaError_t start_vector(const Args<T>& A, const Offsets& offs, int blocks,
                         int threads, cudaStream_t stream) {
  switch (offs.count) {
    case 5: return start<T, 5, kShift, kAsync>(A, offs, blocks, threads, stream);
    case 7: return start<T, 7, kShift, kAsync>(A, offs, blocks, threads, stream);
    case 9: return start<T, 9, kShift, kAsync>(A, offs, blocks, threads, stream);
    case 27: return start<T, 27, kShift, kAsync>(A, offs, blocks, threads, stream);
    default: return start<T, 0, kShift, kAsync>(A, offs, blocks, threads, stream);
  }
}

constexpr bool block_size_ok(int threads) {
  return threads == 32 || threads == 64 || threads == 128 || threads == 256;
}

// The kernel's copy of `count` offsets, and their least and greatest.
inline Offsets fill_offsets(const int64_t* offsets, int count,
                            int64_t& min_off, int64_t& max_off) {
  Offsets offs;
  offs.count = count;
  min_off = max_off = offsets[0];
  for (int k = 0; k < count; ++k) {
    offs.off[k] = offsets[k];
    if (offsets[k] < min_off) min_off = offsets[k];
    if (offsets[k] > max_off) max_off = offsets[k];
  }
  return offs;
}

// Checks the launch, fills the offsets and their range and starts the
// kernel on `stream`: threads in {32, 64, 128, 256}, staged (1) or not
// (0).
template <typename T, bool kShift>
int launch(Args<T> A, const int64_t* offsets, int count, int threads,
           int staged, void* stream) {
  if (count < 1 || count > kMaxDiags || A.n_rows < 1 || A.n_cols < 1 ||
      !block_size_ok(threads) || staged < 0 || staged > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Offsets offs = fill_offsets(offsets, count, A.min_off, A.max_off);
  int64_t blocks = (A.n_rows + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      staged ? start_vector<T, kShift, true>(A, offs, int(blocks), threads, st)
             : start_vector<T, kShift, false>(A, offs, int(blocks), threads, st));
}

}  // namespace spectra_dia
