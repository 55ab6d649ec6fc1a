// K1 on a block of columns (DiaMatrix.matmat): for row-aligned DIA
// storage data[k, i] = A[i, i + off_k] and row-major X (n_cols, ncol),
// Y (n_rows, ncol),
//
//     Y[i, c] = sum_k data[k, i] * X[i + off_k, c],
//
// X zero outside rows [0, n_cols), each sum from +0 in offset order,
// every term a rounded product then a rounded add (mul_rn, add_rn: never
// an FMA), so the result is bitwise the plain version's
// (ops/dia_spmv.py::dia_spmv_plain).
//
// Flat addressing. Element (i, c) of X or Y is element e = i * ncol + c
// of a flat array, and X[i + off, c] is x[e + off * ncol], which exists
// iff 0 <= e + off * ncol < n_cols * ncol (as c < ncol). A thread takes
// a pack of kV consecutive elements of one row (16 bytes where ncol and
// the pointers allow it, else 8 or sizeof(T)), consecutive threads
// consecutive packs: every diagonal's X loads and the Y stores of a warp
// are contiguous.
//
// The data read once. A CTA takes a tile of tile_rows rows and all their
// columns (a grid-stride loop over tiles), copies data[:, r0:r0 + rows]
// into shared memory by cp.async once, and each thread reads its row's d
// values there. A thread issues its pack's X loads before it waits for
// that copy (for the unrolled diagonal count), so the two trips to memory
// overlap. The far offsets' X windows are read from L2: the tiles they
// fall on are in flight at the same time.

#pragma once

#include "dia_rows.cuh"

namespace spectra_dia {

template <typename T>
struct BlockArgs {
  const T* data;
  const T* x;
  T* y;
  int64_t n_rows;
  int64_t n_cols;
  int64_t ncol;
  int64_t x_len;  // n_cols * ncol
  int tile_rows;
  int64_t tiles;
  int64_t min_off;
  int64_t max_off;
};

// kV consecutive elements of one row of X or Y.
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Pack {
  T v[kV];
};

template <typename T, int kV>
__device__ __forceinline__ Pack<T, kV> load_pack(const T* p) {
  Pack<T, kV> out;
  if constexpr (kV == 1) {
    out.v[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 8) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
  } else if constexpr (kV == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
  } else {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  }
  return out;
}

template <typename T, int kV>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, kV>& in) {
  if constexpr (kV == 1) {
    *p = in.v[0];
  } else if constexpr (sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(in.v[0], in.v[1]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in.v[0], in.v[1]);
  } else {
    *reinterpret_cast<float4*>(p) =
        make_float4(in.v[0], in.v[1], in.v[2], in.v[3]);
  }
}

// X's packs of diagonals k0 .. k0 + kG - 1 for the pack at flat element
// e; with kGuard a pack outside x reads x[0] and is zeroed.
template <typename T, int kV, int kG, bool kGuard>
__device__ __forceinline__ void load_x(const BlockArgs<T>& A,
                                       const Offsets& offs, int k0, int64_t e,
                                       Pack<T, kV> (&b)[kG]) {
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int64_t src = e + offs.off[k0 + g] * A.ncol;
    if constexpr (kGuard) {
      const bool in = src >= 0 && src < A.x_len;
      b[g] = load_pack<T, kV>(A.x + (in ? src : 0));
      if (!in) b[g] = Pack<T, kV>{};
    } else {
      b[g] = load_pack<T, kV>(A.x + src);
    }
  }
}

// The terms of diagonals k0 .. k0 + kG - 1, in offset order; `a` is the
// row's staged value of diagonal k0, the next diagonal `stride` further.
template <typename T, int kV, int kG>
__device__ __forceinline__ void add_terms(const T* a, int stride,
                                          const Pack<T, kV> (&b)[kG],
                                          Pack<T, kV>& acc) {
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const T ag = a[g * stride];
#pragma unroll
    for (int v = 0; v < kV; ++v) acc.v[v] = add_rn(acc.v[v], mul_rn(ag, b[g].v[v]));
  }
}

template <typename T, int kV, int kG>
__device__ __forceinline__ void load_x_at(const BlockArgs<T>& A,
                                          const Offsets& offs, int k0,
                                          int64_t e, bool inside,
                                          Pack<T, kV> (&b)[kG]) {
  if (inside) {
    load_x<T, kV, kG, false>(A, offs, k0, e, b);
  } else {
    load_x<T, kV, kG, true>(A, offs, k0, e, b);
  }
}

// kD > 0: the diagonal count, known at compile time (all of a pack's X
// loads, b, go out before the wait for the staged data); 0: offs.count,
// in groups of kGenericGroup after the wait.
template <typename T, int kV, int kD>
__global__ void __launch_bounds__(kMaxThreads)
    dia_block_kernel(const __grid_constant__ BlockArgs<T> A,
                     const __grid_constant__ Offsets offs) {
  extern __shared__ __align__(16) unsigned char tile_bytes[];
  T* const staged = reinterpret_cast<T*>(tile_bytes);  // [d][tile_rows]
  const int R = A.tile_rows;
  const unsigned ncol = unsigned(A.ncol);
  for (int64_t t = blockIdx.x; t < A.tiles; t += gridDim.x) {
    const int64_t r0 = t * R;
    const int rows = int(A.n_rows - r0 < R ? A.n_rows - r0 : R);
    for (int j = threadIdx.x; j < offs.count * rows; j += blockDim.x) {
      const int k = j / rows;
      const int r = j - k * rows;
      copy_async(staged + k * R + r, A.data + k * A.n_rows + r0 + r, true);
    }
    const bool inside =
        r0 + A.min_off >= 0 && r0 + rows - 1 + A.max_off < A.n_cols;
    const int packs = rows * int(ncol / kV);
    for (int base = 0; base < packs; base += blockDim.x) {
      const int p = base + threadIdx.x;
      const bool active = p < packs;
      const int r = int(unsigned(p * kV) / ncol);
      const int64_t e = r0 * A.ncol + int64_t(p) * kV;
      Pack<T, kV> acc{};
      Pack<T, kV> b[kD > 0 ? kD : 1];
      if constexpr (kD > 0) {
        if (active) load_x_at<T, kV, kD>(A, offs, 0, e, inside, b);
      }
      if (base == 0) {  // every thread of the CTA takes this trip
        wait_async();
        __syncthreads();
      }
      if (!active) continue;
      if constexpr (kD > 0) {
        add_terms<T, kV, kD>(staged + r, R, b, acc);
      } else {
        int k0 = 0;
        for (; k0 + kGenericGroup <= offs.count; k0 += kGenericGroup) {
          Pack<T, kV> group[kGenericGroup];
          load_x_at<T, kV, kGenericGroup>(A, offs, k0, e, inside, group);
          add_terms<T, kV, kGenericGroup>(staged + k0 * R + r, R, group, acc);
        }
        for (; k0 < offs.count; ++k0) {
          Pack<T, kV> one[1];
          load_x_at<T, kV, 1>(A, offs, k0, e, inside, one);
          add_terms<T, kV, 1>(staged + k0 * R + r, R, one, acc);
        }
      }
      store_pack<T, kV>(A.y + e, acc);
    }
    __syncthreads();  // the next tile's copy overwrites the staged data
  }
}

template <typename T, int kV, int kD>
cudaError_t start_block(const BlockArgs<T>& A, const Offsets& offs,
                        int blocks, int threads, size_t smem,
                        cudaStream_t stream) {
  auto* kernel = dia_block_kernel<T, kV, kD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(A, offs);
  return cudaGetLastError();
}

template <typename T, int kV>
cudaError_t start_block_d(const BlockArgs<T>& A, const Offsets& offs,
                          int blocks, int threads, size_t smem,
                          cudaStream_t stream) {
  return offs.count == 5
             ? start_block<T, kV, 5>(A, offs, blocks, threads, smem, stream)
             : start_block<T, kV, 0>(A, offs, blocks, threads, smem, stream);
}

// The widest pack (at most 16 bytes) that divides ncol and keeps x's and
// y's packs aligned.
template <typename T>
int pack_width(const BlockArgs<T>& A) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(A.x) |
                       reinterpret_cast<uintptr_t>(A.y);
  for (int v = int(16 / sizeof(T)); v > 1; v /= 2) {
    if (A.ncol % v == 0 && at % (v * sizeof(T)) == 0) return v;
  }
  return 1;
}

// Checks the launch, fills the offsets and their range and starts the
// block kernel on `stream`: threads in {32, 64, 128, 256}, tiles of
// tile_rows rows whose staged data fits a CTA's shared memory.
template <typename T>
int launch_block(BlockArgs<T> A, const int64_t* offsets, int count,
                 int threads, void* stream) {
  const size_t smem = size_t(count) * size_t(A.tile_rows) * sizeof(T);
  if (count < 1 || count > kMaxDiags || A.n_rows < 1 || A.n_cols < 1 ||
      A.ncol < 1 || A.ncol > 65535 || !block_size_ok(threads) ||
      A.tile_rows < 1 || int64_t(A.tile_rows) * A.ncol > (int64_t(1) << 30) ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Offsets offs = fill_offsets(offsets, count, A.min_off, A.max_off);
  A.x_len = A.n_cols * A.ncol;
  A.tiles = (A.n_rows + A.tile_rows - 1) / A.tile_rows;
  const int blocks = int(A.tiles < kMaxBlocks ? A.tiles : kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kWide = int(16 / sizeof(T));  // 2 in f64, 4 in f32
  const int width = pack_width(A);
  const cudaError_t err =
      width == kWide ? start_block_d<T, kWide>(A, offs, blocks, threads, smem, st)
      : width == 2   ? start_block_d<T, 2>(A, offs, blocks, threads, smem, st)
                     : start_block_d<T, 1>(A, offs, blocks, threads, smem, st);
  return static_cast<int>(err);
}

}  // namespace spectra_dia
