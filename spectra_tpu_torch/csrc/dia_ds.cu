// Double-single (hi/lo f32) DIA sparse matrix-vector product for Hopper
// (sm_90a).
//
// Replaces spectra_tpu/ops/dia_ds.py::_ds_pallas, the TPU kernel behind
// DiaHiLoMatrix.matvec (entry points dia_spmv_ds_padded and
// dia_spmv_ds_ext). The f64 diagonals are stored as two f32 planes
// (hi = f32(a), lo = f32(a - hi)), x is split the same way, and the
// product is accumulated in double-single arithmetic:
//
//     (yh[i], yl[i]) ~ sum_k (dh[k, i] + dl[k, i]) * (xh[j] + xl[j]),
//     j = i + off_k,
//
// about 2^-48 relative. Per row and per diagonal, in offset order, it
// follows the Pallas kernel (spectra_tpu/ops/dia_ds.py:154-176)
// operation for operation: Dekker-split a and xh with 4097, form
// p = a * b and the two-product error
//     err = ((ahh*bhh - p) + ahh*bhl + ahl*bhh) + ahl*bhl + a*bl + al*b,
// Knuth two-sum s += p into (s, e2), add c += err + e2, and finish with
// (yh, yl) = two_sum(s, c).
//
// Three entry points, one kernel body (a template over where x comes from
// and where y goes):
//   * padded: x planes of length n. A column j outside [0, n) is
//     skipped, which adds exactly what the reference's zero padding adds
//     (p = 0, err = 0, two_sum(s, 0) = (s, 0)).
//   * ext: x planes of length lo + n + hi, the halo slots in place of
//     the padding (lo = max(0, -min off), hi = max(0, max off)); x is
//     read at i + lo + off_k with no guard.
//   * f64: x in f64 of length n, y in f64, columns as in padded. Each x
//     value is split where it is read, xh = __double2float_rn(x),
//     xl = __double2float_rn(__dsub_rn(x, xh)), and each row is written
//     as __dadd_rn(yh, yl): the IEEE operations of split_f64 and
//     combine_f64 in ops/dia_ds.py, so this entry is bitwise equal to
//     combine_f64(padded(split_f64(x))) and moves no hi/lo x or y planes
//     through device memory. DiaHiLoMatrix.matvec runs it: one launch
//     per SpMV where the three-step route took eight.
//
// Exactness: the split c - (c - a) and the error terms are exact only if
// no multiply is fused with an add. Every step is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __dsub_rn,
// __dadd_rn), which nvcc never contracts, and the library is also built
// with -fmad=false. So the kernel is bitwise equal to its plain PyTorch
// version, which does the same operations one whole vector at a time.
//
// What bounds it: memory. Per row it reads 2 * 4 * d bytes of planes, x
// once and writes y once: (8d + 16) n bytes for the f64 entry and the
// plane entries alike. At the 3-D g=243 operator (d=7, n=14,348,907)
// that is 1.03 GB, 308 us at an H100 SXM's 3.35 TB/s, against about
// 40 us of f32 arithmetic at 66.9 TFLOP/s. The planes are 78 % of the
// bytes and are read once per SpMV.
//
// What the design does about it: many independent loads in flight per
// thread, where the first version issued one diagonal's loads only after
// the previous diagonal's 23-step dependent chain. Each thread takes two
// consecutive rows: it reads each diagonal's two plane entries of each
// plane as one 8-byte load with the evict-first hint (__ldcs), and issues
// all the plane and x loads of a group of four diagonals before that
// group's arithmetic. The diagonal loop is unrolled at compile time for
// the two counts the north star runs (d = 7 on the operator, d = 27 on
// multigrid level 1) and runs over groups at run time for any other
// count. x is read through L1/L2 (__ldg, 8 bytes in the f64 entry): a
// thread's rows and its warp's neighbours re-read neighbouring values
// from L1, and the +-g and +-g^2 windows of a 3-D stencil (about 1 MB at
// g=243) stay in L2. y is written with streaming stores (__stcs). On an
// H100 (PERF.md), one row a thread was 2.4 % slower at g=243 and 1.2 %
// at multigrid level 1, four rows with 16-byte loads 2-10 % slower, groups
// of eight diagonals no faster than four, and plain loads and stores up
// to 1.9 % slower than the hints. The vector loads need the planes' leading
// dimension ld to be a multiple of kRows and the planes aligned
// (DiaHiLoMatrix pads ld to a multiple of 32); other planes take the same
// body with 4-byte loads. Rows whose columns may leave [0, n), and a last
// partial group of rows, run the guarded one-row loop. A shared-memory x
// window is not used: the card's probe of that layout
// (csrc/dia_variants.cu, dia_roll2d) was slower than the plain shifted
// reads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int kRows = 2;   // consecutive rows per thread
constexpr int kGroup = 4;  // diagonals whose loads are issued together
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr float kSplit = 4097.0f;  // 2^12 + 1, the f32 Dekker constant

enum Mode : int { kPadded = 0, kExt = 1, kF64 = 2 };

struct DsOffsets {
  int count;
  int64_t off[kMaxDiags];
};

struct DsArgs {
  const float* dh;
  const float* dl;
  int64_t ld;
  const float* xh;  // x planes (padded, ext)
  const float* xl;
  const double* x;  // f64 x (f64)
  float* yh;        // y planes (padded, ext)
  float* yl;
  double* y;  // f64 y (f64)
  int64_t n;
  int64_t lo;  // x index of column 0 (ext: the low halo; else 0)
  int64_t min_off;
  int64_t max_off;
};

// The vector types that move kRows consecutive f32 or f64 values.
using FVec = float2;
using DVec = double2;
static_assert(sizeof(FVec) == kRows * sizeof(float) &&
              sizeof(DVec) == kRows * sizeof(double));

__device__ __forceinline__ void dekker_split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, kSplit);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// One diagonal's term of one row: (s, c) += (a + al) * (b + bl).
__device__ __forceinline__ void ds_step(float a, float al, float b, float bl,
                                        float& s, float& c) {
  float ahh, ahl, bhh, bhl;
  dekker_split(b, bhh, bhl);
  const float p = __fmul_rn(a, b);
  dekker_split(a, ahh, ahl);
  float err = __fadd_rn(__fsub_rn(__fmul_rn(ahh, bhh), p),
                        __fmul_rn(ahh, bhl));
  err = __fadd_rn(err, __fmul_rn(ahl, bhh));
  err = __fadd_rn(err, __fmul_rn(ahl, bhl));
  err = __fadd_rn(err, __fmul_rn(a, bl));
  err = __fadd_rn(err, __fmul_rn(al, b));
  float e2;
  two_sum(s, p, s, e2);
  c = __fadd_rn(c, __fadd_rn(err, e2));
}

// (xh, xl) of column j: read from the planes, or split from f64 x.
template <int kMode>
__device__ __forceinline__ void fetch_x(const DsArgs& A, int64_t j, float& b,
                                        float& bl) {
  if constexpr (kMode == kF64) {
    const double v = __ldg(A.x + j);
    b = __double2float_rn(v);
    bl = __double2float_rn(__dsub_rn(v, static_cast<double>(b)));
  } else {
    b = __ldg(A.xh + j);
    bl = __ldg(A.xl + j);
  }
}

__device__ __forceinline__ double combine(float h, float l) {
  return __dadd_rn(static_cast<double>(h), static_cast<double>(l));
}

template <int kMode>
__device__ __forceinline__ void store_row(const DsArgs& A, int64_t i, float s,
                                          float c) {
  float h, l;
  two_sum(s, c, h, l);
  if constexpr (kMode == kF64) {
    A.y[i] = combine(h, l);
  } else {
    A.yh[i] = h;
    A.yl[i] = l;
  }
}

template <int kMode, bool kVec>
__device__ __forceinline__ void store_rows(const DsArgs& A, int64_t i0,
                                           const float (&s)[kRows],
                                           const float (&c)[kRows]) {
  if constexpr (!kVec) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) store_row<kMode>(A, i0 + r, s[r], c[r]);
  } else if constexpr (kMode == kF64) {
    DVec y;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float h, l;
      two_sum(s[r], c[r], h, l);
      reinterpret_cast<double*>(&y)[r] = combine(h, l);
    }
    __stcs(reinterpret_cast<DVec*>(A.y + i0), y);
  } else {
    FVec h, l;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      two_sum(s[r], c[r], reinterpret_cast<float*>(&h)[r],
              reinterpret_cast<float*>(&l)[r]);
    }
    __stcs(reinterpret_cast<FVec*>(A.yh + i0), h);
    __stcs(reinterpret_cast<FVec*>(A.yl + i0), l);
  }
}

// Diagonal k's plane entries of rows i0 .. i0 + kRows - 1.
template <bool kVec>
__device__ __forceinline__ void load_planes(const DsArgs& A, int k, int64_t i0,
                                            float (&a)[kRows],
                                            float (&al)[kRows]) {
  const int64_t at = k * A.ld + i0;
  if constexpr (kVec) {
    const FVec h = __ldcs(reinterpret_cast<const FVec*>(A.dh + at));
    const FVec l = __ldcs(reinterpret_cast<const FVec*>(A.dl + at));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a[r] = reinterpret_cast<const float*>(&h)[r];
      al[r] = reinterpret_cast<const float*>(&l)[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a[r] = __ldcs(A.dh + at + r);
      al[r] = __ldcs(A.dl + at + r);
    }
  }
}

// Diagonals k0 .. k0 + kG - 1 of rows i0 .. i0 + kRows - 1, every
// column in range: all loads first, then the arithmetic, each row's
// terms in offset order.
template <int kMode, bool kVec, int kG>
__device__ __forceinline__ void diag_group(const DsArgs& A,
                                           const DsOffsets& offs, int k0,
                                           int64_t i0, float (&s)[kRows],
                                           float (&c)[kRows]) {
  float a[kG][kRows], al[kG][kRows], b[kG][kRows], bl[kG][kRows];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    load_planes<kVec>(A, k0 + g, i0, a[g], al[g]);
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int64_t j = A.lo + i0 + offs.off[k0 + g];
#pragma unroll
    for (int r = 0; r < kRows; ++r) fetch_x<kMode>(A, j + r, b[g][r], bl[g][r]);
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ds_step(a[g][r], al[g][r], b[g][r], bl[g][r], s[r], c[r]);
    }
  }
}

// Diagonals kK0 .. kD - 1, in groups of kGroup, the count known at
// compile time.
template <int kMode, bool kVec, int kK0, int kD>
__device__ __forceinline__ void diag_groups(const DsArgs& A,
                                            const DsOffsets& offs, int64_t i0,
                                            float (&s)[kRows],
                                            float (&c)[kRows]) {
  if constexpr (kK0 < kD) {
    constexpr int kG = kD - kK0 < kGroup ? kD - kK0 : kGroup;
    diag_group<kMode, kVec, kG>(A, offs, kK0, i0, s, c);
    diag_groups<kMode, kVec, kK0 + kG, kD>(A, offs, i0, s, c);
  }
}

// Rows i0 .. i0 + kRows - 1, all inside [0, n) with every column in
// range. kD > 0: the diagonal count, known at compile time; 0: offs.count.
template <int kMode, int kD, bool kVec>
__device__ __forceinline__ void rows_inside(const DsArgs& A,
                                            const DsOffsets& offs,
                                            int64_t i0) {
  float s[kRows], c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.0f, c[r] = 0.0f;
  if constexpr (kD > 0) {
    diag_groups<kMode, kVec, 0, kD>(A, offs, i0, s, c);
  } else {
    int k0 = 0;
    for (; k0 + kGroup <= offs.count; k0 += kGroup) {
      diag_group<kMode, kVec, kGroup>(A, offs, k0, i0, s, c);
    }
    for (; k0 < offs.count; ++k0) {
      diag_group<kMode, kVec, 1>(A, offs, k0, i0, s, c);
    }
  }
  store_rows<kMode, kVec>(A, i0, s, c);
}

// One row with scalar loads; in the padded and f64 entries a column
// outside [0, n) is skipped.
template <int kMode>
__device__ __forceinline__ void row_guarded(const DsArgs& A,
                                         const DsOffsets& offs, int64_t i) {
  float s = 0.0f;
  float c = 0.0f;
  for (int k = 0; k < offs.count; ++k) {
    const int64_t j = A.lo + i + offs.off[k];
    if (kMode != kExt && (j < 0 || j >= A.n)) continue;
    float b, bl;
    fetch_x<kMode>(A, j, b, bl);
    ds_step(__ldcs(A.dh + k * A.ld + i), __ldcs(A.dl + k * A.ld + i), b, bl,
            s, c);
  }
  store_row<kMode>(A, i, s, c);
}

template <int kMode, int kD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dia_ds_kernel(const __grid_constant__ DsArgs A,
                  const __grid_constant__ DsOffsets offs) {
  const int64_t groups = (A.n + kRows - 1) / kRows;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < groups; t += stride) {
    const int64_t i0 = t * kRows;
    const bool whole = i0 + kRows <= A.n;
    const bool inside =
        kMode == kExt ||
        (i0 + A.min_off >= 0 && i0 + (kRows - 1) + A.max_off < A.n);
    if (whole && inside) {
      rows_inside<kMode, kD, kVec>(A, offs, i0);
    } else {
      for (int r = 0; r < kRows && i0 + r < A.n; ++r) {
        row_guarded<kMode>(A, offs, i0 + r);
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}


template <int kMode>
int launch(DsArgs A, const int64_t* offsets, int count, void* stream) {
  if (count < 1 || count > kMaxDiags || A.n < 1 || A.ld < A.n || A.lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DsOffsets offs;
  offs.count = count;
  A.min_off = A.max_off = offsets[0];
  for (int k = 0; k < count; ++k) {
    offs.off[k] = offsets[k];
    if (offsets[k] < A.min_off) A.min_off = offsets[k];
    if (offsets[k] > A.max_off) A.max_off = offsets[k];
  }
  const size_t f = sizeof(FVec);
  const bool vec = A.ld % kRows == 0 && aligned(A.dh, f) && aligned(A.dl, f) &&
                   (kMode == kF64 ? aligned(A.y, sizeof(DVec))
                                  : aligned(A.yh, f) && aligned(A.yl, f));
  int64_t blocks = ((A.n + kRows - 1) / kRows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vec) {
    dia_ds_kernel<kMode, 0, false><<<grid, kThreads, 0, st>>>(A, offs);
  } else if (count == 7) {
    dia_ds_kernel<kMode, 7, true><<<grid, kThreads, 0, st>>>(A, offs);
  } else if (count == 27) {
    dia_ds_kernel<kMode, 27, true><<<grid, kThreads, 0, st>>>(A, offs);
  } else {
    dia_ds_kernel<kMode, 0, true><<<grid, kThreads, 0, st>>>(A, offs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x planes of length n; columns outside [0, n) are skipped.
int spectra_dia_ds_padded(const float* dh, const float* dl, int64_t ld,
                          const float* xh, const float* xl, float* yh,
                          float* yl, int64_t n, const int64_t* offsets,
                          int count, void* stream) {
  DsArgs A{dh, dl, ld, xh, xl, nullptr, yh, yl, nullptr, n, 0, 0, 0};
  return launch<kPadded>(A, offsets, count, stream);
}

// x planes of length lo + n + hi (halo-extended); no guard.
int spectra_dia_ds_ext(const float* dh, const float* dl, int64_t ld,
                       const float* xh, const float* xl, float* yh,
                       float* yl, int64_t n, int64_t lo,
                       const int64_t* offsets, int count, void* stream) {
  DsArgs A{dh, dl, ld, xh, xl, nullptr, yh, yl, nullptr, n, lo, 0, 0};
  return launch<kExt>(A, offsets, count, stream);
}

// f64 x of length n in, f64 y out; columns outside [0, n) are skipped.
int spectra_dia_ds_f64(const float* dh, const float* dl, int64_t ld,
                       const double* x, double* y, int64_t n,
                       const int64_t* offsets, int count, void* stream) {
  DsArgs A{dh, dl, ld, nullptr, nullptr, x, nullptr, nullptr, y, n, 0, 0, 0};
  return launch<kF64>(A, offsets, count, stream);
}

}  // extern "C"
