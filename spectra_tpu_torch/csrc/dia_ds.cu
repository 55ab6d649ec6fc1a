// Double-single (hi/lo f32) DIA sparse matrix-vector product for Hopper
// (sm_90a).
//
// Replaces spectra_tpu/ops/dia_ds.py::_ds_pallas, the TPU kernel behind
// DiaHiLoMatrix.matvec (entry points dia_spmv_ds_padded and
// dia_spmv_ds_ext). The f64 diagonals are stored as two f32 planes
// (hi = f32(a), lo = f32(a - hi)), x arrives as two f32 planes the same
// way, and the product is accumulated in double-single arithmetic:
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
// Two entry points, as in the reference:
//   * padded: x planes of length n. A column j outside [0, n) is
//     skipped, which adds exactly what the reference's zero padding adds
//     (p = 0, err = 0, two_sum(s, 0) = (s, 0)).
//   * ext: x planes of length lo + n + hi, the halo slots in place of
//     the padding (lo = max(0, -min off), hi = max(0, max off)); x is
//     read at i + lo + off_k with no guard.
//
// Exactness: the split c - (c - a) and the error terms are exact only if
// no multiply is fused with an add. Every step is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which
// nvcc never contracts, and the library is also built with -fmad=false.
// So the kernel is bitwise equal to its plain PyTorch version, which
// does the same f32 operations one whole vector at a time.
//
// What bounds it: memory. Per row it reads 4 * 2 * d bytes of planes and
// 8 bytes of x planes and writes 8 bytes of y planes against about 23 f32
// operations per diagonal: at the 3-D g=243 operator (d=7,
// n=14,348,907) that is 1.03 GB, 308 us at an H100 SXM's 3.35 TB/s,
// against 34 us of f32 arithmetic at 66.9 TFLOP/s.
//
// What the design does about it: one thread per row in a grid-stride
// loop, as the port's K1 (csrc/dia_spmv.cu). Neighbouring threads read
// neighbouring plane entries and neighbouring shifted x entries, so
// every load is coalesced; the d shifted reads of x overlap and the
// re-reads come from L1/L2. The offsets (at most 64) travel by value in
// the launch parameters. The planes may have a leading dimension ld >= n
// (the reference pads them to a multiple of its chunk). There are no
// chunks, windows or VMEM budget to carry over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr float kSplit = 4097.0f;  // 2^12 + 1, the f32 Dekker constant

struct DsOffsets {
  int count;
  int64_t off[kMaxDiags];
};

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

template <bool kExt>
__global__ void __launch_bounds__(kThreads)
    dia_ds_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
                  int64_t ld, const float* __restrict__ xh,
                  const float* __restrict__ xl, float* __restrict__ yh,
                  float* __restrict__ yl, int64_t n, int64_t lo,
                  DsOffsets offs) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = 0.0f;
    float c = 0.0f;
    for (int k = 0; k < offs.count; ++k) {
      int64_t j;
      if (kExt) {
        j = i + lo + offs.off[k];
      } else {
        j = i + offs.off[k];
        if (j < 0 || j >= n) continue;
      }
      const float a = dh[k * ld + i];
      const float al = dl[k * ld + i];
      const float b = xh[j];
      const float bl = xl[j];
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
    float h, l;
    two_sum(s, c, h, l);
    yh[i] = h;
    yl[i] = l;
  }
}

template <bool kExt>
int launch(const float* dh, const float* dl, int64_t ld, const float* xh,
           const float* xl, float* yh, float* yl, int64_t n, int64_t lo,
           const int64_t* offsets, int count, void* stream) {
  if (count < 1 || count > kMaxDiags || n < 1 || ld < n || lo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DsOffsets offs;
  offs.count = count;
  for (int k = 0; k < count; ++k) offs.off[k] = offsets[k];
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dia_ds_kernel<kExt><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dh, dl, ld, xh, xl, yh, yl, n, lo, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x planes of length n; columns outside [0, n) are skipped.
int spectra_dia_ds_padded(const float* dh, const float* dl, int64_t ld,
                          const float* xh, const float* xl, float* yh,
                          float* yl, int64_t n, const int64_t* offsets,
                          int count, void* stream) {
  return launch<false>(dh, dl, ld, xh, xl, yh, yl, n, 0, offsets, count,
                       stream);
}

// x planes of length lo + n + hi (halo-extended); no guard.
int spectra_dia_ds_ext(const float* dh, const float* dl, int64_t ld,
                       const float* xh, const float* xl, float* yh,
                       float* yl, int64_t n, int64_t lo,
                       const int64_t* offsets, int count, void* stream) {
  return launch<true>(dh, dl, ld, xh, xl, yh, yl, n, lo, offsets, count,
                      stream);
}

}  // extern "C"
