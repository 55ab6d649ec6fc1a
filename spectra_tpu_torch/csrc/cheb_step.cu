// One step of the Chebyshev filter's three-term recurrence for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these passes to XLA
// (spectra_tpu/matop/chebyshev.py::ChebyshevFilteredOp.perform_op). On
// the card it takes the place of the five PyTorch elementwise launches
// that followed each product y = A t of the filter
// (spectra_tpu_torch/matop/chebyshev.py): c * t, the subtraction, / h,
// 2 * and - t_prev. It writes
//
//   first step:   t_1     = (y - c t) / h
//   later steps:  t_{k+1} = 2 (y - c t) / h - t_prev
//
// bit for bit as those launches did (a complex vector comes as its
// interleaved real view, 2n reals: c and h are real, so each part is a
// real recurrence of its own, and on finite parts PyTorch's complex
// sequence gives the same bits): every operation rounded on its own
// in their order (__dmul_rn, __dsub_rn, __fmul_rn, __fsub_rn, and the
// sources build with -fmad=false), and the division done as PyTorch's
// CUDA division by a Python scalar does it, as a multiply by the
// scalar's reciprocal (aten/src/ATen/native/cuda/BinaryDivTrueKernel.cu).
// For f32 that reciprocal is 1 / h in double rounded to float, and c * t
// multiplies by c rounded to float: on an H100 with PyTorch 2.11 only
// these matched its results bitwise, where 1.0f / float(h), a true
// division by float(h) and products in double each differed from it in
// 10-75 % of the elements. The multiply by 2 is exact.
//
// What bounds it: memory. It reads y, t and t_prev and writes t_{k+1},
// each once: 32 bytes an element in f64, 32 MB at n = 10^6, 9.55 us at an
// H100 SXM's 3.35 TB/s (24 bytes an element on the first step, which
// reads no t_prev). The arithmetic is five operations an element.
//
// The layout of the stream probe (csrc/stream_scale.cu), which ran at
// torch.mul's rate: 128-thread blocks, one 16-byte pack of each operand a
// thread (two doubles, four floats), neighbouring threads on neighbouring
// packs, and a grid that covers the vector once; the loop strides over
// the grid where the vector holds more packs than the grid has threads.
// The n mod (pack width) tail is done by the first threads of the grid,
// one element each. Where an operand is not 16-byte aligned (a view into
// a larger tensor) the same kernel runs one element a thread.
//
// The output may be t_prev itself (the filter writes t_{k+1} over
// t_{k-1}): each element of t_prev is read by the thread that writes it,
// before it writes it, so the two pointers carry no __restrict__.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = int64_t(1) << 30;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// W elements of T, loaded and stored as one access (16 bytes for a pack).
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

// PyTorch's sequence: c * t, y - (c t), (y - c t) * (1 / h), then for a
// later step 2 * q and 2 q - t_prev.
template <typename T, bool First>
__device__ __forceinline__ T update(T y, T t, T t_prev, T c, T inv_h) {
  const T q = mul(sub(y, mul(c, t)), inv_h);
  if (First) return q;
  return sub(mul(T(2), q), t_prev);
}

template <typename T, int W, bool First>
__global__ void __launch_bounds__(kThreads)
    cheb_step_kernel(const T* __restrict__ y, const T* __restrict__ t,
                     const T* t_prev, T* out, int64_t n, T c, T inv_h) {
  using P = Pack<T, W>;
  const int64_t packs = n / W;
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = first; i < packs; i += stride) {
    const P a = reinterpret_cast<const P*>(y)[i];
    const P b = reinterpret_cast<const P*>(t)[i];
    P p;
    if (!First) p = reinterpret_cast<const P*>(t_prev)[i];
    P r;
#pragma unroll
    for (int k = 0; k < W; ++k)
      r.v[k] = update<T, First>(a.v[k], b.v[k], First ? T(0) : p.v[k], c,
                                inv_h);
    reinterpret_cast<P*>(out)[i] = r;
  }
  const int64_t i = W * packs + first;  // the tail, fewer than W elements
  if (W > 1 && i < n)
    out[i] = update<T, First>(y[i], t[i], First ? T(0) : t_prev[i], c, inv_h);
}

template <typename T, int W>
void launch_width(const T* y, const T* t, const T* t_prev, T* out, int64_t n,
                  T c, T inv_h, cudaStream_t stream) {
  int64_t blocks = (n / W + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // n < W: the tail alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (t_prev == nullptr)
    cheb_step_kernel<T, W, true>
        <<<grid, kThreads, 0, stream>>>(y, t, t_prev, out, n, c, inv_h);
  else
    cheb_step_kernel<T, W, false>
        <<<grid, kThreads, 0, stream>>>(y, t, t_prev, out, n, c, inv_h);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch on ``device`` (made current for the launch, as the wrapper does
// not enter torch.cuda.device) and return cudaGetLastError().
template <typename T>
int launch(const T* y, const T* t, const T* t_prev, T* out, int64_t n, T c,
           T inv_h, int device, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kPack = 16 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16(y) && aligned16(t) && aligned16(out) &&
      (t_prev == nullptr || aligned16(t_prev)))
    launch_width<T, kPack>(y, t, t_prev, out, n, c, inv_h, s);
  else
    launch_width<T, 1>(y, t, t_prev, out, n, c, inv_h, s);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// y = A t, t and t_prev (NULL on the first step) and out, n elements each,
// contiguous; c and h as the filter has them, in double.
int spectra_cheb_step_f64(const double* y, const double* t,
                          const double* t_prev, double* out, int64_t n,
                          double c, double h, int device, void* stream) {
  return launch<double>(y, t, t_prev, out, n, c, 1.0 / h, device, stream);
}

int spectra_cheb_step_f32(const float* y, const float* t, const float* t_prev,
                          float* out, int64_t n, double c, double h,
                          int device, void* stream) {
  const float cf = static_cast<float>(c);
  const float inv_h = static_cast<float>(1.0 / h);
  return launch<float>(y, t, t_prev, out, n, cf, inv_h, device, stream);
}

}  // extern "C"
