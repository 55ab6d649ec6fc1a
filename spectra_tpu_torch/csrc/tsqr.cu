// Tall-skinny Householder QR (TSQR) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this QR to XLA
// (spectra_tpu/linalg/orthogonalization.py::qr_orthogonalisation). It
// takes the place of cuSOLVER's geqr2/larft/orgqr behind
// torch.linalg.qr on the Jacobi-Davidson path, where each iteration
// orthonormalizes a new (n, c) correction block twice: the library
// reduces such a block one column at a time over all n rows, 11 ms for
// (10^6, 10) in f64 on an H100, about 0.4 % of its bound.
//
// It computes the reduced QR A = Q R of a row-major (n, c) block, c <=
// 32, n >= c, with R's diagonal made non-negative: where R_jj < 0 the
// sign of row j of R and of column j of Q flips; a zero R_jj counts as
// +1, as ops/tsqr.py::tsqr_plain does after torch.linalg.qr. Q is
// row-major and contiguous, what K1's block kernel takes.
//
// What bounds it: memory, in principle. The arithmetic is about 4 n c^2
// flops, a few microseconds at the f64 rate; the least traffic is one
// read of A and one write of Q, 160 MB for (10^6, 10) f64, 47.8 us at
// 3.35 TB/s.
//
// The passes. The rows are cut into panels of P = 32 * R * 4 rows (four
// warps, R rows a thread, in registers). The kernels are compiled for two
// buckets of C >= c columns: C = 10 (R = 3, P = 384), the width of the
// Davidson blocks, and C = 32 (R = 1, P = 128), which takes every other
// c. A level's matrix M (m, c) is factored panel by panel, each panel's
// R_p (c x c) stacked into the next level's matrix (ceil(m / P) * c
// rows), until one panel is left:
//
//   1. factor, one launch a level, bottom up: each CTA reads its panel
//      (A at level 0), runs c Householder reflections on it in
//      registers, and writes its R_p, its reflectors (the factored
//      panel: into Q at level 0, over M above it) and its c taus. The
//      top level is one CTA: its R_p is R, and the signs of R's diagonal
//      give D (R_jj < 0 flips row j of R and column j of Q);
//   2. form, one launch a level, top down: each CTA reads its reflectors,
//      forms its Q_p in place (LAPACK's dorg2r) and writes Q_p B_p over
//      them, B_p its c x c block of the level above's Q, or D at the top
//      (each CTA reads all its rows before it writes any).
//
// Bytes at level 0: A read, the reflectors written and read, Q written,
// 320 MB for (10^6, 10) f64 (95.5 us at 3.35 TB/s); the levels above hold
// ceil(n / P) * c rows, c / P of that. Recomputing the reflectors from A
// in pass 2 instead moves 240 MB but doubles that pass's chain of
// dependent steps: on an H100 it took 273-294 us against 223-235 us
// (PERF.md). Launches: two a level, eight for (10^6, 10) at P = 384,
// each set up while the one before it runs (programmatic dependent
// launch: a kernel waits for the one before it in its first
// instruction), which hides the gaps between them.
//
// What bounds it in fact: the chain of dependent steps inside a panel,
// and the instructions of its block sums. A column step is a block sum
// (shuffles, one barrier), a reciprocal square root and a reciprocal,
// then the update: about 1,000-1,300 cycles (clock64 on an H100, 10
// columns), whatever the panel's rows, and more rows a thread leave fewer
// CTAs on an SM. PERF.md has the times.
//
// Inside a panel. Thread (warp w, lane l) holds rows (w R + r) 32 + l,
// r < R, so the c pivot rows are slot 0 of warp 0. A factor step is one
// block sum: the squares of the sub-pivot column x and x^T a_k for the
// columns k to its right, with the pivot row passed through shared
// memory behind the same barrier (v^T a_k = a_jk + x^T a_k / (alpha -
// beta)). A block sum is a halving exchange of shuffles (every lane ends
// with the same bits, as a + b == b + a) and, across warps, one shared-
// memory exchange summed in warp order, so every thread holds bitwise
// the same tau and beta. A panel is copied into shared memory by
// cp.async (coalesced) and from there into registers; it leaves the same
// way.
//
// Why Householder and not a Gram-based QR (Cholesky-QR, Gram-Schmidt):
// Q's loss of orthogonality after Householder is of the order of the
// unit roundoff whatever the condition of A, while Cholesky-QR's grows
// with cond(A)^2 and Gram-Schmidt's with cond(A). The correction blocks
// of Davidson near convergence are nearly dependent; a Gram-based QR
// would give another, less orthogonal basis, not the same one faster.
//
// Numerics: the same reflectors as LAPACK's dlarfg/dlarf/dorg2r, summed
// in another order. The column norms are plain sums of squares (no
// rescaling as in dnrm2), so entries beyond about 1e+-150 in f64 or
// 1e+-18 in f32 overflow or underflow; a sub-pivot column whose squares
// all underflow is taken as zero (tau = 0). NaN and inf propagate into
// Q. Dot products and updates are explicit fma; the rest of the library
// is built with -fmad=false, which leaves these alone.

#include <cuda_runtime.h>

#include <cstdint>

namespace spectra_tsqr {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // a CTA's warps
constexpr int kMaxLevels = 48;

// The rows a thread holds for the bucket of C columns (three were the
// fastest of 2-6 for C = 10 on an H100, PERF.md) and a panel's rows.
template <int C>
struct Bucket {
  static_assert(C == 10 || C == 32, "the buckets are C = 10 and C = 32");
  static constexpr int R = C == 10 ? 3 : 1;
  static constexpr int P = 32 * R * kWarps;
};

// The power of two >= N (and >= 2): the width of a block sum.
template <int N>
struct Pow2 {
  static constexpr int value = N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32;
};

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared scratch: the staged panel, two buffers each for the block sums
// and for the pivot row (consecutive steps alternate, so one barrier a
// step suffices) and the c x c block B.
template <typename T>
struct Scratch {
  T* stage;
  T* red;
  T* prow;
  T* b;
  int flip;
};

template <typename T>
__device__ __forceinline__ Scratch<T> scratch(int panel_rows, int c) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* base = reinterpret_cast<T*>(smem_bytes);
  T* red = base + panel_rows * c;
  return Scratch<T>{base, red, red + 2 * kWarps * 32, red + 2 * kWarps * 32 + 64, 0};
}

constexpr size_t smem_values(int panel_rows, int c, int C) {
  return size_t(panel_rows) * c + 2 * kWarps * 32 + 64 + size_t(C) * C;
}

// Every panel fits the 48 KB a kernel may take without opting in.
static_assert(smem_values(Bucket<10>::P, 10, 10) * sizeof(double) <= 48 * 1024, "C = 10");
static_assert(smem_values(Bucket<32>::P, 32, 32) * sizeof(double) <= 48 * 1024, "C = 32");

// One halving exchange of block_sum, then the next: the lanes whose bit
// O is set keep values [Half, 2 Half), the others [0, Half), each adding
// its partner's. Recursion, so that every index is a constant (a loop
// over Half left v in local memory).
template <int Half, int O, typename T, int K>
__device__ __forceinline__ void halve(T (&v)[K], int lane) {
  if constexpr (Half >= 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < Half; ++i) {
      const T send = upper ? v[i] : v[i + Half];
      const T keep = upper ? v[i + Half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve<Half / 2, O / 2>(v, lane);
  }
}

// v[i], i < K (a power of two, 2 <= K <= 32), summed over every row of
// the CTA; every thread gets the same bits. In a warp, log2(K) halving
// exchanges (lanes whose bit o is set keep the upper half of the values
// still held and pass the lower half across, K - 1 shuffles in all) and
// then the xor levels left leave lanes i * 32 / K holding the warp's sum
// of value i; K shuffles from them hand every sum to every lane: 2K + 5 -
// log2(K) shuffles, where a butterfly on each value takes 5K. With
// several warps the holders first add the warps' sums in warp order
// through shared memory, behind one barrier.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], Scratch<T>& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  halve<K / 2, 16>(v, lane);
  T x = v[0];
#pragma unroll
  for (int o = 16 / K; o >= 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  constexpr int kSpan = 32 / K;  // lanes holding each sum
  if constexpr (kWarps > 1) {
    T* red = s.red + s.flip * (kWarps * 32);
    s.flip ^= 1;
    const int idx = lane / kSpan;
    if (lane % kSpan == 0) red[warp * K + idx] = x;
    __syncthreads();
    x = red[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += red[w * K + idx];
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = __shfl_sync(kFull, x, i * kSpan);
}

__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }

__device__ __forceinline__ int panel_row(int r, int R) {
  return ((threadIdx.x >> 5) * R + r) * 32 + (threadIdx.x & 31);
}

// Rows [row0, row0 + rows) of M (m, c) into the registers, zero beyond
// row `rows` and column c.
template <typename T, int C, int R>
__device__ __forceinline__ void load_panel(T (&a)[R][C], const T* M, int64_t row0, int rows,
                                           int c, Scratch<T>& s) {
  const T* src = M + row0 * c;
  const int count = rows * c;
  for (int e = threadIdx.x; e < count; e += blockDim.x) copy_async(s.stage + e, src + e);
  wait_async();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = panel_row(r, R);
#pragma unroll
    for (int k = 0; k < C; ++k) a[r][k] = (p < rows && k < c) ? s.stage[p * c + k] : T(0);
  }
  __syncthreads();
}

template <typename T, int C, int R>
__device__ __forceinline__ void store_panel(const T (&a)[R][C], T* M, int64_t row0, int rows,
                                            int c, Scratch<T>& s) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = panel_row(r, R);
    if (p < rows) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (k < c) s.stage[p * c + k] = a[r][k];
      }
    }
  }
  __syncthreads();
  T* dst = M + row0 * c;
  const int count = rows * c;
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = s.stage[e];
}

// Column steps are unrolled at compile time (template recursion over the
// column), so every register index is a constant and a step runs over
// exactly the columns right of it: no selects or branches on a column
// index. Only `c < C` is known at run time: the steps from c on return
// at once, and the zero columns from c to C ride along as zeros. Slot 0
// of warp 0 holds rows 0-31, so only there can a row be at or above a
// pivot (p0 == J is warp 0's lane J).

// Householder QR of the panel in place (LAPACK's dgeqr2 with dlarfg),
// steps J .. c-1: R on and above the diagonal, the reflectors' tails
// below it. Lane j of every warp keeps tau_j in `tau` and R_jj in `beta`.
// A step is one block sum: the squares of the sub-pivot column x and
// x^T a_k for the columns k right of it. The pivot row goes to every
// thread through shared memory behind the same barrier, and v^T a_k =
// a_Jk + x^T a_k / (alpha - beta) with v = [1; x / (alpha - beta)].
template <int J, typename T, int C, int R>
__device__ __forceinline__ void factor(T (&a)[R][C], int c, T& tau, T& beta, Scratch<T>& s) {
  if constexpr (J < C) {
    if (J >= c) return;
    constexpr int N = C - 1 - J;
    constexpr int K = Pow2<N + 1>::value;
    const int lane = threadIdx.x & 31;
    const int p0 = panel_row(0, R);
    T* prow = s.prow + (J & 1) * 32;
    if (p0 == J) {
#pragma unroll
      for (int k = J; k < C; ++k) prow[k] = a[0][k];
    }
    __syncwarp();
    T sums[K];
#pragma unroll
    for (int i = 0; i < K; ++i) sums[i] = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T x = r > 0 || p0 > J ? a[r][J] : T(0);
      sums[0] = fma(x, x, sums[0]);
#pragma unroll
      for (int i = 0; i < N; ++i) sums[1 + i] = fma(x, a[r][J + 1 + i], sums[1 + i]);
    }
    block_sum(sums, s);
    const T alpha = prow[J];
    T t = T(0), scale = T(0), b = alpha;
    if (sums[0] != T(0)) {  // NaN goes this way too, and propagates
      // beta = -sign(alpha) sqrt(sigma), tau = (beta - alpha) / beta =
      // 1 + |alpha| / sqrt(sigma) in [1, 2], 1 / (alpha - beta) =
      // sign(alpha) / (sqrt(sigma) tau): one reciprocal square root and
      // one reciprocal, not a square root and two divisions, on the
      // step's chain.
      const T sigma = fma(alpha, alpha, sums[0]);
      const T rs = rsqrt(sigma);
      b = -copysign(sigma * rs, alpha);
      t = fma(fabs(alpha), rs, T(1));
      scale = copysign(rs * reciprocal(t), alpha);
    }
    tau = lane == J ? t : tau;
    beta = lane == J ? b : beta;
#pragma unroll
    for (int i = 0; i < N; ++i) sums[1 + i] = -t * fma(scale, sums[1 + i], prow[J + 1 + i]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool below = r > 0 || p0 > J;
      const T v = below ? a[r][J] * scale : (p0 == J ? T(1) : T(0));
      a[r][J] = below ? v : a[r][J];
#pragma unroll
      for (int i = 0; i < N; ++i) a[r][J + 1 + i] = fma(v, sums[1 + i], a[r][J + 1 + i]);
    }
    a[0][J] = p0 == J ? b : a[0][J];
    factor<J + 1>(a, c, tau, beta, s);
  }
}

// H_I = I - t v v^T applied to the columns I+1 .. C-1, v = column I's
// reflector: 1 at the pivot row I, the stored tail below it, 0 above.
template <int I, typename T, int C, int R>
__device__ __forceinline__ void reflect(T (&a)[R][C], T t, Scratch<T>& s) {
  constexpr int N = C - 1 - I;
  if constexpr (N > 0) {
    constexpr int K = Pow2<N>::value;
    const int p0 = panel_row(0, R);
    T v[R];
    T w[K];
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = r > 0 || p0 > I ? a[r][I] : (p0 == I ? T(1) : T(0));
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = fma(v[r], a[r][I + 1 + i], w[i]);
    }
    block_sum(w, s);
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = -t * w[i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[r][I + 1 + i] = fma(v[r], w[i], a[r][I + 1 + i]);
    }
  }
}

// Q_p of the factored panel in place (LAPACK's dorg2r), columns I down
// to 0: each reflector applied to the columns right of it, then its own
// column becomes e_I - tau_I v_I. Lane i holds tau_i.
template <int I, typename T, int C, int R>
__device__ __forceinline__ void form_q(T (&a)[R][C], int c, T tau, Scratch<T>& s) {
  if constexpr (I >= 0) {
    if (I < c) {
      const T t = __shfl_sync(kFull, tau, I);
      reflect<I>(a, t, s);
      const int p0 = panel_row(0, R);
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r][I] = r > 0 || p0 > I ? -t * a[r][I] : (p0 == I ? T(1) - t : T(0));
    }
    form_q<I - 1>(a, c, tau, s);
  }
}

// Pass 1 at one level: panel p of M (m, c) factored; its reflectors
// (the factored panel) to V, where V may be M, its taus to taus[p c ..],
// its R_p to rows [p c, p c + c) of Rs. At the top level (one panel, D
// not null) Rs is R: the signs of R_p's diagonal give D (a zero counts
// as +1), written as a c x c diagonal matrix for pass 2, and Rs gets D
// R_p.
template <typename T, int C, int R>
__global__ void __launch_bounds__(kWarps * 32)
    tsqr_factor_kernel(const T* M, int64_t m, int c, T* Rs, T* V, T* taus, T* D) {
  // Launched while the kernel before it finishes (run's launch): wait for
  // it before touching anything, then let the next kernel be launched.
  asm volatile("griddepcontrol.wait;\ngriddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int P = 32 * R * kWarps;
  Scratch<T> s = scratch<T>(P, c);
  const int64_t row0 = int64_t(blockIdx.x) * P;
  const int rows = int(m - row0 < P ? m - row0 : P);
  T a[R][C];
  load_panel(a, M, row0, rows, c, s);
  T tau = T(0), beta = T(0);
  factor<0>(a, c, tau, beta, s);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32 && lane < c) {  // row `lane` of R_p, tau_lane
    const T d = D != nullptr && beta < T(0) ? T(-1) : T(1);
    T* out = Rs + (int64_t(blockIdx.x) * c + lane) * c;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k < c) out[k] = k >= lane ? d * a[0][k] : T(0);
    }
    taus[int64_t(blockIdx.x) * c + lane] = tau;
    if (D != nullptr) {
      for (int k = 0; k < c; ++k) D[lane * c + k] = k == lane ? d : T(0);
    }
  }
  store_panel(a, V, row0, rows, c, s);
}

// Pass 2 at one level, in place: panel p's reflectors in V become Q_p
// B_p, B_p the rows [p c, p c + c) of the level above's Q (Bs), or D at
// the top level (the product with a diagonal of signs is exact). Every
// thread has its rows in registers, past a barrier, before any is written.
template <typename T, int C, int R>
__global__ void __launch_bounds__(kWarps * 32)
    tsqr_form_kernel(T* V, int64_t m, int c, const T* taus, const T* Bs) {
  // Launched while the kernel before it finishes (run's launch): wait for
  // it before touching anything, then let the next kernel be launched.
  asm volatile("griddepcontrol.wait;\ngriddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int P = 32 * R * kWarps;
  Scratch<T> s = scratch<T>(P, c);
  const int64_t row0 = int64_t(blockIdx.x) * P;
  const int rows = int(m - row0 < P ? m - row0 : P);
  const int lane = threadIdx.x & 31;
  const T tau = lane < c ? taus[int64_t(blockIdx.x) * c + lane] : T(0);
  const T* b = Bs + int64_t(blockIdx.x) * c * c;
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, k = e % C;
    s.b[e] = i < c && k < c ? b[i * c + k] : T(0);
  }
  T a[R][C];
  load_panel(a, V, row0, rows, c, s);  // its barriers cover s.b too
  form_q<C - 1>(a, c, tau, s);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // B is read again for each slot (the empty asm is a compiler memory
    // barrier): held in registers across the slots, its C^2 values took
    // the kernel to 254 registers and spills.
    asm volatile("" ::: "memory");
    const T* bv = s.b;
    T y[C];
#pragma unroll
    for (int k = 0; k < C; ++k) y[k] = T(0);
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int k = 0; k < C; ++k) y[k] = fma(a[r][i], bv[i * C + k], y[k]);
    }
#pragma unroll
    for (int k = 0; k < C; ++k) a[r][k] = y[k];
  }
  store_panel(a, V, row0, rows, c, s);
}

// The tree of an (n, c) block in panels of P rows: level l's matrix has
// m[l] rows (m[0] = n), each level the stacked R_p of the one below,
// until one panel is left (level top). The workspace holds the matrices
// of levels 1 .. top one after another, then the taus of every level
// (c a panel: the rows of the level above, c at the top), then D (c x c).
// Level 0's reflectors, and then Q, are written into Q, each upper
// level's over its matrix.
struct Tree {
  int top;
  int64_t m[kMaxLevels];
  int64_t level[kMaxLevels];  // offset of level l's matrix, l >= 1
  int64_t taus[kMaxLevels];   // offset of level l's taus
  int64_t d;                  // offset of D
  int64_t len;                // values in all
};

// False where the block is not one that panels of P rows take.
inline bool grow(Tree& t, int64_t n, int c, int64_t P) {
  if (c < 1 || c > 32 || n < c || 2 * int64_t(c) > P) return false;
  t.m[0] = n;
  t.top = 0;
  int64_t used = 0;
  while ((t.m[t.top] + P - 1) / P > 1) {
    if (t.top + 1 >= kMaxLevels) return false;
    t.m[t.top + 1] = (t.m[t.top] + P - 1) / P * c;
    t.level[t.top + 1] = used;
    used += t.m[t.top + 1] * c;
    ++t.top;
  }
  for (int l = 0; l <= t.top; ++l) {
    t.taus[l] = used;
    used += l < t.top ? t.m[l + 1] : c;
  }
  t.d = used;
  t.len = used + int64_t(c) * c;
  return true;
}

inline int64_t panel_rows(int c) { return c <= 10 ? Bucket<10>::P : Bucket<32>::P; }

// The whole QR on `stream`, `work` holding Tree::len values.
template <typename T, int C>
int run(const T* A, T* Q, T* Rout, T* work, int64_t n, int c, cudaStream_t stream) {
  constexpr int R = Bucket<C>::R;
  constexpr int64_t P = Bucket<C>::P;
  // An error an earlier runtime call of this thread left behind is not
  // this QR's: clear it, so that the check after the launches reports
  // theirs alone.
  (void)cudaGetLastError();
  Tree t;
  if (c > C || !grow(t, n, c, P)) return int(cudaErrorInvalidValue);
  const int L = t.top;
  auto held = [&](int l) { return l == 0 ? Q : work + t.level[l]; };  // V, then Q, of level l
  // Programmatic dependent launch: each kernel is set up while the one
  // before it runs and waits for it in its first instruction, which
  // hides the launch gaps of the chain.
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem_values(int(P), c, C) * sizeof(T);
  cfg.stream = stream;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  T* D = work + t.d;
  cudaError_t e = cudaSuccess;
  for (int l = 0; l <= L && e == cudaSuccess; ++l) {
    cfg.gridDim = dim3(unsigned((t.m[l] + P - 1) / P));
    e = cudaLaunchKernelEx(&cfg, tsqr_factor_kernel<T, C, R>, l == 0 ? A : held(l), t.m[l], c,
                           l < L ? held(l + 1) : Rout, held(l), work + t.taus[l],
                           l < L ? nullptr : D);
  }
  for (int l = L; l >= 0 && e == cudaSuccess; --l) {
    cfg.gridDim = dim3(unsigned((t.m[l] + P - 1) / P));
    e = cudaLaunchKernelEx(&cfg, tsqr_form_kernel<T, C, R>, held(l), t.m[l], c,
                           static_cast<const T*>(work + t.taus[l]),
                           static_cast<const T*>(l < L ? held(l + 1) : D));
  }
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int dispatch(const T* A, T* Q, T* Rout, T* work, int64_t n, int c, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (c <= 10) return run<T, 10>(A, Q, Rout, work, n, c, s);
  return run<T, 32>(A, Q, Rout, work, n, c, s);
}

}  // namespace spectra_tsqr

extern "C" {

// The values of workspace an (n, c) block needs, or -1 if the kernel
// does not take it (c outside 1 .. 32, or n < c).
int64_t spectra_tsqr_workspace(int64_t n, int c) {
  spectra_tsqr::Tree t;
  return spectra_tsqr::grow(t, n, c, spectra_tsqr::panel_rows(c)) ? t.len : -1;
}

// A (n, c) row-major in; Q (n, c) row-major and R (c, c) out; work of
// spectra_tsqr_workspace(n, c) values.
int spectra_tsqr_f64(const double* A, double* Q, double* R, double* work, int64_t n, int c,
                     void* stream) {
  return spectra_tsqr::dispatch<double>(A, Q, R, work, n, c, stream);
}

int spectra_tsqr_f32(const float* A, float* Q, float* R, float* work, int64_t n, int c,
                     void* stream) {
  return spectra_tsqr::dispatch<float>(A, Q, R, work, n, c, stream);
}

}  // extern "C"
