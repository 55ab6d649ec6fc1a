// Native (C++) dense-CPU eigensolver driver: Krylov-Schur restarted
// Arnoldi with ARPACK convergence rules.
//
// The port's own copy of spectra_tpu/native/dense_eigs.cpp, unchanged
// apart from this header, so that the port builds it without the JAX
// package (spectra_tpu_torch/native/dense_eigs.py binds it; the
// routing is spectra_tpu_torch/solvers/_native_dense.py).
//
// Why this exists: the reference is a C++ header library whose
// benchmark bar is authentic Fortran ARPACK on small dense problems
// (reference: benchmark/main.cpp:109-125). Small dense problems are
// bound by the per-operation cost of a device driver's ncv-sized
// restart machinery; this driver runs the same restarted iteration
// fully natively (BLAS/LAPACK function pointers are handed over from
// scipy at load time: no link-time dependency), and is selected only
// for small dense f64 operators.
//
// Algorithm: Arnoldi factorization with full Gram-Schmidt + DGKS
// re-orthogonalization (reference: LinAlg/Arnoldi.h:257 skip rule is
// replaced by an always-on single-pass DGKS; same quality class), and
// Krylov-Schur restarts (Stewart 2001): ordered real Schur truncation
// to the wanted Ritz subspace, which is mathematically equivalent to
// the reference's exact-shift implicit QR restart
// (GenEigsBase.h:44-140). Convergence and nev-adjustment follow
// dsaup2.f 677-684 / dnaup2.f 660-674 exactly like the Python drivers
// (solvers/_herm_core.py).
//
// The symmetric case runs through the same code path (the Schur form
// of a symmetric Rayleigh quotient is diagonal, so the truncation is
// precisely the thick restart / TRLan of solvers/_herm_core.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

typedef void (*dgemv_t)(const char*, const int*, const int*, const double*,
                        const double*, const int*, const double*, const int*,
                        const double*, double*, const int*);
typedef void (*dgemm_t)(const char*, const char*, const int*, const int*,
                        const int*, const double*, const double*, const int*,
                        const double*, const int*, const double*, double*,
                        const int*);
typedef double (*ddot_t)(const int*, const double*, const int*, const double*,
                         const int*);
typedef double (*dnrm2_t)(const int*, const double*, const int*);
typedef void (*dgees_t)(const char*, const char*, void*, const int*, double*,
                        const int*, int*, double*, double*, double*,
                        const int*, double*, const int*, int*, int*);
typedef void (*dtrsen_t)(const char*, const char*, const int*, const int*,
                         double*, const int*, double*, const int*, double*,
                         double*, int*, double*, double*, double*, const int*,
                         int*, const int*, int*);
typedef void (*dsyev_t)(const char*, const char*, const int*, double*,
                        const int*, double*, double*, const int*, int*);
typedef void (*dtrevc_t)(const char*, const char*, const int*, const int*,
                         const double*, const int*, double*, const int*,
                         double*, const int*, const int*, int*, double*,
                         int*);

static dgemv_t p_dgemv;
static dgemm_t p_dgemm;
static ddot_t p_ddot;
static dnrm2_t p_dnrm2;
static dgees_t p_dgees;
static dtrsen_t p_dtrsen;
static dsyev_t p_dsyev;
static dtrevc_t p_dtrevc;

// fns: [dgemv, dgemm, ddot, dnrm2, dgees, dtrsen, dsyev, dtrevc]
void spectra_dense_eigs_init(void** fns) {
  p_dgemv = (dgemv_t)fns[0];
  p_dgemm = (dgemm_t)fns[1];
  p_ddot = (ddot_t)fns[2];
  p_dnrm2 = (dnrm2_t)fns[3];
  p_dgees = (dgees_t)fns[4];
  p_dtrsen = (dtrsen_t)fns[5];
  p_dsyev = (dsyev_t)fns[6];
  p_dtrevc = (dtrevc_t)fns[7];
}

}  // extern "C"

namespace {

constexpr double kEps = 2.220446049250313e-16;
const double kEps23 = std::pow(kEps, 2.0 / 3.0);
// 10x smallest normal (matches util/dtypes.near_zero, reference:
// HermEigsBase.h:181-184).
constexpr double kNear0 = 2.2250738585072014e-308 * 10.0;

// y = A x for a ROW-major n x n matrix: BLAS sees the transpose.
inline void matvec(const double* A, int n, const double* x, double* y) {
  const char t = 'T';
  const int one = 1;
  const double a = 1.0, b = 0.0;
  p_dgemv(&t, &n, &n, &a, A, &n, x, &one, &b, y, &one);
}

// h = V(:,0:k)^T w  (V column-major, n x ncv)
inline void proj(const double* V, int n, int k, const double* w, double* h) {
  const char t = 'T';
  const int one = 1;
  const double a = 1.0, b = 0.0;
  p_dgemv(&t, &n, &k, &a, V, &n, w, &one, &b, h, &one);
}

// f -= V(:,0:k) h
inline void desaxpy(const double* V, int n, int k, const double* h,
                    double* f) {
  const char t = 'N';
  const int one = 1;
  const double a = -1.0, b = 1.0;
  p_dgemv(&t, &n, &k, &a, V, &n, h, &one, &b, f, &one);
}

inline double nrm2(int n, const double* x) {
  const int one = 1;
  return p_dnrm2(&n, x, &one);
}

// Park-Miller-free deterministic fill for breakdown restarts (rare).
inline void pseudo_random(double* x, int n, uint64_t salt) {
  uint64_t s = 0x9e3779b97f4a7c15ULL ^ (salt * 0xbf58476d1ce4e5b9ULL);
  for (int i = 0; i < n; ++i) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    x[i] = (double)(s >> 11) / (double)(1ULL << 53) - 0.5;
  }
}

// Selection keys: smaller = more wanted (matches util/selection.py).
inline double sort_key(int rule, double re, double im) {
  const double mag = std::hypot(re, im);
  switch (rule) {
    case 0: return -mag;           // LargestMagn
    case 1: return -re;            // LargestReal
    case 2: return -std::abs(im);  // LargestImag
    case 3: return -re;            // LargestAlge (real spectra)
    case 4: return mag;            // SmallestMagn
    case 5: return re;             // SmallestReal
    case 6: return std::abs(im);   // SmallestImag
    case 7: return re;             // SmallestAlge
    default: return -mag;
  }
}

// Stable argsort of m eigenvalues by selection rule. BothEnds (8)
// interleaves Largest/Smallest (reference: SelectionRule.h:262-285).
void select_order(int rule, int m, const double* wr, const double* wi,
                  int* order) {
  std::vector<int> idx(m);
  for (int i = 0; i < m; ++i) idx[i] = i;
  if (rule == 8) {
    std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
      return sort_key(3, wr[a], wi[a]) < sort_key(3, wr[b], wi[b]);
    });
    for (int i = 0; i < m; ++i)
      order[i] = (i % 2 == 0) ? idx[i / 2] : idx[m - 1 - i / 2];
  } else {
    std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
      return sort_key(rule, wr[a], wi[a]) < sort_key(rule, wr[b], wi[b]);
    });
    for (int i = 0; i < m; ++i) order[i] = idx[i];
  }
}

struct Fac {
  int n, ncv;
  std::vector<double> V;  // n x ncv column-major
  std::vector<double> H;  // ncv x ncv column-major (Krylov-Schur form)
  std::vector<double> f;  // residual
  double beta = 0.0;
  int64_t nops = 0;

  Fac(int n_, int ncv_)
      : n(n_), ncv(ncv_), V(n_ * (size_t)ncv_, 0.0),
        H(ncv_ * (size_t)ncv_, 0.0), f(n_, 0.0) {}
};

// Extend the factorization from k to m columns. ``spike`` marks a
// fresh Krylov-Schur truncation: row k of H already carries the
// beta * b^T coupling and must not be overwritten by the plain
// subdiagonal write.
void arnoldi_extend(const double* A, Fac& fac, int k, int m, bool spike) {
  const int n = fac.n, ncv = fac.ncv;
  std::vector<double> w(n), h(ncv), c(ncv);
  for (int i = k; i < m; ++i) {
    if (fac.beta < kNear0) {
      // Breakdown: deterministic random vector orthogonalized against
      // the current basis (reference: Arnoldi.h:66-115 expand_basis).
      for (int attempt = 0; attempt < 5; ++attempt) {
        pseudo_random(fac.f.data(), n, (uint64_t)(i * 7 + attempt));
        for (int pass = 0; pass < 3; ++pass) {
          proj(fac.V.data(), n, i, fac.f.data(), c.data());
          desaxpy(fac.V.data(), n, i, c.data(), fac.f.data());
        }
        fac.beta = nrm2(n, fac.f.data());
        if (fac.beta > kNear0) break;
      }
      if (!spike || i != k) fac.H[(size_t)(i - 1) * ncv + i] = 0.0;
    } else if (!(spike && i == k)) {
      fac.H[(size_t)(i - 1) * ncv + i] = fac.beta;  // H[i, i-1]
    }
    double* vi = fac.V.data() + (size_t)i * n;
    const double inv = 1.0 / fac.beta;
    for (int j = 0; j < n; ++j) vi[j] = fac.f[j] * inv;

    matvec(A, n, vi, w.data());
    fac.nops += 1;

    proj(fac.V.data(), n, i + 1, w.data(), h.data());
    std::memcpy(fac.f.data(), w.data(), n * sizeof(double));
    desaxpy(fac.V.data(), n, i + 1, h.data(), fac.f.data());
    fac.beta = nrm2(n, fac.f.data());

    // DGKS corrections (<= 5, reference: Arnoldi.h:66-115 rules).
    for (int pass = 0; pass < 5; ++pass) {
      proj(fac.V.data(), n, i + 1, fac.f.data(), c.data());
      double oerr = 0.0;
      for (int j = 0; j <= i; ++j) oerr = std::max(oerr, std::abs(c[j]));
      if (oerr <= kEps * fac.beta) break;
      desaxpy(fac.V.data(), n, i + 1, c.data(), fac.f.data());
      for (int j = 0; j <= i; ++j) h[j] += c[j];
      fac.beta = nrm2(n, fac.f.data());
    }
    for (int j = 0; j <= i; ++j) fac.H[(size_t)i * ncv + j] = h[j];
  }
}

struct Ritz {
  std::vector<double> wr, wi;   // ncv eigenvalues (selection-sorted)
  std::vector<double> est;      // |last row of eigvec| (same order)
  std::vector<double> vecs;     // ncv x ncv real-packed (LAPACK pairs),
                                // column-permuted to selection order
  std::vector<int> order;       // permutation applied
  std::vector<char> is_pair_lo; // column is the first of a conj pair
  // Cached Schur form of H (gen path) so the Krylov-Schur truncation
  // reuses it instead of recomputing a second Schur decomposition.
  std::vector<double> T, Z;     // ncv x ncv, T-order
  std::vector<double> twr, twi; // T-order eigenvalues
};

// Eigen-decompose H (ncv x ncv) and sort by the selection.
//
// sym: one dsyev on the lower triangle (H in Krylov-Schur form is
// symmetric arrowhead + tridiagonal; the lower triangle carries the
// diag, the Lanczos subdiagonals and the truncation spike row). The
// orthogonal eigenvector matrix doubles as the Schur basis for the
// truncation, so the whole restart costs one symmetric eigensolve.
//
// gen: one dgees (H is the Rayleigh quotient, real Schur T = Z^T H Z)
// + dtrevc('B') for back-transformed eigenvectors; T and Z are cached
// for the truncation. Eigenvectors are re-normalized to unit 2-norm
// (pairs jointly) to match the convergence estimates of dgeev/ARPACK
// (dtrevc normalizes by largest |re|+|im| component instead).
int ritz_extract(const Fac& fac, int rule, bool sym, Ritz& rz) {
  const int m = fac.ncv;
  rz.wr.assign(m, 0.0);
  rz.wi.assign(m, 0.0);
  std::vector<double> wr(m), wi(m), vr((size_t)m * m);
  int info = 0, lwork = 8 * m + 16;
  std::vector<double> work(lwork);
  if (sym) {
    std::vector<double> Hc(fac.H);
    const char jz = 'V', lo = 'L';
    p_dsyev(&jz, &lo, &m, Hc.data(), &m, wr.data(), work.data(), &lwork,
            &info);
    if (info != 0) return info;
    std::fill(wi.begin(), wi.end(), 0.0);
    vr.swap(Hc);  // orthonormal eigenvectors, ascending-eigenvalue order
  } else {
    rz.T = fac.H;
    rz.Z.assign((size_t)m * m, 0.0);
    rz.twr.assign(m, 0.0);
    rz.twi.assign(m, 0.0);
    int sdim = 0;
    std::vector<int> bwork(m);
    const char jv = 'V', sn = 'N';
    p_dgees(&jv, &sn, nullptr, &m, rz.T.data(), &m, &sdim, rz.twr.data(),
            rz.twi.data(), rz.Z.data(), &m, work.data(), &lwork,
            bwork.data(), &info);
    if (info != 0) return info;
    wr = rz.twr;
    wi = rz.twi;
    // Back-transformed eigenvectors: VR starts as Z, dtrevc('B')
    // overwrites it with the (real-packed) eigenvectors of H.
    std::memcpy(vr.data(), rz.Z.data(), (size_t)m * m * sizeof(double));
    std::vector<double> work3((size_t)3 * m);
    std::vector<int> sel(m, 1);
    int mout = 0;
    const char side = 'R', how = 'B';
    p_dtrevc(&side, &how, sel.data(), &m, rz.T.data(), &m, nullptr, &m,
             vr.data(), &m, &m, &mout, work3.data(), &info);
    if (info != 0) return info;
    // Unit-2-norm normalization, conjugate pairs jointly.
    const int ione = 1;
    for (int j = 0; j < m; ++j) {
      if (wi[j] > 0.0) {
        const double nr = p_dnrm2(&m, &vr[(size_t)j * m], &ione);
        const double ni = p_dnrm2(&m, &vr[(size_t)(j + 1) * m], &ione);
        const double s = 1.0 / std::hypot(nr, ni);
        for (int t = 0; t < m; ++t) {
          vr[(size_t)j * m + t] *= s;
          vr[(size_t)(j + 1) * m + t] *= s;
        }
        ++j;  // pair handled
      } else if (wi[j] == 0.0) {
        const double s = 1.0 / p_dnrm2(&m, &vr[(size_t)j * m], &ione);
        for (int t = 0; t < m; ++t) vr[(size_t)j * m + t] *= s;
      }
    }
  }

  std::vector<int> order(m);
  select_order(rule, m, wr.data(), wi.data(), order.data());
  rz.order = order;
  rz.est.assign(m, 0.0);
  rz.vecs.assign((size_t)m * m, 0.0);
  rz.is_pair_lo.assign(m, 0);
  for (int p = 0; p < m; ++p) {
    const int j = order[p];
    rz.wr[p] = wr[j];
    rz.wi[p] = wi[j];
    double last;
    if (wi[j] > 0.0)
      last = std::hypot(vr[(size_t)j * m + m - 1], vr[(size_t)(j + 1) * m + m - 1]);
    else if (wi[j] < 0.0)
      last = std::hypot(vr[(size_t)(j - 1) * m + m - 1], vr[(size_t)j * m + m - 1]);
    else
      last = std::abs(vr[(size_t)j * m + m - 1]);
    rz.est[p] = last;
    // Real-packed eigenvector in ORIGINAL LAPACK column convention:
    // keep the (re, im) column pair contiguous for pair-leading cols.
    if (wi[j] > 0.0) {
      rz.is_pair_lo[p] = 1;
      std::memcpy(&rz.vecs[(size_t)p * m], &vr[(size_t)j * m],
                  m * sizeof(double));
    } else if (wi[j] < 0.0) {
      // imaginary part column of the pair led by j-1
      std::memcpy(&rz.vecs[(size_t)p * m], &vr[(size_t)j * m],
                  m * sizeof(double));
    } else {
      std::memcpy(&rz.vecs[(size_t)p * m], &vr[(size_t)j * m],
                  m * sizeof(double));
    }
  }
  return 0;
}

int count_converged(const Ritz& rz, double beta, double tol, int nev) {
  int nconv = 0;
  for (int i = 0; i < nev; ++i) {
    const double mag = std::hypot(rz.wr[i], rz.wi[i]);
    if (rz.est[i] * beta < tol * std::max(kEps23, mag)) ++nconv;
  }
  return nconv;
}

// dnaup2.f 660-674 / dsaup2.f 677-684 (see solvers/_gen_core.py).
int nev_adjusted(const Ritz& rz, int nconv, int nev, int ncv, bool sym) {
  int nev_new = nev;
  for (int i = nev; i < ncv; ++i)
    if (rz.est[i] * 1.0 < kNear0) ++nev_new;
  nev_new += std::min(nconv, (ncv - nev_new) / 2);
  if (nev_new == 1 && ncv >= 6)
    nev_new = ncv / 2;
  else if (nev_new == 1 && ncv > (sym ? 2 : 3))
    nev_new = 2;
  nev_new = std::min(nev_new, sym ? ncv - 1 : ncv - 2);
  if (!sym && nev_new < ncv) {
    // keep exact conjugate pairs together
    const int a = nev_new - 1, b = nev_new;
    if (rz.wi[a] != 0.0 && rz.wr[a] == rz.wr[b] && rz.wi[a] == -rz.wi[b])
      ++nev_new;
  }
  return nev_new;
}

// Krylov-Schur truncation: keep the k_new most wanted Ritz directions.
// Returns the actual kept count (pair-adjusted), or -1 on failure.
//
// sym: the Schur basis IS the (selection-permuted) eigenvector matrix
// from ritz_extract — truncation is a column selection + GEMM, no
// LAPACK call at all (this is exactly TRLan thick restart).
int ks_truncate_sym(Fac& fac, const Ritz& rz, int k) {
  const int m = fac.ncv, n = fac.n;
  std::vector<double> VZ((size_t)n * k);
  const char tn = 'N';
  const double one = 1.0, zero = 0.0;
  p_dgemm(&tn, &tn, &n, &k, &m, &one, fac.V.data(), &n, rz.vecs.data(), &m,
          &zero, VZ.data(), &n);
  std::memcpy(fac.V.data(), VZ.data(), (size_t)n * k * sizeof(double));
  std::fill(fac.V.begin() + (size_t)n * k, fac.V.end(), 0.0);
  std::fill(fac.H.begin(), fac.H.end(), 0.0);
  for (int p = 0; p < k; ++p) fac.H[(size_t)p * m + p] = rz.wr[p];
  if (k < m)
    for (int j = 0; j < k; ++j)
      fac.H[(size_t)j * m + k] =
          fac.beta * rz.vecs[(size_t)j * m + m - 1];
  return k;
}

// gen: reuse the cached real Schur form (T, Z) from ritz_extract and
// reorder the wanted block to the top with dtrsen.
int ks_truncate(Fac& fac, const Ritz& rz, int rule, int k_new) {
  const int m = fac.ncv, n = fac.n;
  std::vector<double> T(rz.T);
  std::vector<double> Z(rz.Z);
  const double* wr = rz.twr.data();
  const double* wi = rz.twi.data();
  int info = 0, lwork = 8 * m + 16;

  // Mark the k_new most wanted eigenvalues, whole 2x2 blocks at a time.
  std::vector<int> order(m);
  select_order(rule, m, wr, wi, order.data());
  std::vector<int> select(m, 0);
  int marked = 0;
  for (int p = 0; p < m && marked < k_new; ++p) {
    const int j = order[p];
    if (select[j]) continue;
    if (wi[j] != 0.0) {
      const int lead = (wi[j] > 0.0) ? j : j - 1;
      if (!select[lead]) {
        select[lead] = select[lead + 1] = 1;
        marked += 2;
      }
    } else {
      select[j] = 1;
      marked += 1;
    }
  }
  const int k = marked;  // pair-adjusted kept count

  int mout = 0, iwork_q = 1, liwork = 1;
  double s_cond = 0.0, sep = 0.0;
  lwork = std::max(1, m * m);  // >= n*(n+1)/2 needed for job='N'? use m*m
  std::vector<double> work2(lwork);
  std::vector<int> iwork(std::max(1, liwork));
  std::vector<double> wr2(rz.twr), wi2(rz.twi);  // dtrsen outputs
  const char jobn = 'N', compv = 'V';
  p_dtrsen(&jobn, &compv, select.data(), &m, T.data(), &m, Z.data(), &m,
           wr2.data(), wi2.data(), &mout, &s_cond, &sep, work2.data(),
           &lwork, iwork.data(), &iwork_q, &info);
  if (info != 0) return -1;

  // V(:, 0:k) <- V Z(:, 0:k)
  std::vector<double> VZ((size_t)n * k);
  const char tn = 'N';
  const double one = 1.0, zero = 0.0;
  p_dgemm(&tn, &tn, &n, &k, &m, &one, fac.V.data(), &n, Z.data(), &m, &zero,
          VZ.data(), &n);
  std::memcpy(fac.V.data(), VZ.data(), (size_t)n * k * sizeof(double));
  std::fill(fac.V.begin() + (size_t)n * k, fac.V.end(), 0.0);

  // H[0:k, 0:k] = T_k ; spike row k = beta * (last row of Z)_0:k.
  std::fill(fac.H.begin(), fac.H.end(), 0.0);
  for (int j = 0; j < k; ++j)
    for (int i = 0; i < k; ++i)
      fac.H[(size_t)j * m + i] = T[(size_t)j * m + i];
  if (k < m)
    for (int j = 0; j < k; ++j)
      fac.H[(size_t)j * m + k] = fac.beta * Z[(size_t)j * m + m - 1];
  return k;
}

}  // namespace

extern "C" {

// Restarted Krylov-Schur eigensolve of a dense row-major n x n matrix.
//
//   A            n*n row-major
//   v0           starting vector (forced into range(A) like the
//                reference init, Arnoldi.h:136-195)
//   rule         SortRule value (selection)
//   sym          1 if A is symmetric (enables dsaup2 nev rules)
//   evals_re/im  out, ncv entries (selection-sorted; first nev valid)
//   evecs        out, n x nev COMPLEX interleaved (re, im) col-major
//   ritz_est     out, nev residual estimates |est*beta|
//   out_stats    [nconv, niter, nops]
//
// Returns 0 on success, <0 on LAPACK failure.
int spectra_dense_eigs(const double* A, int n, int nev, int ncv, int rule,
                       int sym, double tol, int maxit, const double* v0,
                       double* evals_re, double* evals_im, double* evecs,
                       double* ritz_est, int64_t* out_stats) {
  if (!p_dgemv) return -100;
  Fac fac(n, ncv);

  // init (reference: HermEigsBase.h:309-342 + Arnoldi.h:136-195)
  std::vector<double> v(n), w(n);
  matvec(A, n, v0, v.data());
  fac.nops += 1;
  double vn = nrm2(n, v.data());
  if (vn < kNear0) {
    const double v0n = nrm2(n, v0);
    if (v0n < kNear0) return -2;
    for (int j = 0; j < n; ++j) v[j] = v0[j] / v0n;
  } else {
    for (int j = 0; j < n; ++j) v[j] /= vn;
  }
  matvec(A, n, v.data(), w.data());
  fac.nops += 1;
  const int ione = 1;
  const double h00 = p_ddot(&n, v.data(), &ione, w.data(), &ione);
  std::memcpy(fac.V.data(), v.data(), n * sizeof(double));
  fac.H[0] = h00;
  for (int j = 0; j < n; ++j) fac.f[j] = w[j] - h00 * v[j];
  double fmax = 0.0;
  for (int j = 0; j < n; ++j) fmax = std::max(fmax, std::abs(fac.f[j]));
  if (fmax < kEps * std::abs(h00)) {
    std::fill(fac.f.begin(), fac.f.end(), 0.0);
    fac.beta = 0.0;
  } else {
    fac.beta = nrm2(n, fac.f.data());
  }

  arnoldi_extend(A, fac, 1, ncv, false);

  Ritz rz;
  int niter = 1, nconv = 0;
  for (;;) {
    if (ritz_extract(fac, rule, sym != 0, rz) != 0) return -3;
    nconv = count_converged(rz, fac.beta, tol, nev);
    if (nconv >= nev || niter >= maxit) break;
    const int k_adj = nev_adjusted(rz, nconv, nev, ncv, sym != 0);
    const int k = sym ? ks_truncate_sym(fac, rz, k_adj)
                      : ks_truncate(fac, rz, rule, k_adj);
    if (k < 0) return -4;
    arnoldi_extend(A, fac, k, ncv, true);
    ++niter;
  }

  for (int i = 0; i < ncv; ++i) {
    evals_re[i] = rz.wr[i];
    evals_im[i] = rz.wi[i];
  }
  for (int i = 0; i < nev; ++i) ritz_est[i] = rz.est[i] * fac.beta;

  // Eigenvectors: X = V * S for the first nev selection-sorted Ritz
  // pairs, assembled column-by-column from the real-packed storage.
  const int m = fac.ncv;
  std::vector<double> xr(n), xi(n);
  for (int p = 0; p < nev; ++p) {
    const double* sr;
    const double* si;
    double si_sign = 1.0;
    if (rz.wi[p] == 0.0) {
      sr = &rz.vecs[(size_t)p * m];
      si = nullptr;
    } else {
      // LAPACK real-packed pairs live at ORIGINAL columns (j, j+1):
      // re in the lead, im in the trail. The selection permutation is
      // retained in rz.order, so the partner of sorted position p is
      // the sorted position holding original column j+1 (lead) or j-1
      // (trail) — exact by construction. (Matching by eigenvalue
      // equality instead can cross-match the re/im halves of two
      // DEGENERATE pairs with bit-identical (wr, wi) and emit a
      // non-eigenvector.)
      const int j = rz.order[p];
      const int j_partner = rz.is_pair_lo[p] ? j + 1 : j - 1;
      int q = -1;
      for (int t = 0; t < m; ++t)
        if (rz.order[t] == j_partner) {
          q = t;
          break;
        }
      if (q < 0) return -5;
      if (rz.is_pair_lo[p]) {
        sr = &rz.vecs[(size_t)p * m];
        si = &rz.vecs[(size_t)q * m];
      } else {
        sr = &rz.vecs[(size_t)q * m];
        si = &rz.vecs[(size_t)p * m];
      }
      si_sign = (rz.wi[p] > 0.0) ? 1.0 : -1.0;
    }
    const char tn = 'N';
    const double one_d = 1.0, zero_d = 0.0;
    p_dgemv(&tn, &n, &m, &one_d, fac.V.data(), &n, sr, &ione, &zero_d,
            xr.data(), &ione);
    if (si != nullptr)
      p_dgemv(&tn, &n, &m, &si_sign, fac.V.data(), &n, si, &ione, &zero_d,
              xi.data(), &ione);
    else
      std::fill(xi.begin(), xi.end(), 0.0);
    for (int j = 0; j < n; ++j) {
      evecs[(size_t)p * 2 * n + 2 * j] = xr[j];
      evecs[(size_t)p * 2 * n + 2 * j + 1] = xi[j];
    }
  }

  out_stats[0] = nconv;
  out_stats[1] = niter;
  out_stats[2] = fac.nops;
  return 0;
}

// Conformance probe: the dsaup2/dnaup2 nev-adjust rules on raw
// (wr, wi, est) vectors, so tests can assert this implementation, the
// compiled-herm and the compiled-gen Python twins agree on identical
// inputs (the rules are triplicated by design — each driver owns its
// restart loop; reference: HermEigsBase.h:178-202, GenEigsBase.h:245-277).
int spectra_nev_adjusted(const double* wr, const double* wi,
                         const double* est, int nconv, int nev, int ncv,
                         int sym) {
  Ritz rz;
  rz.wr.assign(wr, wr + ncv);
  rz.wi.assign(wi, wi + ncv);
  rz.est.assign(est, est + ncv);
  return nev_adjusted(rz, nconv, nev, ncv, sym != 0);
}

}  // extern "C"
