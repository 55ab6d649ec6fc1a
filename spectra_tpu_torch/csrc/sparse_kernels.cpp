// Native host sparse toolkit of spectra_tpu_torch: COO->CSR assembly
// with duplicate summing, CSR->ELL and CSR->DIA conversion, the diagonal
// census, a row-partition halo census, a Matrix Market reader, a
// direct-to-DIA 2-D Laplacian generator, and a threaded Gustavson CSR
// product and CSR matvec (the multigrid hierarchy build's Galerkin
// products and power iteration).
//
// This is host code, not a kernel: the port's own copy of the JAX
// package's spectra_tpu/native/sparse_kernels.cpp, with the same
// arithmetic in the same order, so its results are bitwise the JAX
// package's on the same host. Each row of a product or a matvec is
// summed by one thread in a fixed order, so the thread count does not
// change a result.
//
// A plain C ABI consumed with ctypes; caller-allocated buffers, int64
// and double (int32 column indices for the CSR products). Built by g++
// on first use (spectra_tpu_torch/ops/_build.py, HOST_FLAGS).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// COO -> CSR with duplicate summing. Returns the deduplicated nnz.
// indptr: (n_rows + 1), indices/data out buffers sized >= nnz.
// ---------------------------------------------------------------------------
int64_t spectra_coo_to_csr(int64_t n_rows, int64_t nnz,
                           const int64_t* rows, const int64_t* cols,
                           const double* vals, int64_t* indptr,
                           int64_t* indices, double* data) {
  // Counting pass.
  std::vector<int64_t> count(n_rows + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) count[rows[k] + 1]++;
  for (int64_t i = 0; i < n_rows; ++i) count[i + 1] += count[i];

  // Scatter into row-grouped order.
  std::vector<int64_t> tmp_col(nnz);
  std::vector<double> tmp_val(nnz);
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t p = cursor[rows[k]]++;
    tmp_col[p] = cols[k];
    tmp_val[p] = vals[k];
  }

  // Sort within each row and sum duplicates.
  int64_t out = 0;
  indptr[0] = 0;
  std::vector<int64_t> order;
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t lo = count[i], hi = count[i + 1];
    int64_t len = hi - lo;
    order.resize(len);
    std::iota(order.begin(), order.end(), int64_t{0});
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return tmp_col[lo + a] < tmp_col[lo + b];
    });
    int64_t prev_col = -1;
    for (int64_t j = 0; j < len; ++j) {
      int64_t c = tmp_col[lo + order[j]];
      double v = tmp_val[lo + order[j]];
      if (c == prev_col) {
        data[out - 1] += v;
      } else {
        indices[out] = c;
        data[out] = v;
        ++out;
        prev_col = c;
      }
    }
    indptr[i + 1] = out;
  }
  return out;
}

// ---------------------------------------------------------------------------
// CSR -> padded ELL. Returns the row width L (max nnz/row, >= 1).
// Call once with cols_out == nullptr to query L, then with buffers
// of shape (n_rows, L).
// ---------------------------------------------------------------------------
int64_t spectra_csr_to_ell(int64_t n_rows, const int64_t* indptr,
                           const int64_t* indices, const double* data,
                           int64_t pad_width, int32_t* cols_out,
                           double* vals_out) {
  int64_t L = 1;
  for (int64_t i = 0; i < n_rows; ++i)
    L = std::max(L, indptr[i + 1] - indptr[i]);
  L = std::max(L, pad_width);
  if (cols_out == nullptr) return L;

  std::memset(cols_out, 0, sizeof(int32_t) * n_rows * L);
  std::memset(vals_out, 0, sizeof(double) * n_rows * L);
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t w = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p, ++w) {
      cols_out[i * L + w] = static_cast<int32_t>(indices[p]);
      vals_out[i * L + w] = data[p];
    }
  }
  return L;
}

// ---------------------------------------------------------------------------
// CSR diagonal census: writes the distinct offsets (ascending) into
// offsets_out (sized >= n_rows + n_cols - 1 worst case) and returns
// their count.
// ---------------------------------------------------------------------------
int64_t spectra_csr_diagonals(int64_t n_rows, const int64_t* indptr,
                              const int64_t* indices, int64_t n_cols,
                              int64_t* offsets_out) {
  std::vector<uint8_t> seen(n_rows + n_cols - 1, 0);
  for (int64_t i = 0; i < n_rows; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      seen[indices[p] - i + n_rows - 1] = 1;
  int64_t cnt = 0;
  for (int64_t d = 0; d < static_cast<int64_t>(seen.size()); ++d)
    if (seen[d]) offsets_out[cnt++] = d - (n_rows - 1);
  return cnt;
}

// ---------------------------------------------------------------------------
// CSR -> row-aligned DIA: data_out shape (n_diags, n_rows) with
// data_out[k, i] = A[i, i + offsets[k]].
// ---------------------------------------------------------------------------
void spectra_csr_to_dia(int64_t n_rows, const int64_t* indptr,
                        const int64_t* indices, const double* data,
                        int64_t n_diags, const int64_t* offsets,
                        double* data_out) {
  std::memset(data_out, 0, sizeof(double) * n_diags * n_rows);
  // offset -> slot lookup (offsets ascending).
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t off = indices[p] - i;
      const int64_t* it = std::lower_bound(offsets, offsets + n_diags, off);
      if (it != offsets + n_diags && *it == off) {
        data_out[(it - offsets) * n_rows + i] += data[p];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Row-partition halo census for an n_parts row partition (equal
// blocks): for partition p, counts how many distinct remote x-entries
// its rows reference. halo_counts sized n_parts. Returns total halo.
// This is the communication-volume planner for multi-host meshes.
// ---------------------------------------------------------------------------
int64_t spectra_rowpart_halo(int64_t n_rows, const int64_t* indptr,
                             const int64_t* indices, int64_t n_parts,
                             int64_t* halo_counts) {
  int64_t rows_per = (n_rows + n_parts - 1) / n_parts;
  int64_t total = 0;
  std::vector<uint8_t> mark(n_rows);
  for (int64_t p = 0; p < n_parts; ++p) {
    int64_t lo = p * rows_per;
    int64_t hi = std::min(n_rows, lo + rows_per);
    std::fill(mark.begin(), mark.end(), 0);
    int64_t cnt = 0;
    for (int64_t i = lo; i < hi; ++i) {
      for (int64_t q = indptr[i]; q < indptr[i + 1]; ++q) {
        int64_t c = indices[q];
        if ((c < lo || c >= hi) && !mark[c]) {
          mark[c] = 1;
          ++cnt;
        }
      }
    }
    halo_counts[p] = cnt;
    total += cnt;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Matrix Market reader (coordinate, real/integer/pattern,
// general/symmetric). Two-phase: first call with rows == nullptr
// returns the expanded nnz (after symmetric mirroring) and writes
// shape into shape_out[0..1]; second call fills rows/cols/vals.
// Returns -1 on parse error, -2 on unsupported format.
// ---------------------------------------------------------------------------
int64_t spectra_read_matrix_market(const char* path, int64_t* shape_out,
                                   int64_t* rows, int64_t* cols,
                                   double* vals) {
  std::FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) {
    std::fclose(f);
    return -1;
  }
  bool symmetric = std::strstr(line, "symmetric") != nullptr;
  bool skew = std::strstr(line, "skew-symmetric") != nullptr;
  bool pattern = std::strstr(line, "pattern") != nullptr;
  if (std::strstr(line, "%%MatrixMarket") == nullptr ||
      std::strstr(line, "coordinate") == nullptr ||
      std::strstr(line, "complex") != nullptr) {
    std::fclose(f);
    return -2;
  }
  // Skip comments.
  long pos = std::ftell(f);
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] != '%') break;
    pos = std::ftell(f);
  }
  std::fseek(f, pos, SEEK_SET);
  int64_t m, n, nnz;
  if (std::fscanf(f, "%ld %ld %ld", &m, &n, &nnz) != 3) {
    std::fclose(f);
    return -1;
  }
  shape_out[0] = m;
  shape_out[1] = n;

  int64_t out = 0;
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t i, j;
    double v = 1.0;
    int got = pattern ? std::fscanf(f, "%ld %ld", &i, &j)
                      : std::fscanf(f, "%ld %ld %lf", &i, &j, &v);
    if (got < (pattern ? 2 : 3)) {
      std::fclose(f);
      return -1;
    }
    --i;
    --j;
    if (rows) {
      rows[out] = i;
      cols[out] = j;
      vals[out] = v;
    }
    ++out;
    if ((symmetric || skew) && i != j) {
      if (rows) {
        rows[out] = j;
        cols[out] = i;
        vals[out] = skew ? -v : v;
      }
      ++out;
    }
  }
  std::fclose(f);
  return out;
}

// ---------------------------------------------------------------------------
// 2D grid Laplacian generator (5-point stencil) straight into
// row-aligned DIA arrays: data shape (5, g*g), offsets {-g,-1,0,1,g}.
// The benchmark-family matrix without any scipy round-trip.
// ---------------------------------------------------------------------------
void spectra_laplacian2d_dia(int64_t g, double* data, int64_t* offsets) {
  int64_t n = g * g;
  offsets[0] = -g;
  offsets[1] = -1;
  offsets[2] = 0;
  offsets[3] = 1;
  offsets[4] = g;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = i / g, c = i % g;
    data[0 * n + i] = (r > 0) ? -1.0 : 0.0;
    data[1 * n + i] = (c > 0) ? -1.0 : 0.0;
    data[2 * n + i] = 4.0;
    data[3 * n + i] = (c < g - 1) ? -1.0 : 0.0;
    data[4 * n + i] = (r < g - 1) ? -1.0 : 0.0;
  }
}

// ---------------------------------------------------------------------------
// Threaded CSR x CSR product (Gustavson with per-thread last-seen
// masks) — the host-side engine behind the Galerkin triple products
// P^T A P of the multigrid hierarchy build (linalg/multigrid.py),
// row-parallel over the host's cores where scipy's product is serial.
//
// Two passes, both row-parallel over [0, n_rows):
//   spectra_spgemm_nnz  fills Cp[i+1] with nnz(row i) (caller cumsums)
//   spectra_spgemm_fill writes Cj/Cx given the final Cp (rows sorted)
// ---------------------------------------------------------------------------

static void spgemm_nnz_range(int64_t r0, int64_t r1, int64_t n_cols,
                             const int64_t* Ap, const int32_t* Aj,
                             const int64_t* Bp, const int32_t* Bj,
                             int64_t* row_nnz) {
  std::vector<int64_t> mask(static_cast<size_t>(n_cols), -1);
  for (int64_t i = r0; i < r1; ++i) {
    int64_t cnt = 0;
    for (int64_t ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
      int32_t j = Aj[ka];
      for (int64_t kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
        int32_t c = Bj[kb];
        if (mask[c] != i) {
          mask[c] = i;
          ++cnt;
        }
      }
    }
    row_nnz[i] = cnt;
  }
}

static void spgemm_fill_range(int64_t r0, int64_t r1, int64_t n_cols,
                              const int64_t* Ap, const int32_t* Aj,
                              const double* Ax, const int64_t* Bp,
                              const int32_t* Bj, const double* Bx,
                              const int64_t* Cp, int32_t* Cj, double* Cx) {
  std::vector<int64_t> mask(static_cast<size_t>(n_cols), -1);
  std::vector<double> acc(static_cast<size_t>(n_cols), 0.0);
  std::vector<int32_t> cols;
  for (int64_t i = r0; i < r1; ++i) {
    cols.clear();
    for (int64_t ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
      int32_t j = Aj[ka];
      double va = Ax[ka];
      for (int64_t kb = Bp[j]; kb < Bp[j + 1]; ++kb) {
        int32_t c = Bj[kb];
        if (mask[c] != i) {
          mask[c] = i;
          acc[c] = va * Bx[kb];
          cols.push_back(c);
        } else {
          acc[c] += va * Bx[kb];
        }
      }
    }
    std::sort(cols.begin(), cols.end());
    int64_t out = Cp[i];
    for (int32_t c : cols) {
      Cj[out] = c;
      Cx[out] = acc[c];
      ++out;
    }
  }
}

static int64_t spgemm_nthreads(int64_t n_rows) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  int64_t t = n_rows / 65536;  // at least ~64k rows per thread
  if (t < 1) t = 1;
  return std::min(hw, t);
}

// Pass 1: row_nnz[i] = nnz of C row i (caller builds Cp by cumsum).
void spectra_spgemm_nnz(int64_t n_rows, int64_t n_cols,
                        const int64_t* Ap, const int32_t* Aj,
                        const int64_t* Bp, const int32_t* Bj,
                        int64_t* row_nnz) {
  int64_t nt = spgemm_nthreads(n_rows);
  std::vector<std::thread> threads;
  int64_t step = (n_rows + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t r0 = t * step, r1 = std::min(n_rows, r0 + step);
    if (r0 >= r1) break;
    threads.emplace_back(spgemm_nnz_range, r0, r1, n_cols, Ap, Aj, Bp,
                         Bj, row_nnz);
  }
  for (auto& th : threads) th.join();
}

// Pass 2: fill Cj/Cx (Cp from pass 1's cumsum). Rows come out sorted.
void spectra_spgemm_fill(int64_t n_rows, int64_t n_cols,
                         const int64_t* Ap, const int32_t* Aj,
                         const double* Ax, const int64_t* Bp,
                         const int32_t* Bj, const double* Bx,
                         const int64_t* Cp, int32_t* Cj, double* Cx) {
  int64_t nt = spgemm_nthreads(n_rows);
  std::vector<std::thread> threads;
  int64_t step = (n_rows + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t r0 = t * step, r1 = std::min(n_rows, r0 + step);
    if (r0 >= r1) break;
    threads.emplace_back(spgemm_fill_range, r0, r1, n_cols, Ap, Aj, Ax,
                         Bp, Bj, Bx, Cp, Cj, Cx);
  }
  for (auto& th : threads) th.join();
}

// Threaded CSR matvec y = A x (the hierarchy build's power-iteration
// driver; scipy's csr_matvec is single-core).
void spectra_csr_matvec(int64_t n_rows, const int64_t* Ap,
                        const int32_t* Aj, const double* Ax,
                        const double* x, double* y) {
  int64_t nt = spgemm_nthreads(n_rows);
  std::vector<std::thread> threads;
  int64_t step = (n_rows + nt - 1) / nt;
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      double acc = 0.0;
      for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k) acc += Ax[k] * x[Aj[k]];
      y[i] = acc;
    }
  };
  for (int64_t t = 0; t < nt; ++t) {
    int64_t r0 = t * step, r1 = std::min(n_rows, r0 + step);
    if (r0 >= r1) break;
    threads.emplace_back(work, r0, r1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
