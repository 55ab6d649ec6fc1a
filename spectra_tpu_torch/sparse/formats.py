"""Device sparse matrix formats.

Port of :mod:`spectra_tpu.sparse.formats`. Two formats:

* **ELLPACK** (:class:`EllMatrix`): every row padded to a fixed width
  ``L = max nnz/row`` with (column 0, value 0) entries, so the SpMV
  ``y[i] = sum_l vals[i, l] * x[cols[i, l]]`` is a gather and a row
  sum in plain torch.
* **DIA** (:class:`DiaMatrix`): ``data[k, i] = A[i, i + offsets[k]]``
  for banded and stencil matrices (the grid Laplacians). Its ``matvec``
  and ``matmat`` run the hand-written kernel
  :func:`spectra_tpu_torch.ops.dia_spmv.dia_spmv` on the card.

Host conversion from scipy.sparse or dense numpy runs once, when an
operator is built, and places the arrays on ``device`` (``None`` means
the GPU; see :func:`spectra_tpu_torch.util.capabilities.resolve_device`).
The JAX package's hi/lo-plane ``DiaHiLoMatrix`` waits for its slice
(ROADMAP.md item 10).
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.ops.dia_spmv import dia_spmv
from spectra_tpu_torch.util.capabilities import resolve_device
from spectra_tpu_torch.util.dtypes import numpy_dtype


def _to_device(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class EllMatrix:
    """Fixed-width (ELLPACK) sparse matrix.

    Attributes:
      cols: (n_rows, L) int64 column indices, padded with 0.
      vals: (n_rows, L) values, padded with 0.
      n_rows, n_cols: logical shape.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self) -> int:
        """Stored entries, padding included."""
        return int(self.cols.shape[0] * self.cols.shape[1])

    def matvec(self, x):
        """y = A x (1-D x): gather and row sum."""
        return torch.sum(self.vals * x[self.cols], dim=1)

    def matmat(self, X):
        """Y = A X for a block of vectors (columns of X)."""
        return torch.einsum("rl,rlk->rk", self.vals, X[self.cols, :])

    def rmatvec(self, x):
        """y = A^H x by scatter-add."""
        contrib = self.vals.conj() * x[:, None]
        y = torch.zeros(self.n_cols, dtype=self.dtype, device=self.device)
        return y.index_add_(0, self.cols.reshape(-1), contrib.reshape(-1))

    def element(self, i, j):
        """A[i, j] (0 if not stored). Padded entries have value 0."""
        hit = self.cols[i] == j
        return torch.sum(torch.where(hit, self.vals[i], 0))

    def diagonal(self):
        i = torch.arange(self.n_rows, device=self.device)[:, None]
        return torch.sum(torch.where(self.cols == i, self.vals, 0), dim=1)

    def to_dense(self):
        A = torch.zeros(
            (self.n_rows, self.n_cols), dtype=self.dtype, device=self.device
        )
        rows = torch.arange(self.n_rows, device=self.device)[:, None]
        rows = rows.expand_as(self.cols)
        return A.index_put_((rows, self.cols), self.vals, accumulate=True)


def _ell_arrays_from_csr(indptr, indices, data, n_rows, pad_width=None):
    """Vectorized host-side CSR -> padded ELL conversion."""
    nnz_per_row = np.diff(indptr)
    L = int(nnz_per_row.max()) if n_rows and nnz_per_row.size else 1
    if pad_width is not None:
        L = max(L, int(pad_width))
    L = max(L, 1)
    cols = np.zeros((n_rows, L), dtype=np.int64)
    vals = np.zeros((n_rows, L), dtype=data.dtype)
    # Position of each nnz within its row:
    offs = np.arange(len(indices)) - np.repeat(indptr[:-1], nnz_per_row)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols[rows, offs] = indices
    vals[rows, offs] = data
    return cols, vals


def ell_from_scipy(sp_mat, dtype=None, pad_width=None, device=None):
    """Build an :class:`EllMatrix` from any scipy.sparse matrix."""
    device = resolve_device(device)
    csr = sp_mat.tocsr()
    csr.sum_duplicates()
    n_rows, n_cols = csr.shape
    dtype = numpy_dtype(dtype)
    data = csr.data if dtype is None else csr.data.astype(dtype)
    cols, vals = _ell_arrays_from_csr(
        csr.indptr, csr.indices, data, n_rows, pad_width
    )
    return EllMatrix(
        cols=_to_device(cols, device),
        vals=_to_device(vals, device),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def ell_from_dense(mat, pad_width=None, device=None):
    """Build an :class:`EllMatrix` from a dense array's nonzeros."""
    device = resolve_device(device)
    mat = np.asarray(mat)
    n_rows, n_cols = mat.shape
    mask = mat != 0
    nnz_per_row = mask.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(nnz_per_row)])
    rows, cols_idx = np.nonzero(mask)
    data = mat[rows, cols_idx]
    cols, vals = _ell_arrays_from_csr(indptr, cols_idx, data, n_rows, pad_width)
    return EllMatrix(
        cols=_to_device(cols, device),
        vals=_to_device(vals, device),
        n_rows=n_rows,
        n_cols=n_cols,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class DiaMatrix:
    """Diagonal (DIA) sparse storage for banded and stencil matrices.

    ``data[k, i] = A[i, i + offsets[k]]`` (row-aligned), so the SpMV is

        y[i] = sum_k data[k, i] * x[i + offsets[k]]

    with no gathers. ``offsets`` are Python ints, strictly increasing.
    Out-of-range positions of each diagonal hold zeros.
    """

    data: torch.Tensor  # (d, n_rows)
    offsets: tuple
    n_rows: int
    n_cols: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    def matvec(self, x):
        return dia_spmv(self.data, self.offsets, x, self.n_cols)

    def matmat(self, X):
        return dia_spmv(self.data, self.offsets, X.contiguous(), self.n_cols)

    def rmatvec(self, x):
        """y = A^H x: diagonal ``off`` of A is diagonal ``-off`` of A^H
        with row-aligned values ``conj(data[k, i - off])``."""
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        out_len = self.n_cols
        y = torch.zeros(out_len, dtype=self.dtype, device=self.device)
        tail = lo + max(0, out_len - self.n_rows)
        for k, off in enumerate(self.offsets):
            # contribution to y[j]: conj(A[j-off, j]) x[j-off]
            w = torch.nn.functional.pad(self.data[k].conj() * x, (hi, tail))
            y = y + w[hi - off : hi - off + out_len]
        return y

    def element(self, i: int, j: int):
        for k, off in enumerate(self.offsets):
            if j - i == off:
                return self.data[k, i]
        return torch.zeros((), dtype=self.dtype, device=self.device)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.dtype, device=self.device)

    def to_dense(self):
        A = torch.zeros(
            (self.n_rows, self.n_cols), dtype=self.dtype, device=self.device
        )
        i = torch.arange(self.n_rows, device=self.device)
        for k, off in enumerate(self.offsets):
            j = i + off
            ok = (j >= 0) & (j < self.n_cols)
            A[i[ok], j[ok]] += self.data[k][ok]
        return A


def _dia_host_arrays(sp_mat, dtype=None):
    """Row-aligned host DIA arrays ``(offsets, rows, n_rows, n_cols)``
    from scipy sparse, through scipy's ``todia``. (The JAX package
    first tries its threaded native converter; that waits for its own
    slice.)"""
    csr = sp_mat.tocsr()
    n_rows, n_cols = csr.shape
    dia = csr.todia()
    offsets = tuple(int(o) for o in dia.offsets)
    dtype = numpy_dtype(dtype)
    data = dia.data if dtype is None else dia.data.astype(dtype)
    # scipy aligns data[k] by column index; shift to row alignment:
    # row_data[k, i] = A[i, i+off] = scipy_data[k, i+off].
    rows = np.zeros((len(offsets), n_rows), dtype=data.dtype)
    width = data.shape[1]  # scipy may store fewer than n_cols columns
    for k, off in enumerate(offsets):
        lo = max(0, -off)
        hi = min(n_rows, n_cols - off, width - off)
        if hi > lo:
            rows[k, lo:hi] = data[k, lo + off : hi + off]
    order = np.argsort(offsets)
    return tuple(offsets[i] for i in order), rows[order], n_rows, n_cols


def dia_from_scipy(sp_mat, dtype=None, device=None) -> DiaMatrix:
    """Build a row-aligned :class:`DiaMatrix` from scipy sparse."""
    device = resolve_device(device)
    offsets, rows, n_rows, n_cols = _dia_host_arrays(sp_mat, dtype)
    return DiaMatrix(
        data=_to_device(rows, device),
        offsets=offsets,
        n_rows=n_rows,
        n_cols=n_cols,
    )


def dia_device_from_scipy(sp_mat, dtype=None, device=None) -> DiaMatrix:
    """DIA device storage for the ``format="auto"`` route. On the TPU
    the JAX package sends large f64 stencils to hi/lo f32 planes here;
    the card has native f64, and that route waits for slice B
    (ROADMAP.md item 10), so every matrix becomes a :class:`DiaMatrix`."""
    return dia_from_scipy(sp_mat, dtype=dtype, device=device)


def dia_suitability(sp_mat, max_diags: int = 32) -> bool:
    """True when the matrix is banded enough that DIA beats ELL: few
    distinct diagonals and low fill overhead."""
    csr = sp_mat.tocsr()
    coo = csr.tocoo()
    if coo.nnz == 0:
        return False
    diags = np.unique(coo.col - coo.row)
    if len(diags) > max_diags:
        return False
    stored = len(diags) * csr.shape[0]
    return stored <= 4 * coo.nnz


def symmetrize_scipy(sp_mat, uplo: str = "L", conjugate: bool = False):
    """Full symmetric/Hermitian matrix from one triangle of a scipy
    sparse matrix (the reference's ``selfadjointView`` convention)."""
    import scipy.sparse as sps

    csr = sp_mat.tocsr()
    if uplo == "L":
        tri = sps.tril(csr, 0, format="csr")
        off = sps.tril(csr, -1, format="csr")
    elif uplo == "U":
        tri = sps.triu(csr, 0, format="csr")
        off = sps.triu(csr, 1, format="csr")
    else:
        raise ValueError("uplo must be 'L' or 'U'")
    other = off.conjugate().T if conjugate else off.T
    return (tri + other).tocsr()
