"""Device sparse matrix formats.

Port of :mod:`spectra_tpu.sparse.formats`. Three formats:

* **ELLPACK** (:class:`EllMatrix`): every row padded to a fixed width
  ``L = max nnz/row`` with (column 0, value 0) entries, so the SpMV
  ``y[i] = sum_l vals[i, l] * x[cols[i, l]]`` is a gather and a row
  sum in plain torch.
* **DIA** (:class:`DiaMatrix`): ``data[k, i] = A[i, i + offsets[k]]``
  for banded and stencil matrices (the grid Laplacians). Its ``matvec``
  and ``matmat`` run the hand-written kernel
  :func:`spectra_tpu_torch.ops.dia_spmv.dia_spmv` on the card.
* **DIA hi/lo** (:class:`DiaHiLoMatrix`): the f64 diagonals as two f32
  planes; its ``matvec`` runs the double-single kernel's f64 entry
  :func:`spectra_tpu_torch.ops.dia_ds.dia_spmv_ds_f64` on the card, one
  launch per SpMV (about 2^-48 relative).

Host conversion from scipy.sparse or dense numpy runs once, when an
operator is built, and places the arrays on ``device`` (``None`` means
the GPU; see :func:`spectra_tpu_torch.util.capabilities.resolve_device`).

Routing (:func:`hilo_route`): the port routes as the JAX package does on
its accelerator. A square f64 DIA matrix on the card whose SpMV working
set ``(d + 2) * 8 * n`` reaches :data:`HILO_BYTES_THRESHOLD` becomes a
:class:`DiaHiLoMatrix` in :func:`dia_device_from_scipy` and
:func:`maybe_hilo`, so the port computes what the JAX package computes
on the TPU: double-single SpMVs for stencils that live in device
memory. On the CPU nothing is routed, as the JAX package routes nothing
off the TPU.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.ops.dia_ds import (
    combine_f64,
    dia_spmv_ds_f64,
    hilo_suitable,
    split_f64,
)
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


#: The hi/lo planes' leading dimension is a multiple of this many f32
#: (128 bytes): every diagonal then starts 16-byte aligned.
PLANE_ALIGN = 32


def plane_ld(n: int) -> int:
    """Leading dimension of hi/lo planes for ``n`` rows: ``n`` rounded up
    to :data:`PLANE_ALIGN`."""
    return -(-n // PLANE_ALIGN) * PLANE_ALIGN


@dataclasses.dataclass(frozen=True, eq=False)
class DiaHiLoMatrix:
    """DIA matrix stored as f32 hi/lo planes: ``data_hi + data_lo`` is
    the two-term decomposition of the f64 diagonals (``hi = f32(a)``,
    ``lo = f32(a - hi)``, residual <= 2^-48 relative, a backward
    perturbation of A far under any solver tolerance).

    ``matvec`` splits x the same way, runs the double-single SpMV and
    combines the result to f64, all in one launch of the kernel's f64
    entry on the card (its plain version on the CPU); it never switches to
    the f64 :class:`DiaMatrix`. ``matmat`` runs one column per launch, as
    the JAX package's ``lax.map`` does. The other accessors read the
    planes' first ``n_rows`` columns without building the whole f64
    matrix, except ``to_dia``, ``data``, ``rmatvec`` and ``to_dense``.

    The planes' leading dimension is ``n_rows`` rounded up to
    :data:`PLANE_ALIGN` (zeros beyond ``n_rows``), as the JAX format pads
    its planes to a multiple of its chunk: then every diagonal starts
    aligned and each thread's rows are one vector load for the kernel.
    """

    data_hi: torch.Tensor  # (d, ld) f32, ld = n_rows rounded up to PLANE_ALIGN
    data_lo: torch.Tensor  # (d, ld) f32
    offsets: tuple
    n_rows: int
    n_cols: int

    @property
    def dtype(self):
        return torch.float64

    @property
    def device(self):
        return self.data_hi.device

    @property
    def nnz(self) -> int:
        return int(self.data_hi.shape[0] * self.n_rows)

    @classmethod
    def from_dia(cls, dia: "DiaMatrix") -> "DiaHiLoMatrix":
        if not hilo_suitable(dia.dtype, dia.n_rows, dia.n_cols, len(dia.offsets)):
            raise ValueError(
                "the hi/lo format takes a square f64 DIA matrix with at most "
                "64 diagonals"
            )
        d, n = dia.data.shape
        planes = []
        for plane in split_f64(dia.data):
            padded = torch.zeros(
                (d, plane_ld(n)), dtype=torch.float32, device=dia.device
            )
            padded[:, :n] = plane
            planes.append(padded)
        return cls(
            data_hi=planes[0], data_lo=planes[1], offsets=dia.offsets,
            n_rows=dia.n_rows, n_cols=dia.n_cols,
        )

    def to_dia(self) -> "DiaMatrix":
        """The f64 :class:`DiaMatrix` of the planes' sum (a full f64
        copy of the diagonals)."""
        n = self.n_rows
        return DiaMatrix(
            data=combine_f64(self.data_hi[:, :n], self.data_lo[:, :n]),
            offsets=self.offsets,
            n_rows=self.n_rows,
            n_cols=self.n_cols,
        )

    @property
    def data(self):
        return self.to_dia().data

    def row_abs_sums(self):
        """``sum_k |a_k[i]|`` per row, one diagonal at a time, so no
        (d, n) f64 copy is made."""
        acc = torch.zeros(self.n_rows, dtype=torch.float64, device=self.device)
        n = self.n_rows
        for k in range(len(self.offsets)):
            acc = acc + combine_f64(self.data_hi[k, :n], self.data_lo[k, :n]).abs()
        return acc

    def matvec(self, x):
        """``A x`` for f64 x (a TypeError for any other dtype)."""
        return dia_spmv_ds_f64(
            self.data_hi, self.data_lo, x, offsets=self.offsets, n=self.n_rows
        )

    def matmat(self, X):
        return torch.stack(
            [self.matvec(X[:, c].contiguous()) for c in range(X.shape[1])],
            dim=1,
        )

    def rmatvec(self, x):
        return self.to_dia().rmatvec(x)

    def element(self, i: int, j: int):
        if j - i in self.offsets:
            k = self.offsets.index(j - i)
            return combine_f64(self.data_hi[k, i], self.data_lo[k, i])
        return torch.zeros((), dtype=self.dtype, device=self.device)

    def diagonal(self):
        if 0 in self.offsets:
            k, n = self.offsets.index(0), self.n_rows
            return combine_f64(self.data_hi[k, :n], self.data_lo[k, :n])
        return torch.zeros(self.n_rows, dtype=self.dtype, device=self.device)

    def to_dense(self):
        return self.to_dia().to_dense()


#: SpMV working-set bytes ``(d + 2) * 8 * n`` from which a square f64
#: DIA matrix on the card is stored as hi/lo planes: the JAX package's
#: threshold (``spectra_tpu/sparse/formats.py:361``), kept so that the
#: port computes what the JAX package computes on its accelerator.
HILO_BYTES_THRESHOLD = 120 * 1024 * 1024


def hilo_route(dtype, n_rows: int, n_cols: int, d: int, device_type: str,
               threshold: int | None = None) -> bool:
    """Whether a DIA matrix of this dtype, shape and number of diagonals
    on a device of ``device_type`` is stored as hi/lo planes: only on
    ``"cuda"``, only where the kernel takes it, and only from
    ``threshold`` bytes of working set (default
    :data:`HILO_BYTES_THRESHOLD`)."""
    limit = HILO_BYTES_THRESHOLD if threshold is None else threshold
    return (
        device_type == "cuda"
        and numpy_dtype(dtype) == np.float64
        and hilo_suitable(torch.float64, n_rows, n_cols, d)
        and (d + 2) * 8 * n_rows >= limit
    )


def maybe_hilo(dia, threshold: int | None = None):
    """``dia`` as a :class:`DiaHiLoMatrix` where :func:`hilo_route` says
    so, else ``dia`` itself."""
    if not isinstance(dia, DiaMatrix):
        return dia
    if not hilo_route(dia.dtype, dia.n_rows, dia.n_cols, len(dia.offsets),
                      dia.device.type, threshold):
        return dia
    return DiaHiLoMatrix.from_dia(dia)


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


def dia_device_from_scipy(sp_mat, dtype=None, device=None):
    """DIA device storage for the ``format="auto"`` route, with the
    hi/lo routing (:func:`hilo_route`) decided before any transfer: a
    routed matrix is split into its two f32 planes on the host and only
    the planes go to the card (no f64 copy on the device)."""
    device = resolve_device(device)
    offsets, rows, n_rows, n_cols = _dia_host_arrays(sp_mat, dtype)
    if hilo_route(rows.dtype, n_rows, n_cols, len(offsets), device.type):
        # split_f64 on the host, into planes padded as from_dia pads them
        hi = np.zeros((len(offsets), plane_ld(n_rows)), dtype=np.float32)
        lo = np.zeros_like(hi)
        hi[:, :n_rows] = rows
        lo[:, :n_rows] = rows - hi[:, :n_rows].astype(np.float64)
        del rows
        return DiaHiLoMatrix(
            data_hi=_to_device(hi, device),
            data_lo=_to_device(lo, device),
            offsets=offsets,
            n_rows=n_rows,
            n_cols=n_cols,
        )
    return DiaMatrix(
        data=_to_device(rows, device),
        offsets=offsets,
        n_rows=n_rows,
        n_cols=n_cols,
    )


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
