"""Sparse matrix-product operators: the per-iteration hot operation.

Port of :mod:`spectra_tpu.matop.sparse` (reference:
include/Spectra/MatOp/SparseSymMatProd.h:31-108, SparseGenMatProd.h,
SparseHermMatProd.h).
``create`` accepts a scipy.sparse matrix or a dense numpy array;
``format="auto"`` stores banded matrices as DIA (the hand-written
kernel on the card), large f64 stencils on the card as hi/lo DIA planes
(:func:`~spectra_tpu_torch.sparse.formats.hilo_route`), and everything
else as ELLPACK; ``format="dia_hilo"`` asks for the hi/lo planes. A
complex matrix is always ELL: the kernel takes f32 and f64. The
reference's ``Uplo`` triangle selection is applied once on the host.

Every constructor takes ``device``; ``None`` means the GPU and raises
when there is none.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.sparse.formats import (
    DiaHiLoMatrix,
    DiaMatrix,
    EllMatrix,
    dia_device_from_scipy,
    dia_from_scipy,
    dia_suitability,
    ell_from_dense,
    ell_from_scipy,
    symmetrize_scipy,
)
from spectra_tpu_torch.util.dtypes import numpy_dtype


def _is_scipy_sparse(mat) -> bool:
    return hasattr(mat, "tocsr") and hasattr(mat, "shape")


def _to_ell(mat, dtype=None, format: str = "auto", device=None):
    """Device storage selection: ``"auto"`` picks DIA for banded
    matrices (gather-free stencil SpMV), ELL otherwise."""
    if isinstance(mat, (EllMatrix, DiaMatrix, DiaHiLoMatrix)):
        return mat
    if _is_scipy_sparse(mat):
        if format == "dia_hilo":
            return DiaHiLoMatrix.from_dia(
                dia_from_scipy(mat, dtype=dtype, device=device)
            )
        if format == "auto" and dia_suitability(mat):
            return dia_device_from_scipy(mat, dtype=dtype, device=device)
        if format == "dia":
            return dia_from_scipy(mat, dtype=dtype, device=device)
        return ell_from_scipy(mat, dtype=dtype, device=device)
    mat = np.asarray(mat, dtype=numpy_dtype(dtype))
    if format == "dia":
        import scipy.sparse as sps

        return dia_from_scipy(sps.csr_matrix(mat), dtype=dtype, device=device)
    return ell_from_dense(mat, device=device)


def _dense_triangle(mat, uplo, conjugate):
    mat = np.asarray(mat)
    if uplo == "L":
        tri = np.tril(mat)
        off = np.tril(mat, -1)
    elif uplo == "U":
        tri = np.triu(mat)
        off = np.triu(mat, 1)
    else:
        raise ValueError("uplo must be 'L' or 'U'")
    return tri + (off.conj().T if conjugate else off.T)


class _EllProdBase:
    """Shared matvec/diagonal/element plumbing over the device matrix."""

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def device(self):
        return self.ell.device

    def rows(self) -> int:
        return self.ell.n_rows

    def cols(self) -> int:
        return self.ell.n_cols

    def perform_op(self, x):
        if x.ndim == 1:
            return self.ell.matvec(x)
        return self.ell.matmat(x)

    def element(self, i, j):
        return self.ell.element(i, j)

    def diagonal(self):
        return self.ell.diagonal()


@dataclasses.dataclass(frozen=True, eq=False)
class SparseGenMatProd(_EllProdBase):
    """y = A x for a general sparse (real or complex) matrix."""

    ell: object  # EllMatrix, DiaMatrix or DiaHiLoMatrix

    @classmethod
    def create(cls, mat, dtype=None, format: str = "auto", device=None):
        return cls(ell=_to_ell(mat, dtype, format, device))

    def perform_trans_op(self, x):
        """y = A^T x (the partial SVD's Gram operators), a vector or a
        block."""
        if self.dtype.is_complex:
            return self.perform_adjoint_op(x.conj()).conj_physical()
        return self.perform_adjoint_op(x)

    def perform_adjoint_op(self, x):
        """y = A^H x, a vector or a block (one column at a time: the
        wide partial SVD's ``matrix_V``). On DIA this is the plain
        shifted-slice sum of ``DiaMatrix.rmatvec``, as in the JAX
        package."""
        if x.ndim == 2:
            return torch.stack(
                [self.ell.rmatvec(x[:, c]) for c in range(x.shape[1])], dim=1
            )
        return self.ell.rmatvec(x)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseSymMatProd(_EllProdBase):
    """y = A x for a sparse real symmetric matrix.

    ``create(mat, uplo)`` reads only the requested triangle, mirroring
    the reference's ``selfadjointView`` input convention
    (reference: MatOp/SparseSymMatProd.h:83-89).
    """

    ell: object  # EllMatrix, DiaMatrix or DiaHiLoMatrix

    @classmethod
    def create(
        cls, mat, uplo: str = "L", dtype=None, format: str = "auto",
        device=None,
    ):
        if _is_scipy_sparse(mat):
            full = symmetrize_scipy(mat, uplo, conjugate=False)
            return cls(ell=_to_ell(full, dtype, format, device))
        full = _dense_triangle(
            np.asarray(mat, dtype=numpy_dtype(dtype)), uplo, conjugate=False
        )
        return cls(ell=ell_from_dense(full, device=device))

    @classmethod
    def from_full(cls, mat, dtype=None, format: str = "auto", device=None):
        """Build from an already-symmetric full matrix (no triangle read)."""
        return cls(ell=_to_ell(mat, dtype, format, device))


@dataclasses.dataclass(frozen=True, eq=False)
class SparseHermMatProd(_EllProdBase):
    """y = A x for a sparse complex Hermitian matrix, always ELL.
    ``create(mat, uplo)`` reads only the requested triangle."""

    ell: EllMatrix

    @classmethod
    def create(cls, mat, uplo: str = "L", dtype=None, device=None):
        if _is_scipy_sparse(mat):
            full = symmetrize_scipy(mat, uplo, conjugate=True)
            return cls(ell=ell_from_scipy(full, dtype=dtype, device=device))
        full = _dense_triangle(
            np.asarray(mat, dtype=numpy_dtype(dtype)), uplo, conjugate=True
        )
        return cls(ell=ell_from_dense(full, device=device))
