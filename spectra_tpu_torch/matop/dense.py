"""Dense matrix-product operators.

Port of :mod:`spectra_tpu.matop.dense` (reference:
include/Spectra/MatOp/DenseSymMatProd.h:29-107,
DenseGenMatProd.h:35-113, DenseHermMatProd.h). The matrix is one tensor
on the operator's device and ``perform_op`` is one product (cuBLAS on
the card). The
reference's ``Uplo`` choice of triangle is applied once, at
construction, as in the JAX package: the stored matrix is full.

``create`` takes a numpy array or a tensor and ``device``; ``None``
means the GPU and raises when there is none.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.util.capabilities import resolve_device


def _as_tensor(mat, device):
    if not torch.is_tensor(mat):
        mat = torch.from_numpy(np.array(mat))
    return mat.to(resolve_device(device))


def _symmetrize(mat, uplo):
    """The full symmetric matrix from the ``uplo`` triangle of ``mat``."""
    if uplo == "L":
        return torch.tril(mat) + torch.tril(mat, -1).mT
    if uplo == "U":
        return torch.triu(mat) + torch.triu(mat, 1).mT
    raise ValueError("uplo must be 'L' or 'U'")


def _hermitize(mat, uplo):
    """The full Hermitian matrix from the ``uplo`` triangle of ``mat``
    (the symmetric one for a real ``mat``)."""
    if uplo == "L":
        return torch.tril(mat) + torch.tril(mat, -1).mH
    if uplo == "U":
        return torch.triu(mat) + torch.triu(mat, 1).mH
    raise ValueError("uplo must be 'L' or 'U'")


class _DenseProdBase:
    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def rows(self) -> int:
        return self.mat.shape[0]

    def cols(self) -> int:
        return self.mat.shape[1]

    def perform_op(self, x):
        """y = A x for a vector or a block of columns."""
        return self.mat @ x

    def element(self, i, j):
        return self.mat[i, j]

    def diagonal(self):
        return torch.diagonal(self.mat)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGenMatProd(_DenseProdBase):
    """y = A x for a general dense (real or complex) matrix."""

    mat: torch.Tensor

    @classmethod
    def create(cls, mat, device=None):
        return cls(mat=_as_tensor(mat, device))

    def perform_trans_op(self, x):
        """y = A^T x."""
        return self.mat.mT @ x

    def perform_adjoint_op(self, x):
        """y = A^H x."""
        return self.mat.mH @ x


@dataclasses.dataclass(frozen=True, eq=False)
class DenseSymMatProd(_DenseProdBase):
    """y = A x for a dense real symmetric matrix; ``create(mat, uplo)``
    reads only the ``uplo`` triangle (the reference's
    ``selfadjointView``)."""

    mat: torch.Tensor

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        return cls(mat=_symmetrize(_as_tensor(mat, device), uplo))


@dataclasses.dataclass(frozen=True, eq=False)
class DenseHermMatProd(_DenseProdBase):
    """y = A x for a dense complex Hermitian matrix; ``create(mat, uplo)``
    reads only the ``uplo`` triangle and promotes a real matrix to
    complex128 (f64) or complex64. ``diagonal()`` stays complex, as in
    the JAX package."""

    mat: torch.Tensor

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        mat = _as_tensor(mat, device)
        if not mat.dtype.is_complex:
            mat = mat.to(
                torch.complex128 if mat.dtype == torch.float64 else torch.complex64
            )
        return cls(mat=_hermitize(mat, uplo))
