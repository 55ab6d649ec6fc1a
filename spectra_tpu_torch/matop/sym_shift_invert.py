"""``(A - sigma B)^{-1} x`` for symmetric A and SPD/SPSD B.

Port of :mod:`spectra_tpu.matop.sym_shift_invert` (reference:
include/Spectra/MatOp/SymShiftInvert.h:128-240). A and B may each be
dense or sparse; the factorizer follows the reference's
SymShiftInvertHelper (SymShiftInvert.h:26-93):

* both sparse: one host SuperLU of the sparse ``A - sigma B``, each
  solve on the host (the splu operator of
  :mod:`spectra_tpu_torch.matop.shift_solve`);
* either dense: the dense ``A - sigma B`` is factored by the
  Bunch-Kaufman LDL^T (:mod:`spectra_tpu_torch.linalg.bkldlt`) on the
  device, where the solves run too;
* ``method`` in ``"cg"``, ``"minres"``, ``"cheb"``, ``"bicgstab"``,
  ``"mg"``: the iterative solves of
  :func:`~spectra_tpu_torch.matop.shift_solve.build_shifted_iterative`
  on the device (format routing, multigrid upgrade, tolerance coupling,
  NaN poisoning). ``"cg"`` maps to MINRES, since ``A - sigma B`` is
  symmetric indefinite in general; ``"cheb"`` needs it SPD.

``set_shift`` returns a new operator.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.linalg import bkldlt
from spectra_tpu_torch.matop.shift_solve import (
    ShiftFactorizationError,
    SparseShiftSolveBase,
    _HostLUSolver,
    _resolve_sparse_method,
    build_shifted_iterative,
)
from spectra_tpu_torch.matop.sparse import _dense_triangle
from spectra_tpu_torch.sparse.formats import symmetrize_scipy
from spectra_tpu_torch.util.capabilities import resolve_device


def _is_scipy_sparse(mat) -> bool:
    return hasattr(mat, "tocsr") and not isinstance(mat, np.ndarray)


@dataclasses.dataclass(frozen=True, eq=False)
class _BKShiftedSolve:
    """``(A - sigma B)^{-1} x`` by the BKLDLT factors, on their device."""

    factors: bkldlt.BKFactors

    @property
    def dtype(self):
        return self.factors.L.dtype

    @property
    def device(self):
        return self.factors.L.device

    def rows(self) -> int:
        return self.factors.L.shape[0]

    def cols(self) -> int:
        return self.factors.L.shape[0]

    def perform_op(self, x):
        return bkldlt.solve(self.factors, x)


class SymShiftInvert:
    """Factory of the shifted solve; A and B each dense or sparse.

    ``create(A, B, uplo_A="L", uplo_B="L", method=None, grid_dims=None,
    device=None)``: pass ``B=None`` for the standard problem (B = I).
    ``method`` replaces the factorization by an iterative solve on the
    device: ``"minres"`` (alias ``"cg"``), ``"cheb"`` or ``"mg"``
    (geometric multigrid for a grid-stencil ``A - sigma B``;
    ``grid_dims`` pins the grid's shape where the sparsity alone does
    not tell it). ``device`` is where the solves run (a host SuperLU's
    results go there).
    """

    def __init__(self, A, B=None, uplo_A="L", uplo_B="L", method=None,
                 grid_dims=None, device=None):
        self._a_sparse = _is_scipy_sparse(A)
        self._b_sparse = B is None or _is_scipy_sparse(B)
        if self._a_sparse:
            self._A = symmetrize_scipy(A, uplo_A, conjugate=False)
        else:
            self._A = _dense_triangle(A, uplo_A, conjugate=False)
        if B is None:
            self._B = None
        elif self._b_sparse:
            self._B = symmetrize_scipy(B, uplo_B, conjugate=False)
        else:
            self._B = _dense_triangle(B, uplo_B, conjugate=False)
        self._method = method
        self._grid_dims = grid_dims
        self._device = device
        n = self._A.shape[0]
        if self._B is not None and self._B.shape[0] != n:
            raise ValueError("A and B must have the same size")
        self._n = n

    @classmethod
    def create(cls, A, B=None, uplo_A="L", uplo_B="L", method=None,
               grid_dims=None, device=None):
        return cls(A, B, uplo_A, uplo_B, method, grid_dims, device)

    @property
    def dtype(self):
        return torch.from_numpy(np.zeros(0, self._A.dtype)).dtype

    def rows(self) -> int:
        return self._n

    def cols(self) -> int:
        return self._n

    def _shifted_host(self, sigma):
        """A - sigma B as a host matrix (scipy sparse or numpy)."""
        import scipy.sparse as sps

        if self._B is None:
            if self._a_sparse:
                return (self._A - sigma * sps.eye(self._n, dtype=self._A.dtype)).tocsr()
            return self._A - sigma * np.eye(self._n, dtype=self._A.dtype)
        if self._a_sparse and self._b_sparse:
            return (self._A - sigma * self._B).tocsr()
        Ad = self._A.toarray() if self._a_sparse else self._A
        Bd = self._B.toarray() if self._b_sparse else self._B
        return Ad - sigma * Bd

    def set_shift(self, sigma):
        import scipy.sparse as sps

        device = resolve_device(self._device)
        shifted = self._shifted_host(sigma)
        method = self._method
        if method is None and _is_scipy_sparse(shifted):
            method = "auto"
        if method is not None:
            method = _resolve_sparse_method(method)
        if method in ("cg", "minres", "cheb", "bicgstab", "mg"):
            if not _is_scipy_sparse(shifted):
                shifted = sps.csr_matrix(shifted)
            return build_shifted_iterative(
                shifted.tocsr(), "minres" if method == "cg" else method,
                grid_dims=self._grid_dims, device=device,
            )
        if _is_scipy_sparse(shifted):
            import scipy.sparse.linalg as spla

            try:
                lu = spla.splu(shifted.tocsc())
            except RuntimeError as err:
                raise ShiftFactorizationError(
                    f"factorization failed: {err}"
                ) from err
            return SparseShiftSolveBase(
                shifted=None, solver=_HostLUSolver(lu, self._n, shifted.dtype),
                n=self._n, method="splu", host_device=device,
            )
        fac = bkldlt.factorize(torch.from_numpy(shifted).to(device), 0.0)
        if not fac.ok:
            raise ShiftFactorizationError(
                "factorization failed: A - sigma * B is singular or "
                "has a non-finite entry"
            )
        return _BKShiftedSolve(factors=fac)
