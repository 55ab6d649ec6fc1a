"""Composed operators of the five generalized symmetric modes.

Port of :mod:`spectra_tpu.matop.internal_ops` (reference:
include/Spectra/MatOp/internal/SymGEigsCholeskyOp.h:27-87,
SymGEigsRegInvOp.h:25-84, SymGEigsShiftInvertOp.h:28-95,
SymGEigsBucklingOp.h:29-95, SymGEigsCayleyOp.h:28-105). Each is a
composition of its sub-operators on their device; they are
dataclasses, so the drivers' inner-tolerance coupling reaches an
iterative shift-solve inside them.
"""

import dataclasses

import torch


class _Composed:
    """``dtype``, ``device``, ``rows`` and ``cols`` of the operator
    named by ``_inner``."""

    _inner = "op"

    @property
    def dtype(self):
        return getattr(self, self._inner).dtype

    @property
    def device(self):
        return getattr(self, self._inner).device

    def rows(self) -> int:
        return getattr(self, self._inner).rows()

    def cols(self) -> int:
        return getattr(self, self._inner).cols()


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsCholeskyOp(_Composed):
    """y = L^{-1} A L^{-H} x: the Cholesky mode
    (reference: internal/SymGEigsCholeskyOp.h:27-87)."""

    op: object  # A matprod
    chol: object  # Cholesky of B

    def perform_op(self, x):
        w = self.chol.upper_triangular_solve(x)
        z = self.op.perform_op(w)
        return self.chol.lower_triangular_solve(z)


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsRegInvOp(_Composed):
    """y = B^{-1} A x: the RegularInverse mode
    (reference: internal/SymGEigsRegInvOp.h:25-84)."""

    op: object  # A matprod
    binv: object  # SparseRegularInverse of B

    def perform_op(self, x):
        return self.binv.solve(self.op.perform_op(x))


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsShiftInvertOp(_Composed):
    """y = (A - sigma B)^{-1} B x: the ShiftInvert mode
    (reference: internal/SymGEigsShiftInvertOp.h:28-95)."""

    _inner = "solve"
    solve: object  # factored (A - sigma B)^{-1}
    bop: object  # B matprod

    def perform_op(self, x):
        return self.solve.perform_op(self.bop.perform_op(x))


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsBucklingOp(_Composed):
    """y = (K - sigma K_G)^{-1} K x: the Buckling mode; ``kop`` supplies
    K x (reference: internal/SymGEigsBucklingOp.h:29-95)."""

    _inner = "solve"
    solve: object  # factored (K - sigma K_G)^{-1}
    kop: object  # K matprod

    def perform_op(self, x):
        return self.solve.perform_op(self.kop.perform_op(x))


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsCayleyOp(_Composed):
    """y = x + 2 sigma (A - sigma B)^{-1} B x: the Cayley mode
    (reference: internal/SymGEigsCayleyOp.h:28-105, the algebraic
    shortcut for (A - sigma B)^{-1} (A + sigma B)). ``sigma`` is a 0-d
    tensor in the solve's dtype, on its device."""

    _inner = "solve"
    solve: object
    bop: object
    sigma: torch.Tensor

    def perform_op(self, x):
        y = self.solve.perform_op(self.bop.perform_op(x))
        return x + (2.0 * self.sigma) * y
