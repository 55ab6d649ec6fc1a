"""Composed operators of the five generalized symmetric modes.

Port of :mod:`spectra_tpu.matop.internal_ops` (reference:
include/Spectra/MatOp/internal/SymGEigsCholeskyOp.h:27-87,
SymGEigsRegInvOp.h:25-84, SymGEigsShiftInvertOp.h:28-95,
SymGEigsBucklingOp.h:29-95, SymGEigsCayleyOp.h:28-105). Each is a
composition of its sub-operators on their device; they are
dataclasses, so the drivers' inner-tolerance coupling reaches an
iterative shift-solve inside them.

Each carries the row mesh of a sharded sub-operator (``mesh``), so that
the solver's inner products sum over its ranks. The Cholesky and
RegularInverse modes hold B's factor or B itself whole (replicated on
every rank): over a row-sharded A their solves run on the all-gathered
vector and each rank keeps its rows (:func:`whole_rows`), what GSPMD
does with a replicated operand of a row-sharded one.
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

    @property
    def mesh(self):
        """The row mesh of a sharded sub-operator, else None."""
        for field in dataclasses.fields(self):
            mesh = getattr(getattr(self, field.name), "mesh", None)
            if mesh is not None:
                return mesh
        return None


def whole_rows(fn, x, mesh):
    """``fn`` (of a whole vector or block) on ``x``; for x holding a
    rank's rows of a row ``mesh``, on the all-gathered x, replicated on
    every rank, each keeping its rows."""
    if mesh is None:
        return fn(x)
    return mesh.local_rows(fn(mesh.all_gather(x))).contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class RowsOfWhole:
    """A whole (replicated) operator, B of the RegularInverse mode,
    applied to a rank's rows of ``mesh`` through :func:`whole_rows`: the
    metric of a row-sharded problem."""

    op: object
    mesh: object

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def rows(self) -> int:
        return self.op.rows()

    def cols(self) -> int:
        return self.op.cols()

    def perform_op(self, x):
        return whole_rows(self.op.perform_op, x, self.mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsCholeskyOp(_Composed):
    """y = L^{-1} A L^{-H} x: the Cholesky mode
    (reference: internal/SymGEigsCholeskyOp.h:27-87)."""

    op: object  # A matprod
    chol: object  # Cholesky of B

    def perform_op(self, x):
        mesh = self.mesh
        w = whole_rows(self.chol.upper_triangular_solve, x, mesh)
        z = self.op.perform_op(w)
        return whole_rows(self.chol.lower_triangular_solve, z, mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class SymGEigsRegInvOp(_Composed):
    """y = B^{-1} A x: the RegularInverse mode
    (reference: internal/SymGEigsRegInvOp.h:25-84)."""

    op: object  # A matprod
    binv: object  # SparseRegularInverse of B

    def perform_op(self, x):
        return whole_rows(self.binv.solve, self.op.perform_op(x), self.mesh)


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
