"""Generalized symmetric eigensolver ``A x = lambda B x``: the direct
modes.

Port of :mod:`spectra_tpu.solvers.sym_geigs` (reference:
include/Spectra/SymGEigsSolver.h:149-215 Cholesky mode, :251-286
RegularInverse mode):

* ``GEigsMode.Cholesky``: B = L L^H; the standard problem for
  ``L^{-1} A L^{-H}``, whose Ritz vectors v give the eigenvectors
  ``x = L^{-H} v``;
* ``GEigsMode.RegularInverse``: ``B^{-1} A`` under the B-inner
  product, with ``B v`` products and CG solves ``B^{-1} v`` only.
"""

from spectra_tpu_torch.matop.internal_ops import (
    RowsOfWhole,
    SymGEigsCholeskyOp,
    SymGEigsRegInvOp,
    whole_rows,
)
from spectra_tpu_torch.solvers.base import HermEigsBase
from spectra_tpu_torch.util.geigsmode import GEigsMode


class SymGEigsSolver(HermEigsBase):
    """Implicitly restarted Lanczos for ``A x = lambda B x`` (B SPD).

    ``op`` is the matprod of A. ``bop`` depends on the mode: a
    :class:`~spectra_tpu_torch.matop.cholesky.DenseCholesky` or
    :class:`~spectra_tpu_torch.matop.cholesky.SparseCholesky` of B in
    the Cholesky mode (the default), a
    :class:`~spectra_tpu_torch.matop.regular_inverse.SparseRegularInverse`
    in the RegularInverse mode. Over a row-sharded A (an operator with a
    ``mesh``) B's factor or B stays whole on every rank: its solves and
    products run on the all-gathered vector, and ``eigenvectors()``
    returns the rank's rows.
    """

    _mode = "lanczos"

    def __init__(self, op, bop, nev: int, ncv: int, mode=GEigsMode.Cholesky):
        if mode == GEigsMode.Cholesky:
            super().__init__(SymGEigsCholeskyOp(op=op, chol=bop), nev, ncv)
            self._chol = bop
        elif mode == GEigsMode.RegularInverse:
            mesh = getattr(op, "mesh", None)
            metric = bop if mesh is None else RowsOfWhole(bop, mesh)
            super().__init__(SymGEigsRegInvOp(op=op, binv=bop), nev, ncv, bop=metric)
            self._chol = None
        else:
            raise ValueError(
                "SymGEigsSolver supports Cholesky and RegularInverse modes; "
                "use SymGEigsShiftSolver for ShiftInvert/Buckling/Cayley"
            )
        self._geigs_mode = mode

    def _vector_transform(self, vecs):
        if self._chol is None:
            return vecs
        return whole_rows(self._chol.upper_triangular_solve, vecs, self._mesh)
