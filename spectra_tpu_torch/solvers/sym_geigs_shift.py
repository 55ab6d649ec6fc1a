"""Generalized symmetric eigensolver: the spectral-transform modes.

Port of :mod:`spectra_tpu.solvers.sym_geigs_shift` (reference:
include/Spectra/SymGEigsShiftSolver.h:147-205 ShiftInvert, :307-369
Buckling, :399-460 Cayley):

* ``ShiftInvert``: ``(A - sigma B)^{-1} B`` under the B-inner product;
  ``nu = 1/(lambda - sigma)``, ``lambda = sigma + 1/nu``;
* ``Buckling``: ``K x = lambda K_G x`` with K SPD;
  ``(K - sigma K_G)^{-1} K`` under the K-inner product;
  ``nu = lambda/(lambda - sigma)``, ``lambda = sigma nu/(nu - 1)``;
* ``Cayley``: ``x + 2 sigma (A - sigma B)^{-1} B x`` under the
  B-inner product; ``nu = (lambda + sigma)/(lambda - sigma)``,
  ``lambda = sigma (nu + 1)/(nu - 1)``.

As in the reference, the selection rule applies to the transformed
values nu, and ``sorting`` orders the returned lambda. Each mode is a
private subclass that sets ``_ritz_transform``, as in the JAX package.

Example
-------
>>> import spectra_tpu_torch as stt
>>> op = stt.SymShiftInvert.create(A, B, method="mg").set_shift(0.0)
>>> bop = stt.SparseSymMatProd.from_full(B)
>>> eigs = stt.SymGEigsShiftSolver.from_factored(op, bop, 10, 30, 0.0)
>>> nconv = eigs.compute(stt.SortRule.LargestMagn, tol=1e-10)
"""

import torch

from spectra_tpu_torch.matop.internal_ops import (
    SymGEigsBucklingOp,
    SymGEigsCayleyOp,
    SymGEigsShiftInvertOp,
)
from spectra_tpu_torch.solvers.base import HermEigsBase
from spectra_tpu_torch.util.geigsmode import GEigsMode


def _shift_invert_transform(nu, sigma):
    return sigma + 1.0 / nu


def _buckling_transform(nu, sigma):
    return sigma * nu / (nu - 1.0)


def _cayley_transform(nu, sigma):
    return sigma * (nu + 1.0) / (nu - 1.0)


class SymGEigsShiftSolver(HermEigsBase):
    """Shift-mode generalized symmetric solver.

    ``op`` is a :class:`~spectra_tpu_torch.matop.sym_shift_invert.
    SymShiftInvert` of (A, B), or of (K, K_G) in the Buckling mode;
    ``bop`` the matprod of B (ShiftInvert, Cayley) or of K (Buckling),
    which is both a factor of the operator and the inner product's
    metric. ``mode`` is ``GEigsMode.ShiftInvert`` (the default),
    ``Buckling`` or ``Cayley``.
    """

    _mode = "lanczos"

    def __init__(self, op, bop, nev: int, ncv: int, sigma: float,
                 mode=GEigsMode.ShiftInvert, _factored=None):
        if mode == GEigsMode.Buckling and float(sigma) == 0.0:
            raise ValueError("Buckling mode requires a nonzero shift")
        if mode not in _MODES:
            raise ValueError(
                "SymGEigsShiftSolver supports ShiftInvert, Buckling and "
                "Cayley modes; use SymGEigsSolver for Cholesky/RegularInverse"
            )
        solve = _factored if _factored is not None else op.set_shift(sigma)
        if mode == GEigsMode.ShiftInvert:
            composed = SymGEigsShiftInvertOp(solve=solve, bop=bop)
        elif mode == GEigsMode.Buckling:
            composed = SymGEigsBucklingOp(solve=solve, kop=bop)
        else:
            composed = SymGEigsCayleyOp(
                solve=solve, bop=bop,
                sigma=torch.tensor(sigma, dtype=solve.dtype, device=solve.device),
            )
        self.__class__ = _MODES[mode]
        HermEigsBase.__init__(self, composed, nev, ncv, bop=bop)
        self._sigma = float(sigma)
        self._geigs_mode = mode

    @classmethod
    def from_factored(cls, solve, bop, nev: int, ncv: int, sigma: float,
                      mode=GEigsMode.ShiftInvert):
        """Build around an already-factored ``(A - sigma B)^{-1}`` (the
        result of ``SymShiftInvert(...).set_shift(sigma)``), so that the
        factorization can be reused or timed apart."""
        return cls(None, bop, nev, ncv, sigma, mode, _factored=solve)

    def _transform_aux(self):
        return self._sigma


class _ShiftInvertSolver(SymGEigsShiftSolver):
    _ritz_transform = staticmethod(_shift_invert_transform)


class _BucklingSolver(SymGEigsShiftSolver):
    _ritz_transform = staticmethod(_buckling_transform)


class _CayleySolver(SymGEigsShiftSolver):
    _ritz_transform = staticmethod(_cayley_transform)


_MODES = {
    GEigsMode.ShiftInvert: _ShiftInvertSolver,
    GEigsMode.Buckling: _BucklingSolver,
    GEigsMode.Cayley: _CayleySolver,
}
