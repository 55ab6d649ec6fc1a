"""Shift-and-invert symmetric eigensolver.

Port of :mod:`spectra_tpu.solvers.sym_eigs_shift` (reference:
include/Spectra/SymEigsShiftSolver.h:149-196): the IRLM runs on
``(A - sigma I)^{-1}``, whose extremal eigenvalues ``nu = 1/(lambda -
sigma)`` belong to the eigenvalues of A closest to the shift; Ritz
values are back-transformed ``lambda = 1/nu + sigma`` before the final
sort. The *selection* rule refers to nu (``LargestMagn`` selects the
lambda closest to sigma); ``sorting`` orders the returned lambda.

Example
-------
>>> import spectra_tpu_torch as stt
>>> op = stt.SparseSymShiftSolve.create(A, method="mg").set_shift(0.0)
>>> eigs = stt.SymEigsShiftSolver.from_factored(op, 10, 30, 0.0)
>>> nconv = eigs.compute(stt.SortRule.LargestMagn, tol=1e-10)
"""

from spectra_tpu_torch.solvers.base import HermEigsBase


def _shift_invert_transform(nu, sigma):
    return 1.0 / nu + sigma


class SymEigsShiftSolver(HermEigsBase):
    """Implicitly restarted Lanczos on ``(A - sigma I)^{-1}``. ``op``
    provides ``set_shift(sigma)`` returning the shift-solve operator,
    e.g. :class:`~spectra_tpu_torch.matop.shift_solve.SparseSymShiftSolve`.
    """

    _mode = "lanczos"
    _ritz_transform = staticmethod(_shift_invert_transform)

    def __init__(self, op, nev: int, ncv: int, sigma: float):
        super().__init__(op.set_shift(sigma), nev, ncv)
        self._sigma = float(sigma)

    @classmethod
    def from_factored(cls, shifted_op, nev: int, ncv: int, sigma: float):
        """Build around an operator already built at ``sigma`` (to reuse
        one factorization or hierarchy, or to time the build and the
        iteration apart)."""
        self = cls.__new__(cls)
        HermEigsBase.__init__(self, shifted_op, nev, ncv)
        self._sigma = float(sigma)
        return self

    def _transform_aux(self):
        return self._sigma
