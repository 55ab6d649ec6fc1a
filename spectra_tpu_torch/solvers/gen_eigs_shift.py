"""Shift-and-invert solvers for general (non-symmetric) matrices.

Port of :mod:`spectra_tpu.solvers.gen_eigs_shift` (reference:
include/Spectra/GenEigsRealShiftSolver.h:33-83 and
GenEigsComplexShiftSolver.h:33-157).

The real-shift solver back-transforms ``lambda = 1/nu + sigma``
(reference: :49-55). The complex-shift solver runs the IRAM on the
real operator ``Re[(A - sigma I)^{-1}]``, whose Ritz values are
``nu = (1/(lambda-sigma) + 1/(lambda-conj(sigma)))/2``: recovering
lambda solves a quadratic with two roots and tests both against one
more solve with a random real shift, the reference's procedure
(GenEigsComplexShiftSolver.h:55-128), after the iteration, with the
same ``SimpleRandom(0)`` shift. Its solves run on the operator's
device.
"""

import numpy as np
import torch

from spectra_tpu_torch.solvers.gen_base import GenEigsBase
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.rng import SimpleRandom
from spectra_tpu_torch.util.selection import SortRule, argsort_np


def _real_shift_transform(nu, sigma, ritz_vec, state):
    return 1.0 / nu + sigma


class GenEigsRealShiftSolver(GenEigsBase):
    """IRAM on ``(A - sigma I)^{-1}`` for general matrices, real shift.

    ``op`` provides ``set_shift(sigma)``: e.g.
    :class:`~spectra_tpu_torch.matop.shift_solve.DenseGenRealShiftSolve`
    or :class:`~spectra_tpu_torch.matop.shift_solve.SparseGenRealShiftSolve`.
    """

    _ritz_transform = staticmethod(_real_shift_transform)

    def __init__(self, op, nev: int, ncv: int, sigma: float):
        super().__init__(op.set_shift(sigma), nev, ncv)
        self._sigma = float(sigma)

    def _transform_aux(self):
        return self._sigma


class GenEigsComplexShiftSolver(GenEigsBase):
    """IRAM with a complex shift ``sigma_r + sigma_i i`` on a real matrix.

    ``op`` provides ``set_shift(sigmar, sigmai)`` and computes
    ``Re[(A - sigma I)^{-1} v]``: e.g.
    :class:`~spectra_tpu_torch.matop.shift_solve.DenseGenComplexShiftSolve`.
    """

    def __init__(self, op, nev: int, ncv: int, sigmar: float, sigmai: float):
        super().__init__(op.set_shift(sigmar, sigmai), nev, ncv)
        self._unshifted_op = op
        self._sigmar = float(sigmar)
        self._sigmai = float(sigmai)

    def compute(
        self,
        selection: SortRule = SortRule.LargestMagn,
        maxit: int = 1000,
        tol: float = 1e-10,
        sorting: SortRule = SortRule.LargestMagn,
    ) -> int:
        nconv = super().compute(selection, maxit, tol, sorting=selection)
        self._back_transform(sorting)
        return nconv

    def _back_transform(self, sorting: SortRule):
        """Reference: GenEigsComplexShiftSolver.h:55-128."""
        res = self._result
        if res is None:
            return
        eps = dtypes.eps(self._dtype)
        # The random real probe shift, the reference's stream.
        rng = SimpleRandom(0)
        shiftr = rng.random() * self._sigmar + rng.random()
        probe_op = self._unshifted_op.set_shift(float(shiftr), 0.0)

        V = res.V
        vals = np.array(res.values, dtype=np.complex128)
        vecs = np.array(res.vectors_small, dtype=np.complex128)
        i = 0
        while i < self._nev:
            y = torch.from_numpy(vecs[:, i])
            v_real = y.real.to(V.device, V.dtype) @ V
            v_imag = y.imag.to(V.device, V.dtype) @ V
            v = torch.complex(v_real, v_imag)
            opv = torch.complex(probe_op.perform_op(v_real), probe_op.perform_op(v_imag))

            nu = vals[i]
            part1 = self._sigmar + 0.5 / nu
            part2 = 0.5 * np.sqrt(1.0 - 4.0 * self._sigmai**2 * nu * nu) / nu
            root1, root2 = part1 + part2, part1 - part2
            err1 = torch.sum(torch.abs(opv - v / complex(root1 - shiftr)) ** 2)
            err2 = torch.sum(torch.abs(opv - v / complex(root2 - shiftr)) ** 2)
            lam = root1 if bool(err1 < err2) else root2

            if abs(lam.imag) > eps and i + 1 < self._nev:
                vals[i] = lam
                vals[i + 1] = np.conj(lam)
                i += 2
            else:
                vals[i] = complex(lam.real, 0.0) if abs(lam.imag) <= eps else lam
                i += 1

        ind = argsort_np(sorting, vals)
        self._result = res._replace(
            values=vals[ind], vectors_small=vecs[:, ind], conv=res.conv[ind]
        )
