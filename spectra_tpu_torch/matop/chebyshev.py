"""Chebyshev polynomial spectral filtering.

Port of :mod:`spectra_tpu.matop.chebyshev`. Iterate on

    p(A) = T_d( (2A - (hi+lo) I) / (hi - lo) )

where ``[lo, hi]`` covers the *unwanted* part of the spectrum: inside
it |T_d| <= 1, outside it grows like cosh(d*acosh(.)), so the wanted
eigenvalues separate exponentially. Eigenvectors are unchanged; the
true eigenvalues come back as Rayleigh quotients with the original
operator. One ``perform_op`` costs ``degree`` SpMVs of the underlying
operator: a host loop of three-term recurrences over device vectors.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.util.dtypes import numpy_dtype


@dataclasses.dataclass(frozen=True, eq=False)
class ChebyshevFilteredOp:
    """``x -> T_degree(L(A)) x`` with L affine mapping [lo, hi] -> [-1, 1]."""

    op: object
    lo: float
    hi: float
    degree: int

    @classmethod
    def create(cls, op, lo: float, hi: float, degree: int):
        if degree < 1:
            raise ValueError("degree must be >= 1")
        if not hi > lo:
            raise ValueError("need hi > lo")
        return cls(op=op, lo=float(lo), hi=float(hi), degree=int(degree))

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

    def _scaled_matvec(self, x):
        c = 0.5 * (self.hi + self.lo)
        h = 0.5 * (self.hi - self.lo)
        return (self.op.perform_op(x) - c * x) / h

    def perform_op(self, x):
        # T_0 = x, T_1 = L(A) x, T_{k+1} = 2 L(A) T_k - T_{k-1}
        t_prev = x
        t_cur = self._scaled_matvec(x)
        for _ in range(1, self.degree):
            t_prev, t_cur = t_cur, 2.0 * self._scaled_matvec(t_cur) - t_prev
        return t_cur

    def rayleigh_quotients(self, vecs):
        """True eigenvalues of the ORIGINAL operator for (approximately
        invariant) columns of ``vecs``: lambda_i = v_i^H A v_i / v_i^H v_i."""
        Av = self.op.perform_op(vecs)
        num = torch.sum(vecs.conj() * Av, dim=0)
        den = torch.sum(vecs.conj() * vecs, dim=0)
        return torch.real(num / den)


def estimate_spectrum_bounds(op, steps: int = 30, safety: float = 0.05):
    """Cheap Lanczos-based bounds on the spectrum of a symmetric op.

    Runs ``steps`` Lanczos iterations from the deterministic starting
    vector and returns ``(lo, hi)``: the extreme Ritz values pushed
    outward by ``safety * span`` plus their Kaniel-Paige residual bound.
    """
    from spectra_tpu_torch.linalg import krylov
    from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
    from spectra_tpu_torch.util.rng import SimpleRandom

    n = op.rows()
    m = min(steps, n)
    arnop = ArnoldiOp.create(op)
    v0 = SimpleRandom(0).random_vec(n, numpy_dtype(op.dtype))
    state = krylov.init(arnop, torch.from_numpy(v0).to(op.device), m)
    state = krylov.factorize_from(arnop, state, 1, "lanczos")
    H = state.H.numpy()
    theta, Y = np.linalg.eigh(0.5 * (H + H.T))
    beta = state.beta
    # Per-Ritz-value enclosure: |theta_i - lambda| <= |Y[m-1, i]| * beta
    # (the Kaniel-Paige residual bound), much tighter than +-||f||.
    err_lo = abs(Y[-1, 0]) * beta
    err_hi = abs(Y[-1, -1]) * beta
    span = float(theta[-1] - theta[0]) or 1.0
    lo = float(theta[0]) - err_lo - safety * span
    hi = float(theta[-1]) + err_hi + safety * span
    return lo, hi
