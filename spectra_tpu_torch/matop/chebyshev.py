"""Chebyshev polynomial spectral filtering.

Port of :mod:`spectra_tpu.matop.chebyshev`. Iterate on

    p(A) = T_d( (2A - (hi+lo) I) / (hi - lo) )

where ``[lo, hi]`` covers the *unwanted* part of the spectrum: inside
it |T_d| <= 1, outside it grows like cosh(d*acosh(.)), so the wanted
eigenvalues separate exponentially. Eigenvectors are unchanged; the
true eigenvalues come back as Rayleigh quotients with the original
operator. One ``perform_op`` costs ``degree`` SpMVs of the underlying
operator: a host loop of three-term recurrences over device vectors,
each step one product and one update (``ops/cheb_step.py``).

Over a row-sharded operator (one that carries a ``mesh``) the filter
carries the same mesh: vectors are the rank's rows, the recurrence is
local, and the Rayleigh quotients and the Lanczos run of the spectrum
bounds sum over the ranks, so every rank gets the same numbers.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.ops.cheb_step import cheb_step
from spectra_tpu_torch.util.dtypes import numpy_dtype
from spectra_tpu_torch.util.profiling import span


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

    @property
    def mesh(self):
        """The row mesh of a sharded ``op``, else None."""
        return getattr(self.op, "mesh", None)

    def rows(self) -> int:
        return self.op.rows()

    def cols(self) -> int:
        return self.op.cols()

    def perform_op(self, x):
        # T_0 = x, T_1 = L(A) x, T_{k+1} = 2 L(A) T_k - T_{k-1}, with
        # L(A) t = (A t - c t) / h: each step one product and one
        # recurrence update (one kernel launch on the card, cheb_step.py).
        # From T_3 on the update writes over T_{k-1}, never over x.
        c = 0.5 * (self.hi + self.lo)
        h = 0.5 * (self.hi - self.lo)
        with span("cheb.filter"):
            t_prev = x
            t_cur = cheb_step(self.op.perform_op(x), x, None, c, h)
            for k in range(1, self.degree):
                y = self.op.perform_op(t_cur)
                t_next = cheb_step(y, t_cur, t_prev, c, h, overwrite=k > 1)
                t_prev, t_cur = t_cur, t_next
            return t_cur

    def rayleigh_quotients(self, vecs):
        """True eigenvalues of the ORIGINAL operator for (approximately
        invariant) columns of ``vecs``: lambda_i = v_i^H A v_i / v_i^H v_i.
        On a mesh the numerators and denominators are summed over the
        ranks as one (2, k) all-reduce."""
        Av = self.op.perform_op(vecs)
        num = torch.sum(vecs.conj() * Av, dim=0)
        den = torch.sum(vecs.conj() * vecs, dim=0)
        if self.mesh is not None:
            num, den = self.mesh.all_reduce(torch.stack([num, den]))
        return torch.real(num / den)


def estimate_spectrum_bounds(op, steps: int = 30, safety: float = 0.05):
    """Cheap Lanczos-based bounds on the spectrum of a symmetric op.

    Runs ``steps`` Lanczos iterations from the deterministic starting
    vector and returns ``(lo, hi)``: the extreme Ritz values pushed
    outward by ``safety * span`` plus their Kaniel-Paige residual bound.
    Over a row-sharded operator the whole starting vector is cut to the
    rank's rows and the Lanczos run reduces over the mesh.
    """
    from spectra_tpu_torch.linalg import krylov
    from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
    from spectra_tpu_torch.util.rng import SimpleRandom

    with span("cheb.bounds"):
        n = op.rows()
        m = min(steps, n)
        arnop = ArnoldiOp.create(op)
        v0 = torch.from_numpy(SimpleRandom(0).random_vec(n, numpy_dtype(op.dtype)))
        if arnop.mesh is not None:
            v0 = arnop.mesh.local_rows(v0)
        state = krylov.init(arnop, v0.to(op.device), m)
        state = krylov.factorize_from(arnop, state, 1, "lanczos")
        H = state.H.numpy()
        theta, Y = np.linalg.eigh(0.5 * (H + H.T))
        beta = state.beta
        # Per-Ritz-value enclosure: |theta_i - lambda| <= |Y[m-1, i]| * beta
        # (the Kaniel-Paige residual bound), much tighter than +-||f||.
        err_lo = abs(Y[-1, 0]) * beta
        err_hi = abs(Y[-1, -1]) * beta
        width = float(theta[-1] - theta[0]) or 1.0
        lo = float(theta[0]) - err_lo - safety * width
        hi = float(theta[-1]) + err_hi + safety * width
        return lo, hi
