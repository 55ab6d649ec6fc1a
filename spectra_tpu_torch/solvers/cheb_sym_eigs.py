"""Chebyshev-filtered symmetric eigensolver.

Port of :mod:`spectra_tpu.solvers.cheb_sym_eigs`. Runs the implicitly
restarted Lanczos iteration on the polynomial filter ``p(A)`` (see
:mod:`spectra_tpu_torch.matop.chebyshev`) and recovers the true
eigenvalues as Rayleigh quotients with A. This solves the clustered
extremal-spectrum regime where plain Lanczos needs hundreds of
restarts (the high end of a 2-D grid Laplacian). No reference
counterpart: the filtered-Lanczos/ChASE recipe on the same IRLM engine.
"""

from spectra_tpu_torch.matop.chebyshev import (
    ChebyshevFilteredOp,
    estimate_spectrum_bounds,
)
from spectra_tpu_torch.solvers.base import HermEigsBase
from spectra_tpu_torch.util.selection import SortRule, argsort


class ChebSymEigsSolver(HermEigsBase):
    """k extremal eigenpairs of a symmetric operator via Chebyshev
    filtering.

    Args:
      op: symmetric MatProd operator for A.
      nev, ncv: as in SymEigsSolver.
      which: ``"largest"`` or ``"smallest"``, the end to target.
      degree: filter polynomial degree (SpMVs per filtered operation).
      cut_fraction: the fraction of the spectral span (from the wanted
        end) left OUTSIDE the damped interval; the wanted eigenvalues
        must lie in that window.
      bounds: optional (lo, hi) spectrum enclosure; estimated with a
        short Lanczos run when omitted.
    """

    def __init__(
        self,
        op,
        nev: int,
        ncv: int,
        which: str = "largest",
        degree: int = 20,
        cut_fraction: float = 0.05,
        bounds=None,
    ):
        if which not in ("largest", "smallest"):
            raise ValueError("which must be 'largest' or 'smallest'")
        if bounds is None:
            bounds = estimate_spectrum_bounds(op, safety=0.0)
        lo_all, hi_all = map(float, bounds)
        span = hi_all - lo_all
        # The damped interval must safely cover the whole unwanted side
        # (over-cover by 5% there) while the cut stays strictly inside
        # the spectrum on the wanted side.
        if which == "largest":
            filt_lo = lo_all - 0.05 * span
            filt_hi = hi_all - cut_fraction * span
        else:
            filt_lo = lo_all + cut_fraction * span
            filt_hi = hi_all + 0.05 * span
        self._filtered = ChebyshevFilteredOp.create(op, filt_lo, filt_hi, degree)
        self._base_op = op
        self._which = which
        super().__init__(self._filtered, nev, ncv)

    def compute(
        self,
        selection: SortRule = SortRule.LargestMagn,
        maxit: int = 200,
        tol: float = 1e-10,
        sorting: SortRule = SortRule.LargestAlge,
    ) -> int:
        """Run the filtered iteration.

        ``selection`` is accepted for driver-API compatibility but has
        no effect: ``which`` fixes the target end at construction, and
        the filter maps it onto the largest-magnitude eigenvalues of
        p(A). ``sorting`` orders the returned (Rayleigh-quotient)
        eigenvalues.
        """
        del selection
        nconv = super().compute(SortRule.LargestMagn, maxit, tol, SortRule.LargestMagn)
        self._recover_eigenvalues(sorting)
        return nconv

    def _recover_eigenvalues(self, sorting: SortRule):
        res = self._result
        if res is None:
            return
        vecs = res.V.mT @ res.vectors_small.to(res.V.device, res.V.dtype)
        lam = self._filtered.rayleigh_quotients(vecs).cpu().double()
        ind = argsort(sorting, lam)
        self._result = res._replace(
            values=lam[ind],
            vectors_small=res.vectors_small[:, ind],
            conv=res.conv[ind],
        )
