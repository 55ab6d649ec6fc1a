"""B-operations for the generalized problem's RegularInverse mode.

Port of :mod:`spectra_tpu.matop.regular_inverse` (reference:
include/Spectra/MatOp/SparseRegularInverse.h:37-135): ``perform_op(x)
= B x`` (the Lanczos metric) and ``solve(x) = B^{-1} x`` by conjugate
gradients on the device, with no factorization of B.
"""

import dataclasses

import numpy as np

from spectra_tpu_torch.matop.sparse import SparseSymMatProd
from spectra_tpu_torch.util import dtypes


@dataclasses.dataclass(frozen=True, eq=False)
class SparseRegularInverse:
    """B x and CG-based B^{-1} x for sparse SPD B. ``op_norm`` is B's
    Gershgorin bound, computed once."""

    ell: object  # the device matrix (DIA or ELL) of B
    cg_maxiter: int
    op_norm: float

    @classmethod
    def create(cls, mat, uplo: str = "L", cg_maxiter: int | None = None,
               device=None):
        from spectra_tpu_torch.matop.precond import gershgorin_upper

        prod = SparseSymMatProd.create(mat, uplo=uplo, device=device)
        return cls(
            ell=prod.ell, cg_maxiter=cg_maxiter or 2 * prod.rows(),
            op_norm=gershgorin_upper(prod.ell),
        )

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def device(self):
        return self.ell.device

    def rows(self) -> int:
        return self.ell.n_rows

    def cols(self) -> int:
        return self.ell.n_cols

    def perform_op(self, x):
        """y = B x."""
        if x.ndim == 1:
            return self.ell.matvec(x)
        return self.ell.matmat(x)

    def solve(self, x):
        """y = B^{-1} x by conjugate gradients (relative tolerance
        ``sqrt(eps) 1e-3``); a solve whose backward error exceeds 1e-8
        is poisoned to NaN, so the driver reports ``NumericalIssue``
        (the reference throws on CG failure,
        SparseRegularInverse.h:105-116)."""
        from spectra_tpu_torch.matop.shift_solve import _poison_if_unconverged, cg

        y = cg(
            self.ell.matvec, x, tol=np.sqrt(dtypes.eps(self.ell.dtype)) * 1e-3,
            maxiter=self.cg_maxiter,
        )
        return _poison_if_unconverged(
            self.ell.matvec, y, x, self.op_norm, accept_bw=1e-8
        )
