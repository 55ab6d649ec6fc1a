"""Krylov factorization and the small tridiagonal kernels of the IRLM;
the inner solvers of shift-invert are the modules ``minres``,
``cheb_solve`` and ``multigrid``."""

from spectra_tpu_torch.linalg.givens import givens_rotation
from spectra_tpu_torch.linalg.tridiag import (
    apply_yq,
    tridiag_eigen,
    tridiag_qr,
    tridiag_qtq,
)

__all__ = [
    "givens_rotation",
    "tridiag_qr",
    "tridiag_qtq",
    "apply_yq",
    "tridiag_eigen",
]
