"""Krylov factorization, the small tridiagonal kernels of the IRLM and
the Hessenberg ones of the IRAM (``hessenberg``, ``hessenberg_eigen``,
``schur``, ``schur_reorder``); the inner solvers of shift-invert are the
modules ``minres``, ``cheb_solve`` and ``multigrid``."""

from spectra_tpu_torch.linalg.givens import givens_rotation, givens_rotation_complex
from spectra_tpu_torch.linalg.hessenberg import double_shift_qr, hessenberg_qr
from spectra_tpu_torch.linalg.tridiag import (
    apply_yq,
    tridiag_eigen,
    tridiag_qr,
    tridiag_qtq,
)

__all__ = [
    "givens_rotation",
    "givens_rotation_complex",
    "hessenberg_qr",
    "double_shift_qr",
    "tridiag_qr",
    "tridiag_qtq",
    "apply_yq",
    "tridiag_eigen",
]
