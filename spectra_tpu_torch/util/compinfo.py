"""Computation status codes.

Port of :mod:`spectra_tpu.util.compinfo` (reference:
include/Spectra/Util/CompInfo.h:17-32).
"""

import enum


class CompInfo(enum.Enum):
    """Status of an eigensolver computation."""

    Successful = 0
    """Computation was successful."""

    NotComputed = 1
    """Computation has not been conducted: call ``init()``/``compute()``."""

    NotConverging = 2
    """Some eigenvalues did not converge; `maxit` may be too small."""

    NumericalIssue = 3
    """Internal factorization failed (e.g. matrix not positive definite)."""
