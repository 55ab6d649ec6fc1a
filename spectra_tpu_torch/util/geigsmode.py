"""Spectral-transform modes for generalized eigensolvers.

Port of :mod:`spectra_tpu.util.geigsmode` (reference:
include/Spectra/Util/GEigsMode.h:18-25).
"""

import enum


class GEigsMode(enum.Enum):
    """Mode of a generalized eigen solver for ``A x = lambda B x``."""

    Cholesky = 0
    """Using Cholesky decomposition ``B = L L^H``."""

    RegularInverse = 1
    """Regular inverse mode: only ``B v`` and ``B^{-1} v`` are required."""

    ShiftInvert = 2
    """Shift-and-invert mode ``nu = 1 / (lambda - sigma)``."""

    Buckling = 3
    """Buckling mode ``nu = lambda / (lambda - sigma)`` (K spd)."""

    Cayley = 4
    """Cayley transformation ``nu = (lambda + sigma) / (lambda - sigma)``."""
