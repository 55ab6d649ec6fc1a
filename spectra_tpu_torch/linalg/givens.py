"""Numerically stable Givens rotations on host scalars.

Port of :mod:`spectra_tpu.linalg.givens` (reference:
include/Spectra/LinAlg/Givens.h:150-336). For a real pair (x, y), find
(c, s, r) with

    G = [ c  s ]      G^T [x]   [r]
        [-s  c ],         [y] = [0],   r = sqrt(x^2 + y^2) >= 0,

i.e. c = x / r, s = -y / r. The complex variant follows the LAPACK
(LAWN-150) convention of the reference (Givens.h:218-335): c real, s
complex, ``G^H [x, y]^T = [r, 0]^T``. The rotations drive the
replicated small (ncv, ncv) problem, which the port runs on the host in
Python scalars.
"""

import math


def _hypot(x: float, y: float) -> float:
    """``sqrt(x^2 + y^2)`` without overflow, by the same formula as
    ``jnp.hypot``: ``a * sqrt(1 + (b/a)^2)`` with a = max(|x|, |y|)."""
    a, b = abs(x), abs(y)
    if math.isinf(a) or math.isinf(b):
        return math.inf
    a, b = max(a, b), min(a, b)
    if a == 0.0:
        return 0.0
    r = b / a
    return a * math.sqrt(1.0 + r * r)


def givens_rotation(x: float, y: float):
    """Real Givens rotation zeroing ``y`` against ``x``.

    Returns ``(c, s, r)`` with ``c*x - s*y = r`` and ``s*x + c*y = 0``.
    For x = y = 0 returns the identity rotation (c=1, s=0, r=0).
    """
    r = _hypot(x, y)
    if r > 0.0:
        return x / r, -y / r, r
    return 1.0, 0.0, r


def givens_rotation_complex(x: complex, y: complex):
    """Complex Givens rotation (LAPACK clartg convention): ``c`` real,
    ``s`` complex, ``c = |x| / n``, ``s = -(x/|x|) conj(y) / n`` and
    ``r = (x/|x|) n`` with ``n = sqrt(|x|^2 + |y|^2)``. For x == 0 the
    rotation swaps: c = 0, s = -conj(y)/|y|, r = |y|. For x = y = 0 it
    is the identity (c=1, s=0, r=0)."""
    x, y = complex(x), complex(y)
    ax, ay = abs(x), abs(y)
    n = _hypot(ax, ay)
    if not n > 0.0:
        return 1.0, 0j, 0j
    if ax == 0.0:
        return 0.0, -y.conjugate() / (ay if ay != 0.0 else 1.0), complex(ay)
    phase = x / ax
    return ax / n, -phase * y.conjugate() / n, phase * n
