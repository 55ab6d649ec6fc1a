"""Numerically stable real Givens rotations on host scalars.

Port of :func:`spectra_tpu.linalg.givens.givens_rotation` (reference:
include/Spectra/LinAlg/Givens.h:150-336). For a real pair (x, y), find
(c, s, r) with

    G = [ c  s ]      G^T [x]   [r]
        [-s  c ],         [y] = [0],   r = sqrt(x^2 + y^2) >= 0,

i.e. c = x / r, s = -y / r. The rotations drive the replicated small
(ncv, ncv) problem, which the port runs on the host in Python floats.
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
