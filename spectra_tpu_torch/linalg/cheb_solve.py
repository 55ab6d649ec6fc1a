"""Chebyshev semi-iterative solver for SPD systems.

Port of :mod:`spectra_tpu.linalg.cheb_solve` (Saad, Iterative Methods
for Sparse Linear Systems, alg. 12.1). The dynamic step sizes of CG are
replaced by precomputed scalars from a spectral interval
``[alpha, beta]``: each iteration is one SpMV and two axpys with no
reduction, and the residual norm is read only every ``check_every``
iterations.

Validity: the matrix must be symmetric positive definite with spectrum
in ``(0, beta]``. ``alpha`` need not lower-bound ``lambda_min``: below
it the error polynomial is still < 1, so convergence slows instead of
diverging, and ``alpha`` adapts (see :func:`chebyshev_solve_state`).

The JAX ``while_loop``/``fori_loop`` become host loops: the recurrence
scalars are host floats, n-vectors stay on the operator's device, and
the host reads one norm per window of ``check_every`` iterations.
"""

import math

import numpy as np
import torch


def cheb_coeffs(alpha, beta):
    """Interval scalars ``(theta, delta, sigma1)`` of the classical
    Chebyshev semi-iteration on ``[alpha, beta]``."""
    alpha, beta = float(alpha), float(beta)
    theta = (beta + alpha) / 2.0
    delta = (beta - alpha) / 2.0
    return theta, delta, theta / delta


def cheb_warm_start(matvec, b, x, coeffs):
    """(Re-)enter the semi-iteration from solution estimate ``x``:
    returns the carry ``(x, r, d, rho)`` after the first (Richardson)
    step. Two matvecs; ``x=None`` means a zero start and one matvec."""
    theta, _, sigma1 = coeffs
    if x is None:
        r = b
        d = r / theta
        x1 = d
    else:
        r = b - matvec(x)
        d = r / theta
        x1 = x + d
    r1 = r - matvec(d)
    return x1, r1, d, 1.0 / sigma1


def cheb_iterations(matvec, carry, coeffs, num: int):
    """Run ``num`` two-term-recurrence iterations (one matvec, two axpys,
    no reduction each) from carry ``(x, r, d, rho)``."""
    _, delta, sigma1 = coeffs
    x, r, d, rho = carry
    for _ in range(num):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        x = x + d
        r = r - matvec(d)
        rho = rho_new
    return x, r, d, rho


def chebyshev_solve(matvec, b, alpha, beta, **kwargs):
    """Solve ``A x = b`` for SPD ``A`` with spectrum in ``(0, beta]``;
    returns ``(x, relative_residual)``."""
    x, relres, _ = chebyshev_solve_state(matvec, b, alpha, beta, **kwargs)
    return x, relres


def chebyshev_solve_state(matvec, b, alpha, beta, rtol=1e-12,
                          maxiter: int = 40000, check_every: int = 500):
    """Like :func:`chebyshev_solve`, also returning the final adapted
    ``alpha``, so an operator can learn its interval once at build time.

    The semi-iteration with the JAX package's adaptive ``alpha``
    (``spectra_tpu/linalg/cheb_solve.py:102-235``): when the best
    residual over the last eight windows gained less than one window's
    promised contraction ``((1 - sqrt(a/b)) / (1 + sqrt(a/b)))^check_every``
    (and at least 2 %), ``alpha`` shrinks 4x (not below ``4 eps beta``,
    at most 6 times) with a warm restart and four windows of cooling.
    Stops at ``rtol``, ``maxiter``, or eight windows in a row without a
    2 % gain on the best residual. Returns ``(x, relres, alpha)``."""
    beta = float(beta)
    eps = float(torch.finfo(b.dtype).eps)
    bnorm = float(torch.linalg.vector_norm(b))
    safe_bnorm = bnorm if bnorm > 0 else 1.0

    def warm_start(x, a):
        return cheb_warm_start(matvec, b, x, cheb_coeffs(a, beta))

    a = float(alpha)
    x, r, d, rho = warm_start(None, a)
    it, relres, best = 2, math.inf, math.inf
    hist = [math.inf] * 8
    dry = cool = shrinks = 0
    while relres > rtol and it < maxiter and dry < 8:
        x, r, d, rho = cheb_iterations(
            matvec, (x, r, d, rho), cheb_coeffs(a, beta), check_every
        )
        relres = float(torch.linalg.vector_norm(r)) / safe_bnorm
        new_best = min(best, relres)
        b4 = hist[0]
        alpha_floor = 4.0 * eps * beta
        sq = math.sqrt(a / beta)
        c_pred = ((1.0 - sq) / (1.0 + sq)) ** check_every
        stalled = (
            cool == 0
            and shrinks < 6
            and math.isfinite(b4)
            and new_best > max(c_pred, 0.02) * b4
            and relres > rtol
            and a > 2.0 * alpha_floor
        )
        if stalled:
            a = max(a / 4.0, alpha_floor)
            x, r, d, rho = warm_start(x, a)
            hist = [math.inf] * 8
        else:
            hist = hist[1:] + [new_best]
        it += check_every + (2 if stalled else 0)
        dry = 0 if stalled or relres < 0.98 * best else dry + 1
        cool = 4 if stalled else max(cool - 1, 0)
        shrinks += int(stalled)
        best = new_best
    return x, relres, a


def estimate_spd_interval(shifted_csr, iters: int = 60, safety: float = 0.5):
    """Host-side interval estimate ``(alpha, beta)`` from the scipy CSR:
    ``beta`` is the Gershgorin row-sum bound, ``alpha = safety *
    theta_min`` from an ``iters``-step host Lanczos with full
    re-orthogonalization. Raises ``ValueError`` when the matrix is not
    positive definite. Copied from the JAX package (host numpy)."""
    n = shifted_csr.shape[0]
    beta = float(np.abs(shifted_csr).sum(axis=1).max())
    if beta <= 0:
        raise ValueError("zero matrix has no Chebyshev interval")

    m = min(iters, n)
    rng = np.random.default_rng(7)
    V = np.zeros((n, m), dtype=np.float64)
    a = np.zeros(m)
    bsub = np.zeros(m)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    V[:, 0] = v
    w = shifted_csr @ v
    for j in range(m):
        a[j] = v @ w
        w = w - a[j] * v
        w -= V[:, : j + 1] @ (V[:, : j + 1].T @ w)
        nb = np.linalg.norm(w)
        if j + 1 == m or nb < 1e-12 * beta:
            m = j + 1
            break
        bsub[j] = nb
        v = w / nb
        V[:, j + 1] = v
        w = shifted_csr @ v
    import scipy.linalg as sla

    theta = sla.eigh_tridiagonal(
        a[:m], bsub[: m - 1], eigvals_only=True, select="i",
        select_range=(0, 0),
    )[0]
    if theta <= 0:
        raise ValueError(
            "shifted matrix is not positive definite "
            f"(smallest Ritz value {theta:.3e}); use method='minres'"
        )
    return float(safety * theta), beta
