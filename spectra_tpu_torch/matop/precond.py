"""Preconditioning for the iterative shift-solve.

Port of :mod:`spectra_tpu.matop.precond`. Both preconditioners are
operator transformations, so the (indefinite-safe) MINRES iteration
itself stays untouched:

* **Jacobi** (symmetric diagonal scaling): solve ``(S A S) y = S b``
  with ``S = |diag(A)|^{-1/2}``, then ``x = S y``.
* **Chebyshev polynomial**: solve ``(A p(A)) y = b``, then
  ``x = p(A) y``, where ``p`` is the degree-d Chebyshev approximation of
  ``1/lambda`` on ``[alpha, beta]``. Valid for (semi-)definite systems,
  e.g. sigma = 0 for an SPD operator; the interval defaults to
  ``beta`` = the Gershgorin bound and ``alpha = beta * 1e-4``.
"""

from functools import partial

import torch


def gershgorin_upper(sp) -> float:
    """Upper bound on the spectral radius from the row sums of |A|, as a
    Python float (ELL ``vals`` are row-major; DIA ``data`` is
    row-aligned, so a row's sum runs over the diagonals). A
    :class:`~spectra_tpu_torch.sparse.formats.DiaHiLoMatrix` sums its
    planes one diagonal at a time."""
    if hasattr(sp, "vals"):
        return float(sp.vals.abs().sum(dim=1).max())
    if hasattr(sp, "row_abs_sums"):
        return float(sp.row_abs_sums().max())
    return float(sp.data.abs().sum(dim=0).max())


def chebyshev_inverse_apply(matvec, b, alpha, beta, degree: int):
    """z = p(A) b, the degree-``degree`` Chebyshev semi-iteration
    approximation of ``A^{-1} b`` on [alpha, beta] from z0 = 0 (Saad,
    Iterative Methods, alg. 12.1); the recurrence is shared with
    :mod:`spectra_tpu_torch.linalg.cheb_solve`."""
    from spectra_tpu_torch.linalg.cheb_solve import (
        cheb_coeffs,
        cheb_iterations,
        cheb_warm_start,
    )

    coeffs = cheb_coeffs(alpha, beta)
    carry = cheb_warm_start(matvec, b, None, coeffs)
    z, _, _, _ = cheb_iterations(matvec, carry, coeffs, degree - 1)
    return z


def jacobi_scaling(diag):
    """S = |diag|^{-1/2} with a zero-diagonal guard."""
    d = diag.abs()
    return torch.where(d > 0, 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0)), 1.0)


def preconditioned_system(matvec, b, precond: str, diag=None, alpha=None,
                          beta=None, degree: int = 16):
    """Transform ``A x = b`` per the chosen preconditioner. Returns
    ``(mv2, b2, recover)``: solve ``mv2(y) = b2`` with a symmetric
    Krylov method, then ``x = recover(y)``."""
    if precond == "jacobi":
        s = jacobi_scaling(diag)

        def mv2(u):
            return s * matvec(s * u)

        return mv2, s * b, lambda y: s * y
    if precond == "cheb":
        p = partial(
            chebyshev_inverse_apply, matvec, alpha=alpha, beta=beta,
            degree=degree,
        )

        def mv2(u):
            return matvec(p(u))

        return mv2, b, p
    return matvec, b, lambda y: y
