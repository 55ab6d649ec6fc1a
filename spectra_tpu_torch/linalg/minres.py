"""MINRES for symmetric (indefinite) systems.

Port of :mod:`spectra_tpu.linalg.minres` (Paige and Saunders 1975): a
three-term Lanczos recurrence with an on-the-fly Givens QR of the
tridiagonal, a monotonically decreasing residual, one matvec per step.
``(A - sigma I)`` is symmetric indefinite whenever sigma sits inside the
spectrum, where CG is invalid.

The JAX ``while_loop`` becomes a host loop: every n-vector stays on the
operator's device, and each step reads the two Lanczos scalars (alpha,
the new beta) to the host in one transfer. The Givens recurrence and the
stopping test run on those host floats (f64; the same IEEE operations
the JAX package runs on device scalars of an f64 system).
"""

import math

import torch

from spectra_tpu_torch.ops.gemv import vec_dot


def minres(matvec, b, rtol=1e-12, maxiter=None):
    """Solve ``A x = b`` (A symmetric, possibly indefinite). Returns
    ``(x, relative_residual_estimate)``, the estimate a Python float.
    Stops when ``|eta| <= rtol * |b|`` or after ``maxiter`` steps."""
    n = b.shape[0]
    if maxiter is None:
        # An inner solve that needs more is a failure to surface (NaN
        # poisoning upstream), not one to grind out.
        maxiter = min(10 * n, 20000)
    beta1 = float(torch.linalg.vector_norm(b))
    safe_beta1 = beta1 if beta1 > 0 else 1.0
    v = b / safe_beta1
    x = torch.zeros_like(b)
    v_old = torch.zeros_like(b)
    w1 = torch.zeros_like(b)
    w0 = torch.zeros_like(b)
    beta, eta = 0.0, beta1
    c1, s1, c0, s0 = 1.0, 0.0, 1.0, 0.0
    tol_abs = rtol * safe_beta1
    it = 0
    while abs(eta) > tol_abs and it < maxiter:
        # Lanczos step
        z = matvec(v) - beta * v_old
        alpha_t = vec_dot(v, z)
        z = z - alpha_t * v
        alpha, beta_new = torch.stack(
            [alpha_t, torch.linalg.vector_norm(z)]
        ).tolist()
        v_new = z / (beta_new if beta_new > 0 else 1.0)

        # Apply the two previous rotations to the new tridiagonal column
        delta = c1 * alpha - c0 * s1 * beta
        rho2 = s1 * alpha + c0 * c1 * beta
        rho3 = s0 * beta
        rho1 = math.sqrt(delta * delta + beta_new * beta_new)
        rho1_safe = rho1 if rho1 > 0 else 1.0
        c_new = delta / rho1_safe
        s_new = beta_new / rho1_safe

        w_new = (v - rho3 * w0 - rho2 * w1) / rho1_safe
        x = x + (c_new * eta) * w_new
        eta = -s_new * eta

        v_old, v = v, v_new
        w0, w1 = w1, w_new
        beta = beta_new
        c0, s0, c1, s1 = c1, s1, c_new, s_new
        it += 1
    return x, abs(eta) / safe_beta1
