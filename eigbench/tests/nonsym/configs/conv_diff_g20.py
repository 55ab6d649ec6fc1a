"""The 2-D upwind convection-diffusion operator, its wanted eigenpairs
by a dense ``eig``, and the comparison of a non-symmetric problem's
complex eigenpairs (numpy and scipy only).

``A = kron(I, L1) + kron(L1, I) + c kron(I, U1)`` on a g x g grid,
``L1 = tridiag(-1, 2, -1)``, ``U1`` the upwind difference
``bidiag(-1, 1)``. A is not normal: its eigenvectors are not
orthogonal, so the comparison holds each pair by its own residual.
"""

import math

import numpy as np
import scipy.optimize as sopt
import scipy.sparse as sps

#: The names of the numbers :func:`compare` returns.
NUMBERS = ("value_err", "residual", "missing_pairs", "not_successful")


def matrix(cfg):
    g = int(cfg["grid"])
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
    eye = sps.eye(g)
    return (sps.kron(eye, lap1) + sps.kron(lap1, eye)
            + float(cfg["c"]) * sps.kron(eye, upw1)).tocsr()


def reference(cfg, nev, which, sigma=0.0, dtype=np.float64, vectors=True):
    """The ``nev`` eigenpairs of largest magnitude, computed in
    ``dtype`` (complex values, unit vectors)."""
    if which != "largest_magn":
        raise ValueError(f"no reference for which={which!r}")
    A = matrix(cfg).toarray().astype(dtype)
    w, v = np.linalg.eig(A)
    pick = np.argsort(-np.abs(w), kind="stable")[:nev]
    return w[pick], (v[:, pick] if vectors else None)


def _finite(x):
    x = float(x)
    return x if math.isfinite(x) else None


def compare(operands, ref_values, values, vectors, nconv, successful, sigma=0.0):
    """The numbers of one answer: each returned value matched to a
    reference value (the assignment of least total distance), then

    * ``value_err``: the largest ``|lambda - lambda_ref| / |lambda_ref|``;
    * ``residual``: the largest ``||A u - lambda u|| / (|lambda| ||u||)``;
    * ``missing_pairs``: ``nev`` less the pairs returned;
    * ``not_successful``: 1 where the solver did not report success.

    A number that is not finite, or one of a missing pair, reads None."""
    A = operands["A"]
    nev = len(ref_values)
    values = np.asarray(values, np.complex128)
    U = np.asarray(vectors, np.complex128)
    k = len(values)
    out = dict(missing_pairs=max(0, nev - min(int(nconv), k)),
               not_successful=0 if successful else 1)
    if k != nev or U.shape != (A.shape[0], nev):
        out.update(value_err=None, residual=None)
        return out
    ref = np.asarray(ref_values, np.complex128)
    dist = np.abs(values[:, None] - ref[None, :])
    if not np.isfinite(dist).all():
        out.update(value_err=None, residual=None)
        return out
    rows, cols = sopt.linear_sum_assignment(dist)
    scale = np.maximum(np.abs(ref[cols]), np.finfo(np.float64).tiny)
    out["value_err"] = _finite((dist[rows, cols] / scale).max())
    R = A @ U - U * values[None, :]
    norms = np.linalg.norm(U, axis=0) * np.maximum(np.abs(values), np.finfo(np.float64).tiny)
    out["residual"] = _finite((np.linalg.norm(R, axis=0) / norms).max())
    return out
