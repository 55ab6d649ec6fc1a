"""The 2-D Dirichlet Laplacian and its analytic eigenpairs (numpy and
scipy only).

``A = kron(I, L1) + kron(L1, I)`` on a g x g grid, ``L1 = tridiag(-1,
2, -1)``. Its eigenvalues are ``mu_i + mu_j`` with ``mu_i = 4
sin^2(i pi / (2 (g + 1)))``, i, j = 1..g, and its eigenvectors
``s_i (x) s_j`` with ``s_i[x] = sqrt(2 / (g + 1)) sin(i pi (x + 1) /
(g + 1))``.
"""

import numpy as np
import scipy.sparse as sps


def matrix(cfg):
    g = int(cfg["grid"])
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    eye = sps.eye(g)
    return (sps.kron(eye, lap1) + sps.kron(lap1, eye)).tocsr()


def _mu(g, dtype):
    i = np.arange(1, g + 1, dtype=dtype)
    return dtype(4) * np.sin(i * dtype(np.pi) / dtype(2 * (g + 1))) ** 2


def _turns(i, x, g, dtype):
    k = (i * x) % (2 * (g + 1))
    return dtype(np.pi) * k.astype(dtype) / dtype(g + 1)


def reference(cfg, nev, which, sigma=0.0, dtype=np.float64, vectors=True):
    """The ``nev`` wanted eigenpairs (``which``: ``"largest"``,
    ``"smallest"`` or ``"nearest"`` sigma), their values and vectors
    computed in ``dtype``. The pairs are chosen by the f64 values, so
    that ``dtype`` changes only the arithmetic."""
    g = int(cfg["grid"])
    mu = _mu(g, np.float64)
    lam = (mu[:, None] + mu[None, :]).ravel()
    if which == "largest":
        key = -lam
    elif which == "smallest":
        key = lam
    elif which == "nearest":
        key = np.abs(lam - sigma)
    else:
        raise ValueError(f"no reference for which={which!r}")
    pick = np.argsort(key, kind="stable")[:nev]
    ii, jj = np.divmod(pick, g)
    m = _mu(g, dtype)
    values = (m[ii] + m[jj]).astype(dtype)
    if not vectors:
        return values, None
    x = np.arange(1, g + 1)
    out = np.empty((g * g, nev), dtype)
    for c, (i, j) in enumerate(zip(ii, jj)):
        # i pi x / (g + 1), reduced modulo 2 pi in integers first, so
        # that dtype rounds only an argument below 2 pi.
        si = np.sin(_turns(i + 1, x, g, dtype))
        sj = np.sin(_turns(j + 1, x, g, dtype))
        si = si / np.linalg.norm(si)
        sj = sj / np.linalg.norm(sj)
        out[:, c] = np.outer(si, sj).ravel()
    return values, out
