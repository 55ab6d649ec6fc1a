"""Config #5b's diagonally dominant banded matrix and its wanted
eigenpairs (numpy and scipy only).

``A = diags([off2, off1, d, off1, off2], offsets)`` with ``d =
linspace(diag_lo, diag_hi, n)**2``. The diagonal grows with the index
and the couplings are small beside its spread, so the largest
eigenvectors live at the end: the reference takes them from a dense
eigh of the trailing ``reference_block`` rows and columns, and checks
that the truncation is below a relative 1e-12 (each pair's residual
against the whole matrix, r, moves its eigenvalue by at most r^2 / gap,
gap being the distance to the next eigenvalue of the block).
"""

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sps


def matrix(cfg):
    n = int(cfg["n"])
    d = np.linspace(float(cfg["diag_lo"]), float(cfg["diag_hi"]), n) ** 2
    off1, off2 = np.full(n, float(cfg["off1"])), np.full(n, float(cfg["off2"]))
    return sps.diags([off2, off1, d, off1, off2], list(cfg["offsets"]),
                     shape=(n, n), format="csr")


def reference(cfg, nev, which, sigma=0.0, dtype=np.float64, vectors=True):
    """The ``nev`` largest eigenpairs, computed in ``dtype``."""
    if which != "largest":
        raise ValueError(f"no reference for which={which!r}")
    A = matrix(cfg)
    n = A.shape[0]
    m = min(n, int(cfg["reference_block"]))
    block = A[n - m:, n - m:].toarray().astype(dtype)
    first = max(0, m - nev - 1)
    w, v = sla.eigh(block, subset_by_index=[first, m - 1])
    w, v = w[::-1], v[:, ::-1]  # largest first
    if dtype == np.float64 and m < n:
        full = np.zeros((n, nev))
        full[n - m:] = v[:, :nev]
        r = np.linalg.norm(A @ full - full * w[:nev], axis=0)
        gap = np.abs(np.diff(w)).min() if len(w) > 1 else np.inf
        norm = abs(A).sum(axis=1).max()
        if (r ** 2 / gap).max() > 1e-12 * norm:
            raise RuntimeError("reference_block is too small for this matrix")
    values = w[:nev].astype(dtype)
    if not vectors:
        return values, None
    out = np.zeros((n, nev), dtype)
    out[n - m:] = v[:, :nev]
    return values, out
