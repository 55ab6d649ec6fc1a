"""Krylov-Schur restarting for the general (non-symmetric) solvers.

Port of :mod:`spectra_tpu.solvers._gen_ks`. Stewart's Krylov-Schur
method replaces the implicit shifted-QR restart (reference:
include/Spectra/GenEigsBase.h:44-140) with a direct one:

    1. real Schur form of the m x m Rayleigh matrix  B = U T U^T,
    2. the wanted eigenvalue blocks reordered to the front (LAPACK's
       ordered ``dgees``, or :mod:`spectra_tpu_torch.linalg.schur_reorder`),
    3. truncation  V <- V U[:, :k]  with the residual f UNCHANGED, and
       the Arnoldi expansion resumed from column k.

With exact shifts the two restarts are mathematically equivalent
(Stewart 2001): one host Schur and one basis product per restart
instead of O(ncv - k) sequential QR sweeps. After a restart the
Rayleigh matrix is quasi-triangular in its leading k x k block with a
"spike" row ``beta * (e_m^T U)[:k]`` in row k; the host's dense
``eig``/``schur`` take any matrix.

Where the work runs: as in :mod:`spectra_tpu_torch.solvers._gen_core`,
the factorization and ``truncate_schur`` on the operator's device, the
Schur forms, the reordering and the ARPACK rules on the host. Real
dtypes only.
"""

import numpy as np
import scipy.linalg
import torch

from spectra_tpu_torch.linalg import krylov
from spectra_tpu_torch.linalg.schur_reorder import _block_starts, schur_reorder
from spectra_tpu_torch.solvers._gen_core import _extract, _nev_adjusted, iram_finalize
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.selection import argsort_np, sort_key_np


def _schur_position_eigs(T):
    """Eigenvalue at each diagonal position of a real quasi-triangular T
    (2x2 blocks contribute their conjugate pair in place)."""
    lam = np.zeros(T.shape[0], np.complex128)
    for start, size in _block_starts(T):
        if size == 1:
            lam[start] = T[start, start]
        else:
            lam[start : start + 2] = np.linalg.eigvals(
                T[start : start + 2, start : start + 2]
            )
    return lam


def _ordered_schur(H, ritz_val, k_new: int, ncv: int, selection):
    """``(T, U, k)``: the real Schur form of H with the blocks of the
    ``k_new`` wanted Ritz values first, ``k`` the leading block size.
    Fast path: LAPACK's ``dgees`` orders by a pointwise predicate; the
    Ritz values are sorted by the selection key, so "wanted" is "key
    below the midpoint of ranks k_new-1 and k_new"."""
    key_sorted = sort_key_np(selection, ritz_val)
    lo, hi = float(key_sorted[k_new - 1]), float(key_sorted[k_new])
    if np.isfinite(lo) and np.isfinite(hi) and lo < hi:
        cutoff = 0.5 * (lo + hi)
        try:
            T, U, sdim = scipy.linalg.schur(
                H, output="real",
                sort=lambda wr, wi: bool(sort_key_np(selection, wr + 1j * wi) < cutoff),
            )
            if 1 <= int(sdim) <= ncv - 1:
                return T, U, int(sdim)
        except scipy.linalg.LinAlgError:
            pass
    # Degenerate cutoff (tied keys) or a LAPACK reordering failure:
    # bubble the wanted blocks up with Bai-Demmel swaps.
    T, U = scipy.linalg.schur(H, output="real")
    ind = argsort_np(selection, _schur_position_eigs(T))
    select = np.zeros(ncv, bool)
    select[ind[:k_new]] = True
    T, U, k = schur_reorder(T, U, select)
    if k < 1:
        # Every leading swap was rejected (near-identical spectra): keep
        # the leading block as it is rather than stall.
        k = _block_starts(T)[0][1]
    return T, U, min(k, ncv - 1)


def _lock_prefix(T, b, beta: float, tol: float, eps23: float) -> int:
    """Length of the longest leading prefix of whole Schur blocks whose
    residual ``beta * |b[block]|`` already passes the ARPACK test: their
    spike coupling is zeroed (Stewart's locking), a backward error below
    the convergence threshold, so later expansions cannot perturb them.
    The reference has no locking: its implicit restart re-rotates every
    direction every cycle."""
    lam = _schur_position_eigs(T)
    floor = np.maximum(eps23, np.abs(lam))
    nlock = 0
    for start, size in _block_starts(T):
        if beta * np.abs(b[start : start + size]).max() < tol * floor[start : start + size].min():
            nlock = start + size
        else:
            break
    return nlock


def iram_compute_ks(arnop, v0, seed: int, maxit: int, tol: float,
                    transform_aux=None, *, nev: int, ncv: int, selection,
                    sorting, transform=None):
    """Full Arnoldi iteration with Krylov-Schur restarts (real dtypes),
    with the implicit drivers' ARPACK rules (GenEigsBase.h:225-277)."""
    dtype = arnop.dtype
    if dtype.is_complex:
        raise ValueError(
            "krylov_schur restarting is implemented for real matrices; "
            "use the implicit restart for complex dtypes"
        )
    eps23 = dtypes.eps23(dtype)
    near_0 = dtypes.near_zero(dtype)
    state = krylov.init(arnop, v0, ncv, seed)
    state = krylov.factorize_from(arnop, state, 1, "arnoldi")
    c = _extract(state, tol, 0, nev, selection, dtype)
    while c.nconv < nev and c.restarts < maxit and np.isfinite(c.ritz_val).all():
        k_new = _nev_adjusted(c.nconv, c.ritz_val, c.ritz_est, nev, ncv, dtype)
        H, beta = c.state.H.numpy(), c.state.beta
        T, U, k = _ordered_schur(H, c.ritz_val, k_new, ncv, selection)
        b = U[ncv - 1, :k].copy()
        nlock = _lock_prefix(T[:k, :k], b, beta, tol, eps23)
        b[:nlock] = 0.0
        state = krylov.truncate_schur(
            arnop, c.state, torch.from_numpy(U), torch.from_numpy(T), k
        )
        state = krylov.factorize_from(arnop, state, k, "arnoldi")
        if beta >= near_0:
            # The residual coupling of the truncated basis: row k of the
            # expanded Rayleigh matrix is beta * e_m^T U_k (the spike);
            # factorize_from wrote beta at (k, k-1), so replace the row.
            state.H[k, :k] = torch.from_numpy(beta * b)
        c = _extract(state, tol, c.restarts + 1, nev, selection, dtype)
    return iram_finalize(
        c, transform_aux, nev=nev, sorting=sorting, transform=transform
    )
