"""Eigenvalue reordering of a real Schur form, on the host.

Port of :mod:`spectra_tpu.linalg.schur_reorder` (numpy in both
packages; the port keeps its own copy): the LAPACK dtrexc/dtrsen
capability. Selected eigenvalues (1x1 blocks and 2x2 complex-pair
blocks) move to the leading position of a real quasi-triangular T by
adjacent block swaps, the orthogonal U updated so that ``A = U T U^T``
holds.

Each adjacent swap is the Bai-Demmel direct swap: for the window
``[[A11, A12], [0, A22]]`` (p, q <= 2) solve the tiny Sylvester
equation ``A11 X - X A22 = gamma A12`` (a pq <= 4 Kronecker system);
the QR of ``[[-X], [gamma I]]`` gives the orthogonal W with
``W^T [[A11, A12], [0, A22]] W = [[~A22, *], [0, ~A11]]``.
Ill-conditioned swaps (nearly equal spectra) are rejected, as in
LAPACK. The Krylov-Schur restart of the general solvers
(:mod:`spectra_tpu_torch.solvers._gen_ks`) uses it when LAPACK's own
ordering cannot be asked for.
"""

import numpy as np


def _block_starts(T):
    """Partition a quasi-triangular T into 1x1/2x2 diagonal blocks.

    Returns a list of (start, size). Subdiagonal entries below a
    threshold are treated as zero.
    """
    m = T.shape[0]
    eps = np.finfo(T.dtype).eps
    blocks = []
    i = 0
    while i < m:
        if i + 1 < m and abs(T[i + 1, i]) > eps * (
            abs(T[i, i]) + abs(T[i + 1, i + 1])
        ):
            blocks.append((i, 2))
            i += 2
        else:
            blocks.append((i, 1))
            i += 1
    return blocks


def _swap_adjacent(T, U, i, p, q):
    """Swap the adjacent blocks at (i, p) and (i+p, q) in place.

    Returns True on success, False if the swap was rejected (nearly
    singular Sylvester system / post-swap residual too large — the
    nearly-equal-spectra case LAPACK's dtrexc also rejects).

    Hot path of every Krylov-Schur restart (~15 swaps per restart):
    the <= 4x4 Kronecker system is assembled by broadcasting and the
    orthogonal factor built from 1-2 Householder reflectors directly —
    no np.kron / np.linalg.qr call overhead.
    """
    j = i + p
    A11 = T[i:j, i:j]
    A12 = T[i:j, j : j + q]
    A22 = T[j : j + q, j : j + q]

    # Solve A11 X - X A22 = gamma A12 via the Kronecker form
    # (I_q (x) A11 - A22^T (x) I_p) vec(X) = gamma vec(A12),
    # column-major vec. kron(I,A)/kron(A,I) assembled by broadcasting.
    pq = p * q
    Ip = np.eye(p)
    Iq = np.eye(q)
    K = (Iq[:, None, :, None] * A11[None, :, None, :]).reshape(pq, pq) - (
        A22.T[:, None, :, None] * Ip[None, :, None, :]
    ).reshape(pq, pq)
    rhs = A12.flatten(order="F")
    scale = max(np.abs(rhs).max(), 1.0)
    gamma = 1.0
    try:
        x = np.linalg.solve(K, rhs)
    except np.linalg.LinAlgError:
        return False
    xmax = np.abs(x).max() if x.size else 0.0
    if not np.isfinite(xmax):
        return False
    # Rescale if the solution is huge (overflow guard, LAPACK-style).
    if xmax > 1e8 * scale:
        gamma = 1e8 * scale / xmax
        x = x * gamma
    X = x.reshape((p, q), order="F")

    # Orthonormal basis of [[-X], [gamma I_q]]'s column space, completed
    # to (p+q, p+q): q Householder reflectors applied to I.
    M = np.vstack([-X, gamma * Iq])
    W = np.eye(p + q)
    for c in range(q):
        v = M[c:, c].copy()
        alpha = np.sqrt(v @ v)
        if alpha == 0.0:
            continue
        if v[0] >= 0:
            alpha = -alpha
        v[0] -= alpha
        vnorm2 = v @ v
        if vnorm2 == 0.0:
            continue
        M[c:, c:] -= np.outer(v, (2.0 / vnorm2) * (v @ M[c:, c:]))
        W[:, c:] -= np.outer(W[:, c:] @ v, (2.0 / vnorm2) * v)

    w = p + q
    win = slice(i, i + w)
    Twin = W.T @ T[win, win] @ W
    # Quality check: the would-be-zero block must be negligible.
    resid = np.abs(Twin[q:, :q]).max()
    tnorm = max(np.abs(T[win, win]).max(), 1.0)
    if resid > 50 * np.finfo(T.dtype).eps * tnorm:
        return False

    T[win, win] = Twin
    T[i + q : i + w, i : i + q] = 0.0
    T[win, i + w :] = W.T @ T[win, i + w :]
    T[:i, win] = T[:i, win] @ W
    U[:, win] = U[:, win] @ W
    return True


def schur_reorder(T, U, select):
    """Reorder the real Schur pair so that the eigenvalues of the
    blocks flagged by ``select`` come first.

    Args:
      T: (m, m) real quasi-triangular (modified in place on a copy).
      U: (m, m) orthogonal (same).
      select: boolean array of length m — a 2x2 block is selected when
        either of its positions is flagged.

    Returns:
      (T_new, U_new, k): reordered pair and the dimension k of the
      leading invariant subspace holding the selected eigenvalues
      (block-aligned; failed swaps may leave stragglers, reflected in
      a smaller k).
    """
    T = np.array(T, copy=True)
    U = np.array(U, copy=True)
    select = np.array(select, dtype=bool, copy=True)

    top = 0  # next insertion position
    while True:
        blocks = _block_starts(T)
        # First selected block at or after `top`.
        cand = None
        for start, size in blocks:
            if start < top:
                continue
            if select[start : start + size].any():
                cand = (start, size)
                break
        if cand is None:
            break
        start, size = cand
        if start == top:
            top += size
            continue
        # Bubble it upward one neighbor at a time.
        moved = True
        while start > top and moved:
            prev = None
            for b in _block_starts(T):
                if b[0] + b[1] == start:
                    prev = b
                    break
            if prev is None:
                moved = False
                break
            ok = _swap_adjacent(T, U, prev[0], prev[1], size)
            if not ok:
                moved = False
                break
            # The selected block now starts where `prev` started; the
            # select flags travel with the eigenvalues.
            sel_block = select[start : start + size].copy()
            select[prev[0] + size : prev[0] + size + prev[1]] = select[
                prev[0] : prev[0] + prev[1]
            ].copy()
            select[prev[0] : prev[0] + size] = sel_block
            start = prev[0]
        if not moved:
            # Could not bring this block up; stop to avoid livelock.
            break
        top += size
    return T, U, top
