"""Schur decompositions of a small upper Hessenberg matrix, on the host.

Port of :mod:`spectra_tpu.linalg.schur` (reference:
include/Spectra/LinAlg/UpperHessenbergSchur.h:30-456, an Eigen
RealSchur adaptation, and UpperHessenbergEigen.h:53-454). The JAX
package has these because the TPU has no LAPACK; the port keeps them,
in numpy, for parity: the ``native`` backend of
:func:`~spectra_tpu_torch.linalg.hessenberg_eigen.hessenberg_eigen`
uses them, and no path calls them by default.

* :func:`hessenberg_schur`: Francis double-shift sweeps
  (:func:`~spectra_tpu_torch.linalg.hessenberg.double_shift_qr`, which
  re-seeds at every deflated boundary, so one sweep advances every
  active block) with Wilkinson shifts from the trailing unconverged 2x2
  block, exceptional shifts after 10 stalled iterations, at most 30 m
  iterations, until T is quasi-triangular; ``H = U T U^T``.
* :func:`hessenberg_schur_complex`: single-shift complex sweeps for
  complex H; ``H = U T U^H`` with T upper triangular.
* :func:`complexify_schur`, :func:`triangular_eigenvectors`,
  :func:`hessenberg_eigen_native` and :func:`schur_eigenvalues`: the
  eigenpairs from the Schur forms.
"""

from typing import NamedTuple

import numpy as np

from spectra_tpu_torch.linalg.hessenberg import (
    clip_to_hessenberg,
    double_shift_qr,
    hessenberg_qr,
)


class SchurResult(NamedTuple):
    T: np.ndarray  # (m, m) quasi-triangular (real) or triangular (complex)
    U: np.ndarray  # (m, m) orthogonal / unitary, H = U T U^H
    converged: bool
    n_iter: int


def _deflate(T):
    """Zero negligible subdiagonals (Eigen/LAPACK criterion), in place."""
    eps = np.finfo(T.real.dtype).eps
    d = np.diagonal(T)
    i = np.arange(T.shape[0] - 1)
    sub = T[i + 1, i]
    small = np.abs(sub) <= eps * (np.abs(d[:-1]) + np.abs(d[1:]))
    T[i + 1, i] = np.where(small, 0.0, sub)
    return T


def _unconverged_mask(T):
    """Per subdiagonal: True where more iteration is needed. A nonzero
    subdiagonal is converged iff it is an isolated 2x2 block (neighbours
    zero) whose eigenvalues are complex (discriminant < 0)."""
    sub = np.diagonal(T, offset=-1)
    nz = sub != 0
    nz_prev = np.concatenate([[False], nz[:-1]])
    nz_next = np.concatenate([nz[1:], [False]])
    a, dd = np.diagonal(T)[:-1], np.diagonal(T)[1:]
    b = np.diagonal(T, offset=1)
    disc = (a - dd) ** 2 + 4.0 * b * sub
    return nz & ~(~nz_prev & ~nz_next & (disc < 0))


def _rotate_real(T, U, j, cr, sr):
    """Apply the plane rotation (cr, sr) to rows and columns j, j+1 of T
    and to columns j, j+1 of U, in place."""
    rj = cr * T[j, :] + sr * T[j + 1, :]
    T[j + 1, :] = -sr * T[j, :] + cr * T[j + 1, :]
    T[j, :] = rj
    cj = cr * T[:, j] + sr * T[:, j + 1]
    T[:, j + 1] = -sr * T[:, j] + cr * T[:, j + 1]
    T[:, j] = cj
    uj = cr * U[:, j] + sr * U[:, j + 1]
    U[:, j + 1] = -sr * U[:, j] + cr * U[:, j + 1]
    U[:, j] = uj


def _split_real_blocks(T, U):
    """Split isolated 2x2 blocks with real eigenvalues by a direct
    rotation (LAPACK dlanv2's standardization): Francis cannot move
    them, since the block's own shifted first column is exactly zero."""
    m = T.shape[0]
    for j in range(m - 1):
        sub = T[j + 1, j]
        prev_zero = T[j, j - 1] == 0 if j > 0 else True
        next_zero = T[j + 2, j + 1] == 0 if j + 2 < m else True
        a, b = T[j, j], T[j, j + 1]
        c_, d = sub, T[j + 1, j + 1]
        disc = (a - d) ** 2 + 4.0 * b * c_
        if not (sub != 0 and prev_zero and next_zero and disc >= 0):
            continue
        # dlanv2-style stable rotation: annihilates the subdiagonal to
        # machine precision even for (near-)defective blocks.
        p = 0.5 * (a - d)
        bcmax = max(abs(b), abs(c_))
        bcmis = min(abs(b), abs(c_)) * np.sign(b) * np.sign(c_)
        scale = max(abs(p), bcmax)
        rad = max(p * p / scale + bcmax * bcmis / scale, 0.0)
        root = np.sqrt(scale) * np.sqrt(rad)
        z = p + (root if p >= 0 else -root)
        tau = np.hypot(c_, z)
        cr, sr = (z / tau, c_ / tau) if tau > 0 else (1.0, 0.0)
        _rotate_real(T, U, j, cr, sr)
        T[j + 1, j] = 0.0
    return T, U


def _trailing(mask):
    """Index of the last True entry of ``mask``, or -1."""
    idx = np.flatnonzero(mask)
    return int(idx[-1]) if len(idx) else -1


def hessenberg_schur(H, max_iter=None) -> SchurResult:
    """Real Schur form of a real upper Hessenberg H: ``(T, U,
    converged, n_iter)`` with ``H = U T U^T``."""
    H = np.asarray(H, dtype=np.float64)
    m = H.shape[0]
    max_iter = 30 * m if max_iter is None else max_iter
    T = _deflate(clip_to_hessenberg(H).copy())
    U = np.eye(m)
    it = stall = 0
    while np.any(_unconverged_mask(T)) and it < max_iter:
        # The trailing unconverged subdiagonal's 2x2 gives the shifts.
        j = max(_trailing(_unconverged_mask(T)), 0)
        a, b, cc, d = T[j, j], T[j, j + 1], T[j + 1, j], T[j + 1, j + 1]
        s, t = a + d, a * d - b * cc
        if stall >= 10:
            # Exceptional (ad-hoc) shifts (UpperHessenbergSchur.h:113-137).
            s_exc = abs(cc) + abs(T[j, max(j - 1, 0)])
            s, t = 2.0 * s_exc, s_exc * s_exc
        T2, Q = double_shift_qr(T, s, t)
        T = _deflate(T2)
        U = U @ Q
        T, U = _split_real_blocks(T, U)
        # The stall count resets when the trailing unconverged index moves.
        stall = stall + 1 if _trailing(_unconverged_mask(T)) == j else 0
        it += 1
    return SchurResult(T=T, U=U, converged=not np.any(_unconverged_mask(T)),
                       n_iter=it)


def complexify_schur(T, U):
    """A real Schur pair (T quasi-triangular, U orthogonal) as a complex
    Schur pair (T_c upper triangular, U_c unitary): each isolated 2x2
    block is rotated by the unitary whose first column is the block's
    unit eigenvector (per block, what Eigen's ComplexSchur gives the
    reference, UpperHessenbergEigen.h:329-454)."""
    m = T.shape[0]
    Tc = np.asarray(T).astype(np.complex128)
    Uc = np.asarray(U).astype(np.complex128)
    for j in range(m - 1):
        if Tc[j + 1, j] == 0:
            continue
        a, b = Tc[j, j], Tc[j, j + 1]
        c_, d = Tc[j + 1, j], Tc[j + 1, j + 1]
        mean = 0.5 * (a + d)
        disc = (a - d) * (a - d) + 4.0 * b * c_
        lam = mean + 0.5 * np.sqrt(disc)  # complex sqrt: disc < 0
        v0, v1 = lam - d, c_
        nrm = np.sqrt(abs(v0) ** 2 + abs(v1) ** 2)
        v0, v1 = v0 / nrm, v1 / nrm
        # unitary Q2 = [[v0, -conj(v1)], [v1, conj(v0)]]
        r0 = np.conj(v0) * Tc[j, :] + np.conj(v1) * Tc[j + 1, :]
        Tc[j + 1, :] = -v1 * Tc[j, :] + v0 * Tc[j + 1, :]
        Tc[j, :] = r0
        c0 = Tc[:, j] * v0 + Tc[:, j + 1] * v1
        Tc[:, j + 1] = -Tc[:, j] * np.conj(v1) + Tc[:, j + 1] * np.conj(v0)
        Tc[:, j] = c0
        u0 = Uc[:, j] * v0 + Uc[:, j + 1] * v1
        Uc[:, j + 1] = -Uc[:, j] * np.conj(v1) + Uc[:, j + 1] * np.conj(v0)
        Uc[:, j] = u0
        Tc[j + 1, j] = 0.0
        # The pair is exactly conjugate (real trace); enforce it so the
        # conjugate-pair tests downstream are exact.
        Tc[j, j], Tc[j + 1, j + 1] = lam, np.conj(lam)
    return np.triu(Tc), Uc


def triangular_eigenvectors(Tc):
    """Unit-norm eigenvectors of a complex upper triangular matrix by
    back-substitution (UpperHessenbergEigen.h:53-208, :329-454): column
    k solves ``(Tc - lambda_k I) y = 0`` with ``y[k] = 1``."""
    Tc = np.asarray(Tc)
    m = Tc.shape[0]
    lam = np.diagonal(Tc)
    eps = np.finfo(Tc.real.dtype).eps
    tnorm = max(np.abs(Tc).max(), 1.0)
    Y = np.zeros((m, m), dtype=Tc.dtype)
    for k in range(m):
        y = np.zeros(m, dtype=Tc.dtype)
        y[k] = 1.0
        for i in range(k - 1, -1, -1):
            s = Tc[i, :] @ y
            denom = Tc[i, i] - lam[k]
            if abs(denom) < eps * tnorm:
                denom = eps * tnorm
            y[i] = -s / denom
        Y[:, k] = y / np.linalg.norm(y)
    return Y


def hessenberg_schur_complex(H, max_iter=None) -> SchurResult:
    """Complex Schur form of a complex upper Hessenberg H by
    single-shift (Wilkinson) QR sweeps, the role Eigen's ComplexSchur
    plays for the reference (UpperHessenbergEigen.h:329-454):
    ``H = U T U^H``, T upper triangular."""
    H = np.asarray(H, dtype=np.complex128)
    m = H.shape[0]
    max_iter = 30 * m if max_iter is None else max_iter
    T = _deflate(clip_to_hessenberg(H).copy())
    U = np.eye(m, dtype=np.complex128)
    it = stall = 0
    jprev = -2
    while np.any(np.diagonal(T, offset=-1) != 0) and it < max_iter:
        j = max(_trailing(np.diagonal(T, offset=-1) != 0), 0)
        a, b, cc, d = T[j, j], T[j, j + 1], T[j + 1, j], T[j + 1, j + 1]
        # Wilkinson shift: the 2x2 eigenvalue closer to d.
        mean = 0.5 * (a + d)
        root = 0.5 * np.sqrt((a - d) * (a - d) + 4.0 * b * cc)
        lam1, lam2 = mean + root, mean - root
        shift = lam1 if abs(lam1 - d) <= abs(lam2 - d) else lam2
        if stall >= 10:
            shift = complex(abs(cc) + abs(b)) + d
        T2, Q = hessenberg_qr(T, shift)
        T = _deflate(T2)
        U = U @ Q
        j2 = _trailing(np.diagonal(T, offset=-1) != 0)
        stall = stall + 1 if j2 == jprev else 0
        jprev = j2
        it += 1
    return SchurResult(T=np.triu(T), U=U,
                       converged=not np.any(np.diagonal(T, offset=-1) != 0),
                       n_iter=it)


def hessenberg_eigen_native(H):
    """Eigenvalues and unit eigenvectors of a Hessenberg matrix through
    the Schur pipeline (no LAPACK eigensolver): real H -> real Schur ->
    per-block complexification; complex H -> complex Schur; then
    triangular back-substitution. Returns ``(evals (m,), evecs (m, m))``
    complex, conjugate pairs exact and adjacent for real H."""
    H = np.asarray(H)
    if np.iscomplexobj(H):
        res = hessenberg_schur_complex(H)
        Tc, Uc = res.T, res.U
    else:
        res = hessenberg_schur(H)
        Tc, Uc = complexify_schur(res.T, res.U)
    return np.diagonal(Tc).copy(), Uc @ triangular_eigenvectors(Tc)


def schur_eigenvalues(T):
    """Complex eigenvalues from a real quasi-triangular T: 1x1 diagonal
    blocks give real eigenvalues, 2x2 blocks conjugate pairs
    (reference: UpperHessenbergEigen.h:241-268)."""
    T = np.asarray(T, dtype=np.float64)
    zero = np.zeros(1)
    d = np.diagonal(T)
    sub = np.concatenate([np.diagonal(T, offset=-1), zero])
    sup = np.concatenate([np.diagonal(T, offset=1), zero])
    is_start = sub != 0  # i starts a 2x2 block
    is_second = np.concatenate([[False], is_start[:-1]])
    d_next = np.concatenate([d[1:], zero])
    d_prev = np.concatenate([zero, d[:-1]])
    sub_prev = np.concatenate([zero, sub[:-1]])
    sup_prev = np.concatenate([zero, sup[:-1]])

    def root(disc):
        return np.sqrt(np.abs(disc).astype(np.complex128)
                       * np.where(disc < 0, -1.0, 1.0) + 0j)

    # block at (i, i+1): lambda = (a+d)/2 +- sqrt(disc)/2
    lam_start = (0.5 * (d + d_next)).astype(np.complex128) + 0.5 * root(
        (d - d_next) ** 2 + 4.0 * sup * sub
    )
    lam_second = (0.5 * (d_prev + d)).astype(np.complex128) - 0.5 * root(
        (d_prev - d) ** 2 + 4.0 * sup_prev * sub_prev
    )
    return np.where(is_start, lam_start,
                    np.where(is_second, lam_second, d.astype(np.complex128)))
