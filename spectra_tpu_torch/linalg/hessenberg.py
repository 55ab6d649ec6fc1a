"""Shifted QR sweeps on upper Hessenberg matrices, on the host.

Port of :mod:`spectra_tpu.linalg.hessenberg` (reference:
include/Spectra/LinAlg/UpperHessenbergQR.h:47-447, real and complex
scalars, and DoubleShiftQR.h:21-438, the Francis sweep of
``H^2 - s H + t I`` for conjugate shift pairs on real matrices). These
are the replicated (ncv, ncv) kernels of the implicitly restarted
Arnoldi method; the port runs them on the host in numpy (f64 or c128),
each rotation or reflector as whole-row and whole-column operations.
Each sweep returns the transformed H and the dense accumulated Q, whose
consumer ``V <- V Q`` is one product on the device.

Each rotation is one BLAS ``drot``/``zrot`` call on two rows or two
columns (in place, through strides): the arithmetic of the JAX
package's elementwise updates, up to the fused multiply-adds of the
host's BLAS.

Conventions (matching :mod:`spectra_tpu_torch.linalg.givens`):
  left-apply   row_i' = c row_i - s row_{i+1};
               row_{i+1}' = conj(s) row_i + c row_{i+1}
  right-apply  col_i' = c col_i - conj(s) col_{i+1};
               col_{i+1}' = s col_i + c col_{i+1}
with c real and s complex for complex scalars (LAPACK LAWN-150, as in
the reference's Givens.h:218-335).

Inputs are anything ``numpy.asarray`` takes (numpy arrays, CPU
tensors); outputs are numpy arrays.
"""

import math

import numpy as np
from scipy.linalg.blas import drot
from scipy.linalg.lapack import zrot

from spectra_tpu_torch.linalg.givens import givens_rotation, givens_rotation_complex


def _rotate(M, rot, c, s, n, offx, offy, inc):
    """One plane rotation in place on the flat C-contiguous M by BLAS
    ``drot``/``zrot`` (one call instead of eight array operations):
    ``x' = c x + s y``, ``y' = c y - conj(s) x`` on the two strided
    vectors at ``offx`` and ``offy``."""
    flat = M.reshape(-1)
    rot(flat, flat, c, s, n=n, offx=offx, incx=inc, offy=offy, incy=inc,
        overwrite_x=1, overwrite_y=1)


def _left_apply(M, i, c, s, rot):
    """Apply the i-th rotation to rows (i, i+1) of M in place:
    ``row_i' = c row_i - s row_{i+1}``,
    ``row_{i+1}' = conj(s) row_i + c row_{i+1}``."""
    m = M.shape[1]
    _rotate(M, rot, c, -s, m, i * m, (i + 1) * m, 1)


def _right_apply(M, i, c, s, rot):
    """Apply the i-th rotation to columns (i, i+1) of M in place:
    ``col_i' = c col_i - conj(s) col_{i+1}``,
    ``col_{i+1}' = s col_i + c col_{i+1}``."""
    rows, m = M.shape
    _rotate(M, rot, c, -np.conj(s), rows, i, i + 1, m)


def hessenberg_qr(H, shift):
    """One implicit shifted-QR sweep: ``H - shift I = Q R``, returning
    ``(H_new, Q)`` with ``H_new = R Q + shift I = Q^H H Q`` and Q dense.

    Real H with a real shift, or complex H with a complex shift (the
    reference's real/complex UpperHessenbergQR duality)."""
    complex_ = np.iscomplexobj(H)
    dtype = np.complex128 if complex_ else np.float64
    R = np.array(H, dtype=dtype, order="C")
    m = R.shape[0]
    giv, rot = (givens_rotation_complex, zrot) if complex_ else (givens_rotation, drot)
    shift = complex(shift) if complex_ else float(shift)
    diag = np.arange(m)
    R[diag, diag] -= shift
    rots = []
    for i in range(m - 1):
        c, s, _ = giv(R[i, i], R[i + 1, i])
        _left_apply(R, i, c, s, rot)
        rots.append((c, s))
    # T = R Q + shift I and dense Q, by right-applying the chain to R and
    # Q stacked in one array.
    RQ = np.concatenate([R, np.eye(m, dtype=dtype)])
    for i, (c, s) in enumerate(rots):
        _right_apply(RQ, i, c, s, rot)
    T, Q = RQ[:m], RQ[m:]
    T[diag, diag] += shift
    # Rounding fill strictly below the subdiagonal is structurally zero.
    return clip_to_hessenberg(T), np.ascontiguousarray(Q)


def clip_to_hessenberg(M):
    """Zero all entries below the first subdiagonal."""
    return np.triu(np.asarray(M), -1)


def _householder3(x, eps_scale):
    """3-element Householder vector v (unit or zero) with
    ``(I - 2 v v^H) x = alpha e1``; v = 0 when x[1:] is negligible (no
    reflection needed), the reference's stable-norm idea
    (DoubleShiftQR.h:51-104). Scalar host arithmetic on the three
    entries; returns a numpy array."""
    x0, x1, x2 = (float(e) for e in x)
    xnorm = math.sqrt(x0 * x0 + x1 * x1 + x2 * x2)
    tail = math.sqrt(x1 * x1 + x2 * x2)
    if tail <= eps_scale * max(xnorm, eps_scale):
        return np.zeros(3)
    v0 = x0 - (-xnorm if x0 >= 0 else xnorm)
    vnorm = math.sqrt(v0 * v0 + x1 * x1 + x2 * x2)
    if vnorm == 0:
        return np.zeros(3)
    vnorm = max(vnorm, 1e-300)
    return np.array([v0 / vnorm, x1 / vnorm, x2 / vnorm])


def double_shift_qr(H, s, t):
    """Francis double-shift sweep: implicit QR of ``H^2 - s H + t I``
    for real upper Hessenberg H, returning ``(H_new, Q)`` with
    ``H_new = Q^T H Q``.

    The bulge chase re-seeds at internal deflation points (the
    reference's block partition, DoubleShiftQR.h:334-398, as a per-step
    test): a step whose left neighbour subdiagonal is negligible starts
    a fresh shifted first column instead of chasing the vanished bulge.
    """
    H = np.asarray(H, dtype=np.float64)
    m = H.shape[0]
    eps = np.finfo(np.float64).eps
    s, t = float(s), float(t)
    # H padded by two rows/cols of zeros (every step reads a 3-window;
    # windows that cross the true boundary see zeros, and the reflector
    # degenerates to 2 or 0 elements by itself; index -1 at i = 0 reads
    # the padding), with Q stacked below it, so one column update
    # reflects both.
    HQ = np.zeros((2 * m + 2, m + 2))
    HQ[:m, :m] = H
    HQ[m + 2 :, :m] = np.eye(m)
    Hp = HQ[: m + 2]
    for i in range(m - 1):
        hsub = Hp[i, i - 1]
        near0 = eps * (abs(Hp[i - 1, i - 1]) + abs(Hp[i, i]))
        new_block = abs(hsub) <= near0
        if new_block:
            h00, h10 = float(Hp[i, i]), float(Hp[i + 1, i])
            x = (
                h00 * h00 + float(Hp[i, i + 1]) * h10 - s * h00 + t,
                h10 * (h00 + float(Hp[i + 1, i + 1]) - s),
                h10 * float(Hp[i + 2, i + 1]),
            )
        else:
            x = (float(hsub), float(Hp[i + 1, i - 1]), float(Hp[i + 2, i - 1]))
        scale = max(abs(e) for e in x)
        scale = scale if scale > 0 else 1.0
        v = _householder3([e / scale for e in x], eps)
        # P = I - 2 v v^T on rows i..i+2 of H (all columns), then on
        # columns i..i+2 of H and Q (all rows).
        rows = Hp[i : i + 3]
        rows -= 2.0 * np.outer(v, v @ rows)
        cols = HQ[:, i : i + 3]
        cols -= 2.0 * np.outer(cols @ v, v)
        # Restore the known zeros of the chased column (kills rounding
        # noise where the bulge was annihilated).
        if not (new_block or i == 0):
            Hp[i + 1 : i + 3, i - 1] = 0.0
    return clip_to_hessenberg(Hp[:m, :m]), np.ascontiguousarray(HQ[m + 2 :, :m])
