"""Basis orthogonalization for the Jacobi-Davidson stack.

Port of :mod:`spectra_tpu.linalg.orthogonalization` (reference:
include/Spectra/LinAlg/Orthogonalization.h:46-137): QR, Gram-Schmidt
(classic and modified), the projection of new columns against an
orthonormal block, the ``JensWehner`` method (that projection, then a
QR of the new block) and ``twice_is_enough``, which applies it twice.
Each takes a tensor (n, k) and works on its device. The QR of a real
f32 or f64 block on the card with 1 to ``ops.tsqr.MAX_COLS`` columns
and at least as many rows is the hand-written tall-skinny QR
(:func:`spectra_tpu_torch.ops.tsqr.tsqr`);
every other QR is ``torch.linalg.qr`` (cuSOLVER on the card, LAPACK on
the CPU) with the same sign fix, and ``LIBRARY_QRS`` counts those on
the card. The Gram-Schmidt variants loop over the columns on the host,
as the JAX package's ``fori_loop`` does.
"""

import torch

from spectra_tpu_torch.ops import tsqr

#: QRs of CUDA tensors that went to ``torch.linalg.qr`` since import (or
#: since a caller reset it to 0).
LIBRARY_QRS = 0


def qr_orthogonalisation(A, mesh=None):
    """The columns of A orthonormalized by a reduced QR, the signs fixed
    so that R has a non-negative diagonal. The result is row-major
    contiguous: a block the DIA kernel takes as it is. For A holding a
    rank's rows of a row ``mesh``, the block is all-gathered, the QR
    runs replicated on every rank and each keeps its rows: what GSPMD
    does with a QR of a row-sharded array, with the single-device
    rounding."""
    global LIBRARY_QRS
    if mesh is not None:
        return mesh.local_rows(qr_orthogonalisation(mesh.all_gather(A))).contiguous()
    if tsqr.routes_to_kernel(A.device.type, A.dtype, A.shape):
        return tsqr.tsqr(A.contiguous())[0]
    if A.device.type == "cuda":
        LIBRARY_QRS += 1
    return tsqr.tsqr_plain(A)[0]


def gram_schmidt_orthogonalisation(A):
    """Classic Gram-Schmidt over the columns."""
    Q = torch.zeros_like(A)
    for j in range(A.shape[1]):
        v = A[:, j] - Q[:, :j] @ (Q[:, :j].mH @ A[:, j])
        Q[:, j] = v / torch.linalg.vector_norm(v)
    return Q


def modified_gram_schmidt_orthogonalisation(A):
    """Modified Gram-Schmidt over the columns."""
    Q = torch.zeros_like(A)
    for j in range(A.shape[1]):
        v = A[:, j]
        for i in range(j):
            v = v - torch.vdot(Q[:, i], v) * Q[:, i]
        Q[:, j] = v / torch.linalg.vector_norm(v)
    return Q


def subspace_orthogonalisation(A, n_locked: int, mesh=None):
    """The trailing columns of A projected against its first
    ``n_locked`` (orthonormal) columns: ``A_new - Q Q^H A_new`` (on a
    row ``mesh``, ``Q^H A_new`` summed over the ranks)."""
    Q, rest = A[:, :n_locked], A[:, n_locked:]
    coef = Q.mH @ rest
    if mesh is not None:
        coef = mesh.all_reduce(coef)
    return torch.cat([Q, rest - Q @ coef], dim=1)


def jens_wehner_orthogonalisation(A, n_locked: int, mesh=None):
    """The subspace projection of the new columns, then their QR
    (reference: Orthogonalization.h:133-137)."""
    A = subspace_orthogonalisation(A, n_locked, mesh)
    return torch.cat([A[:, :n_locked], qr_orthogonalisation(A[:, n_locked:], mesh)], dim=1)


def twice_is_enough(A, n_locked: int, mesh=None):
    """:func:`jens_wehner_orthogonalisation` twice, Kahan's rule
    (reference: Orthogonalization.h, used by the reference search space's
    ``extend_basis``)."""
    return jens_wehner_orthogonalisation(
        jens_wehner_orthogonalisation(A, n_locked, mesh), n_locked, mesh
    )
