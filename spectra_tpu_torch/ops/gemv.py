"""Basis products of the Krylov loop.

Port of :mod:`spectra_tpu.ops.gemv`. The basis is row-major: ``V`` has
shape (m, n) with basis vector i in row ``V[i]``. The JAX package
routes f64 on the TPU through broadcast-and-sum sweeps because the
TPU's matrix unit emulates f64; the card has native f64, so every
product here is a plain torch product (cuBLAS on the card, BLAS on
the CPU). On a row mesh (:mod:`spectra_tpu_torch.parallel`) the
callers pass ``mesh`` and the n-length sums are all-reduced.
"""

import torch


def vec_dot(x, y, mesh=None):
    """``<x, y> = conj(x) y`` for n-vectors, as a 0-d tensor; for
    vectors row-sharded over ``mesh``, the sum over its ranks."""
    d = torch.vdot(x, y)
    return d if mesh is None else mesh.all_reduce(d)


def vec_norm(x, mesh=None):
    """``||x||_2`` as a 0-d tensor; for x row-sharded over ``mesh``, the
    root of the all-reduced sum of squares."""
    if mesh is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(mesh.all_reduce(torch.vdot(x, x).real))


def col_norms(X, mesh=None):
    """The column 2-norms of an (n, k) block X as a (k,) tensor; for X
    row-sharded over ``mesh``, the roots of the all-reduced column sums
    of squares."""
    if mesh is None:
        return torch.linalg.vector_norm(X, dim=0)
    return torch.sqrt(mesh.all_reduce((X.conj() * X).real.sum(dim=0)))


def basis_proj(X, y):
    """``conj(X) y`` for a row-major basis block X (m, n) and y (n,):
    the projection coefficients ``<x_i, y>`` as an (m,) vector."""
    return X.conj() @ y


def basis_apply(X, h):
    """``sum_i h_i x_i`` for a row-major basis block X (m, n) and
    coefficients h (m,): the reconstruction as an (n,) vector."""
    return h @ X


def basis_apply_block(X, H):
    """Basis rotation ``H^T X`` for X (m, n) and a small H (m, k): the
    rotated (k, n) row-major basis whose row j is ``sum_i H[i, j] x_i``
    (restart compression and eigenvector assembly)."""
    return H.mT @ X
