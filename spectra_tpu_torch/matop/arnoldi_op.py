"""The inner-product geometry of the Krylov process.

Port of :mod:`spectra_tpu.matop.arnoldi_op` with ``B = I`` only
(reference: include/Spectra/MatOp/internal/ArnoldiOp.h:33-162): inner
products, projections and norms are plain dots on the operator's
device. :class:`LockedArnoldiOp` deflates it against locked Ritz
vectors (``compute_locked``). The B-metric of generalized problems
(ROADMAP.md item 13) and the J-structured operator of the Hermitian
embedding (item 14) wait for their slices.
"""

import torch

from spectra_tpu_torch.ops.gemv import basis_apply, basis_proj, vec_dot


class ArnoldiOp:
    """Krylov operator with the standard (B = I) inner product."""

    def __init__(self, op):
        self.op = op

    @classmethod
    def create(cls, op, bop=None):
        if bop is not None:
            raise NotImplementedError(
                "a B-metric (generalized problem) waits for its slice: "
                "ROADMAP.md item 13"
            )
        if hasattr(op, "j_map"):
            raise NotImplementedError(
                "J-structured operators wait for their slice: "
                "ROADMAP.md item 14"
            )
        return cls(op)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def rows(self) -> int:
        return self.op.rows()

    def perform_op(self, x):
        """The 'A' operator generating the Krylov subspace."""
        return self.op.perform_op(x)

    def inner_product(self, x, y):
        """<x, y> = x^H y, a 0-d tensor."""
        return vec_dot(x, y)

    def adjoint_product(self, X, y):
        """<x_i, y> for a row-major basis block X (m, n): the projection
        GEMV of the hot loop."""
        return basis_proj(X, y)

    def norm(self, x):
        """sqrt(real(x^H x)), a 0-d tensor."""
        return torch.sqrt(torch.real(self.inner_product(x, x)))

    def deflate(self, y):
        """Hook for deflated operators; identity here."""
        return y

    def ortho_basis(self, V):
        """The basis block the residual is orthogonalized against."""
        return V


class LockedArnoldiOp:
    """An :class:`ArnoldiOp` deflated against locked (converged) Ritz
    vectors: ``perform_op = P . inner . P`` with the projector
    ``P y = y - sum_blocks blk^T (blk y)``.

    ``locked`` is a TUPLE of (q_i, n) row-major orthonormal blocks, one
    per completed locking round, never concatenated: at the north star's
    scale a concatenation would hold both blocks and their copy at once,
    while the per-block projections stay bounded. The Krylov process
    then explores only the orthogonal complement of the locked vectors:
    restarted there from a fresh random vector, it finds the remaining
    copies of degenerate eigenvalues that one Krylov sequence cannot
    resolve. On span(locked) the deflated operator is 0, which no
    extremal selection picks. P is re-applied at every operator
    application; breakdown-expansion candidates, which enter the basis
    without one, go through :meth:`deflate` explicitly.
    """

    def __init__(self, inner: ArnoldiOp, locked: tuple):
        self.inner = inner
        self.locked = tuple(locked)

    @property
    def op(self):
        return self.inner.op

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    def rows(self) -> int:
        return self.inner.rows()

    def deflate(self, y):
        """``P y``: remove the components along every locked block."""
        for blk in self.locked:
            y = y - basis_apply(blk, self.inner.adjoint_product(blk, y))
        return y

    def perform_op(self, x):
        return self.deflate(self.inner.perform_op(self.deflate(x)))

    def inner_product(self, x, y):
        return self.inner.inner_product(x, y)

    def adjoint_product(self, X, y):
        return self.inner.adjoint_product(X, y)

    def norm(self, x):
        return self.inner.norm(x)

    def ortho_basis(self, V):
        return self.inner.ortho_basis(V)
