"""The B-inner-product geometry of the Krylov process.

Port of :mod:`spectra_tpu.matop.arnoldi_op` (reference:
include/Spectra/MatOp/internal/ArnoldiOp.h:33-162): the Krylov operator
with the metric ``B`` of a generalized problem, so that inner products,
projections and norms are taken in ``<x, y> = x^H B y``, on the
operator's device. ``bop=None`` means B = I, and then each is a plain
dot with no B product. :class:`LockedArnoldiOp` deflates it against
locked Ritz vectors (``compute_locked``) in the same metric.
:class:`JStructuredArnoldiOp` is the operator of the real embedding of
a Hermitian problem, whose residuals are also orthogonalized against
``J V``.

An operator (or metric) that carries a ``mesh`` (the row-sharded
operators of :mod:`spectra_tpu_torch.parallel`) makes every inner
product, projection and norm the sum over the mesh's ranks: one
all-reduce each, identical on every rank. Without a mesh nothing
changes.
"""

import torch

from spectra_tpu_torch.ops.gemv import basis_apply, basis_proj, vec_dot


class IdentityBOp:
    """Placeholder for B = I (the standard eigenvalue problem)."""

    __slots__ = ()


class ArnoldiOp:
    """Krylov operator and B-metric; ``bop=None`` means B = I."""

    #: True when ``ortho_basis`` is wider than V, so that the
    #: factorization orthogonalizes against the extra rows too.
    has_structure = False

    def __init__(self, op, bop=None):
        self.op = op
        self.bop = bop
        #: The row mesh of a sharded operator or metric, else None.
        self.mesh = getattr(op, "mesh", None) or getattr(bop, "mesh", None)

    @classmethod
    def create(cls, op, bop=None):
        if isinstance(bop, IdentityBOp):
            bop = None
        if bop is None and hasattr(op, "j_map") and cls is ArnoldiOp:
            return JStructuredArnoldiOp(op, None)
        return cls(op, bop)

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

    def apply_b(self, y):
        """B y (y itself when B = I)."""
        if self.bop is None:
            return y
        return self.bop.perform_op(y)

    def inner_product(self, x, y):
        """<x, y> = x^H B y, a 0-d tensor."""
        return vec_dot(x, self.apply_b(y), self.mesh)

    def adjoint_product(self, X, y):
        """<x_i, y>_B for a row-major basis block X (m, n): the
        projection GEMV of the hot loop."""
        h = basis_proj(X, self.apply_b(y))
        return h if self.mesh is None else self.mesh.all_reduce(h)

    def norm(self, x):
        """The B-norm sqrt(real(x^H B x)), a 0-d tensor."""
        return torch.sqrt(torch.real(self.inner_product(x, x)))

    def adjoint_and_norm(self, X, y):
        """``(adjoint_product(X, y), norm(y))``: on a mesh, both from ONE
        all-reduce of the local partial sums."""
        if self.mesh is None:
            return self.adjoint_product(X, y), self.norm(y)
        part = torch.cat([
            basis_proj(X, self.apply_b(y)), vec_dot(y, self.apply_b(y)).reshape(1)
        ])
        total = self.mesh.all_reduce(part)
        return total[:-1], torch.sqrt(torch.real(total[-1]))

    def max_abs(self, x):
        """max |x_i| over every entry (every rank), a 0-d tensor."""
        m = x.abs().max()
        return m if self.mesh is None else self.mesh.all_reduce(m, "max")

    def deflate(self, y):
        """Hook for deflated operators; identity here."""
        return y

    def ortho_basis(self, V):
        """The basis block the residual is orthogonalized against."""
        return V


class JStructuredArnoldiOp(ArnoldiOp):
    """An :class:`ArnoldiOp` for an operator with a commuting complex
    structure J, ``op.j_map`` (the real embedding of a Hermitian matrix,
    :class:`~spectra_tpu_torch.matop.herm_embed.RealEmbeddedHermMatProd`,
    where ``J(x, y) = (-y, x)`` is multiplication by i).

    Real Lanczos on the embedding never sees ``J v`` in exact
    arithmetic, but rounding leaks J-orbit components into the basis,
    which grow into phantom duplicate Ritz pairs. Every residual is
    therefore orthogonalized against ``[V; J V]``: each Ritz pair is then
    a distinct complex eigenpair. The extra coefficients are rounding
    noise and are not recorded in H."""

    has_structure = True

    def ortho_basis(self, V):
        return torch.cat([V, self.op.j_map(V)], dim=0)


class LockedArnoldiOp:
    """An :class:`ArnoldiOp` deflated against locked (converged) Ritz
    vectors: ``perform_op = P . inner . P`` with the B-orthogonal
    projector ``P y = y - sum_blocks blk^T (blk B y)``.

    ``locked`` is a TUPLE of (q_i, n) row-major B-orthonormal blocks, one
    per completed locking round, never concatenated: at the north star's
    scale a concatenation would hold both blocks and their copy at once,
    while the per-block projections stay bounded. The Krylov process
    then explores only the B-orthogonal complement of the locked vectors:
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
    def has_structure(self):
        return self.inner.has_structure

    @property
    def op(self):
        return self.inner.op

    @property
    def bop(self):
        return self.inner.bop

    @property
    def mesh(self):
        return self.inner.mesh

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    def rows(self) -> int:
        return self.inner.rows()

    def deflate(self, y):
        """``P y``: remove the B-components along every locked block (and
        their J-orbits for a structured inner operator)."""
        for blk in self.locked:
            wide = self.inner.ortho_basis(blk)
            y = y - basis_apply(wide, self.inner.adjoint_product(wide, y))
        return y

    def perform_op(self, x):
        return self.deflate(self.inner.perform_op(self.deflate(x)))

    def apply_b(self, y):
        return self.inner.apply_b(y)

    def inner_product(self, x, y):
        return self.inner.inner_product(x, y)

    def adjoint_product(self, X, y):
        return self.inner.adjoint_product(X, y)

    def norm(self, x):
        return self.inner.norm(x)

    def adjoint_and_norm(self, X, y):
        return self.inner.adjoint_and_norm(X, y)

    def max_abs(self, x):
        return self.inner.max_abs(x)

    def ortho_basis(self, V):
        return self.inner.ortho_basis(V)
