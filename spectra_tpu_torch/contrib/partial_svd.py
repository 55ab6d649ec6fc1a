"""Truncated (partial) SVD through the symmetric eigensolver.

Port of :mod:`spectra_tpu.contrib.partial_svd` (reference:
include/Spectra/contrib/PartialSVDSolver.h:117-203): the IRLM runs on
the Gram operator, ``A^H A`` for a tall matrix (SVDTallMatOp, :40-73),
``A A^H`` for a wide one (:79-112), with ``LargestAlge`` (:156-162);
the other side's singular vectors come from one product scaled by the
singular values (:173-202). Each Gram product is two products on the
operator's device: for a banded sparse matrix, K1 forward and the plain
``DiaMatrix.rmatvec`` adjoint.

Over a row-sharded operator (``parallel.shard_operator`` of a
rectangular matrix) the Gram operator carries its mesh: the IRLM's
vectors are the rank's share of the Gram side, the adjoint product sums
its partials over the ranks, and ``matrix_U`` and ``matrix_V`` return
the rank's rows.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.matop.dense import DenseGenMatProd
from spectra_tpu_torch.matop.sparse import SparseGenMatProd, _is_scipy_sparse
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.util.selection import SortRule


@dataclasses.dataclass(frozen=True, eq=False)
class _GramOp:
    """x -> A^H (A x) (tall) or x -> A (A^H x) (wide)."""

    matop: object
    wide: bool

    @property
    def dtype(self):
        return self.matop.dtype

    @property
    def device(self):
        return self.matop.device

    @property
    def mesh(self):
        """The row mesh of a sharded ``matop``, else None."""
        return getattr(self.matop, "mesh", None)

    def rows(self) -> int:
        return self.matop.rows() if self.wide else self.matop.cols()

    def cols(self) -> int:
        return self.rows()

    def perform_op(self, x):
        if self.wide:
            return self.matop.perform_op(self.matop.perform_adjoint_op(x))
        return self.matop.perform_adjoint_op(self.matop.perform_op(x))


class PartialSVDSolver:
    """The largest ``ncomp`` singular triplets of a dense or sparse
    matrix, or of an operator with ``perform_op`` and
    ``perform_adjoint_op`` (which keeps its own device). A matrix goes
    to ``device``; ``None`` means the GPU and raises when there is none.

    Example
    -------
    >>> svds = PartialSVDSolver(A, ncomp=5, ncv=15)
    >>> nconv = svds.compute()
    >>> s, U, V = svds.singular_values(), svds.matrix_U(5), svds.matrix_V(5)
    """

    def __init__(self, mat, ncomp: int, ncv: int, device=None):
        if hasattr(mat, "perform_op"):
            if not hasattr(mat, "perform_adjoint_op"):
                raise TypeError(
                    "operator input to PartialSVDSolver/svds must expose "
                    "both perform_op and perform_adjoint_op (the Gram "
                    "matvec is A^H(Ax)); got "
                    f"{type(mat).__name__} without perform_adjoint_op"
                )
            self._matop = mat
        elif _is_scipy_sparse(mat):
            self._matop = SparseGenMatProd.create(mat, device=device)
        else:
            self._matop = DenseGenMatProd.create(np.asarray(mat), device=device)
        self._m = self._matop.rows()
        self._n = self._matop.cols()
        self._wide = self._m < self._n
        self._ncomp = int(ncomp)
        self._eigs = SymEigsSolver(
            _GramOp(matop=self._matop, wide=self._wide), nev=ncomp, ncv=ncv
        )

    def compute(self, maxit: int = 1000, tol: float = 1e-10) -> int:
        """Run the eigensolver on the Gram operator; returns nconv."""
        self._eigs.init()
        return self._eigs.compute(SortRule.LargestAlge, maxit, tol)

    def singular_values(self) -> np.ndarray:
        """Converged singular values, descending."""
        return np.sqrt(np.maximum(self._eigs.eigenvalues(), 0.0))

    def _cross(self, nvec):
        """The other side's singular vectors: ``A V S^{-1}`` (tall) or
        ``A^H U S^{-1}`` (wide), reference :173-202."""
        vecs = self._eigs.eigenvectors(nvec)
        s = torch.from_numpy(self.singular_values()[: vecs.shape[1]]).to(vecs.device)
        if self._wide:
            applied = self._matop.perform_adjoint_op(vecs)
        else:
            applied = self._matop.perform_op(vecs)
        return applied / s.to(applied.dtype)[None, :]

    def matrix_U(self, nu: int) -> torch.Tensor:
        """Left singular vectors (m, nu), on the operator's device (over a
        sharded operator, the rank's rows)."""
        nu = min(nu, self._ncomp)
        if self._wide:
            return self._eigs.eigenvectors(nu)
        return self._cross(nu)[:, :nu]

    def matrix_V(self, nv: int) -> torch.Tensor:
        """Right singular vectors (n, nv), on the operator's device (over
        a sharded operator, the rank's rows)."""
        nv = min(nv, self._ncomp)
        if self._wide:
            return self._cross(nv)[:, :nv]
        return self._eigs.eigenvectors(nv)

    def info(self):
        return self._eigs.info()

    def num_iterations(self) -> int:
        return self._eigs.num_iterations()

    def num_operations(self) -> int:
        return self._eigs.num_operations()
