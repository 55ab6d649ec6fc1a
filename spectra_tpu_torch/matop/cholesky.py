"""Cholesky operators for the generalized problem's Cholesky mode.

Port of :mod:`spectra_tpu.matop.cholesky` (reference:
include/Spectra/MatOp/DenseCholesky.h:34-125, SparseCholesky.h:36-128):
factor the SPD metric ``B = L L^H`` once and expose the two triangular
solves of the ``L^{-1} A L^{-H}`` transform.

:class:`DenseCholesky` factors and solves on the matrix's device
(``torch.linalg.cholesky_ex`` and ``solve_triangular``).
:class:`SparseCholesky` factors on the host with SuperLU in symmetric
mode, as the JAX package does (scipy has no sparse Cholesky), and
solves its triangles on the host; each solve copies its right-hand
side to the host and the result back to the operand's device.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.matop.dense import _as_tensor, _hermitize
from spectra_tpu_torch.util.capabilities import resolve_device
from spectra_tpu_torch.util.compinfo import CompInfo


def _tri_solve(L, x, upper):
    """``L^{-1} x`` for a triangular L and a vector or block x."""
    X = x[:, None] if x.ndim == 1 else x
    Y = torch.linalg.solve_triangular(L, X.to(L.dtype), upper=upper)
    return Y[:, 0] if x.ndim == 1 else Y


@dataclasses.dataclass(frozen=True, eq=False)
class DenseCholesky:
    """B = L L^H for dense SPD (real) or HPD (complex) B (reference:
    DenseCholesky.h:101-119).
    ``info()`` is ``NumericalIssue`` when the factor is not finite (B not
    positive definite)."""

    L: torch.Tensor

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        mat = _as_tensor(mat, device)
        L, info = torch.linalg.cholesky_ex(_hermitize(mat, uplo))
        if int(info) != 0:
            # cholesky_ex leaves a partial factor; the JAX package's
            # factor of a matrix that is not SPD is NaN.
            L = torch.full_like(L, torch.nan)
        return cls(L=L)

    def info(self) -> CompInfo:
        if bool(torch.isfinite(self.L).all()):
            return CompInfo.Successful
        return CompInfo.NumericalIssue

    @property
    def dtype(self):
        return self.L.dtype

    @property
    def device(self):
        return self.L.device

    def rows(self) -> int:
        return self.L.shape[0]

    def cols(self) -> int:
        return self.L.shape[1]

    def lower_triangular_solve(self, x):
        """y = L^{-1} x."""
        return _tri_solve(self.L, x, upper=False)

    def upper_triangular_solve(self, x):
        """y = L^{-H} x."""
        return _tri_solve(self.L.mH, x, upper=True)


class _HostTriangularSolver:
    """Host solves with the permuted Cholesky factor B = P^T (L L^H) P:
    ``lower(x) = L^{-1} (P x)``, ``upper(x) = P^T (L^{-H} x)``, the
    semantics of the reference's SimplicialLLT (SparseCholesky.h
    lower/upper_triangular_solve)."""

    __slots__ = ("lower", "upper", "perm", "np_dtype", "_spla")

    def __init__(self, lower_csr, perm, np_dtype):
        import scipy.sparse.linalg as spla

        self.lower = lower_csr
        self.upper = lower_csr.conj().T.tocsr()
        self.perm = perm
        self.np_dtype = np_dtype
        self._spla = spla

    def solve_lower(self, b):
        b = np.asarray(b)
        pb = np.empty_like(b)
        pb[self.perm] = b  # (P x)[perm_r[i]] = x[i], scipy's Pr convention
        return self._spla.spsolve_triangular(self.lower, pb, lower=True).astype(
            self.np_dtype
        )

    def solve_upper(self, b):
        y = self._spla.spsolve_triangular(self.upper, np.asarray(b), lower=False)
        return y[self.perm].astype(self.np_dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseCholesky:
    """Host-factored sparse Cholesky of SPD B.

    The factor comes from SuperLU in symmetric mode (``MMD_AT_PLUS_A``
    ordering, ``diag_pivot_thresh=0``, so the row and column
    permutations agree): ``B = P^T (L D L^H) P``, with ``sqrt(D)``
    folded into L. Like the reference's SimplicialLLT, both triangular
    solves are with respect to the permuted factor, which the Cholesky
    mode does not see. ``create(csr, uplo, device=...)``; ``device`` is
    where the solves' results go."""

    solver: object  # _HostTriangularSolver, or None when not ok
    n: int
    ok: bool
    device: torch.device

    @classmethod
    def create(cls, csr, uplo: str = "L", device=None):
        import scipy.sparse as sps
        import scipy.sparse.linalg as spla

        from spectra_tpu_torch.sparse.formats import symmetrize_scipy

        device = resolve_device(device)
        full = symmetrize_scipy(
            csr, uplo, conjugate=np.iscomplexobj(csr.data)
        ).tocsc()
        n = full.shape[0]
        try:
            lu = spla.splu(
                full,
                permc_spec="MMD_AT_PLUS_A",
                diag_pivot_thresh=0.0,
                options=dict(SymmetricMode=True),
            )
        except RuntimeError:
            return cls(solver=None, n=n, ok=False, device=device)
        d = lu.U.diagonal()
        if np.any(np.real(d) <= 0):
            return cls(solver=None, n=n, ok=False, device=device)
        sqrt_d = sps.diags(np.sqrt(d))
        Lt = (lu.L @ sqrt_d).tocsr().sorted_indices()
        solver = _HostTriangularSolver(Lt, lu.perm_r, full.dtype)
        return cls(solver=solver, n=n, ok=True, device=device)

    def info(self) -> CompInfo:
        return CompInfo.Successful if self.ok else CompInfo.NumericalIssue

    @property
    def dtype(self):
        return torch.from_numpy(np.zeros(0, self.solver.np_dtype)).dtype

    def rows(self) -> int:
        return self.n

    def cols(self) -> int:
        return self.n

    def _host(self, fn, x):
        y = fn(x.detach().cpu().numpy().astype(self.solver.np_dtype, copy=False))
        return torch.from_numpy(np.ascontiguousarray(y)).to(x.device)

    def lower_triangular_solve(self, x):
        """y = L^{-1} P x."""
        return self._host(self.solver.solve_lower, x)

    def upper_triangular_solve(self, x):
        """y = P^T L^{-H} x."""
        return self._host(self.solver.solve_upper, x)
