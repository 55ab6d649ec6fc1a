"""LOBPCG: locally optimal block preconditioned conjugate gradient.

Port of :mod:`spectra_tpu.contrib.lobpcg` (reference:
include/Spectra/contrib/LOBPCGSolver.h:83-551): the ``nev`` smallest
eigenpairs of ``A x = lambda B x`` for symmetric A (B SPD, optional),
with an optional preconditioner T and deflation constraints Y, by
Rayleigh-Ritz over the trial space ``[X, T r, P]``.

Where the work runs: the blocks X, the residuals, the search directions
and every product with A, B and T stay on the solver's device; the small
Gram matrices are read to the host, where their Cholesky factors, the
whitening and the (3m, 3m) eigenproblem run in f64 (LAPACK). A failed
Cholesky (``torch.linalg.cholesky_ex``'s ``info``) gives a NaN factor,
as ``jnp.linalg.cholesky`` does, so that the retry rules are the JAX
package's. The guard vectors of the rank-deficient
recovery and of soft locking are drawn from ``numpy.random.RandomState``
with the JAX package's seeds, on the host.

Over a row-sharded operator A (one that carries a ``mesh``) the blocks
hold the rank's rows: every Gram matrix, residual norm and constraint
projection is one all-reduce, the guard vectors are drawn at the global
shape and cut, and every rank solves the same small problems.
"""

import numpy as np
import torch

from spectra_tpu_torch.linalg.ritz_pairs import eigh_host
from spectra_tpu_torch.ops.gemv import col_norms
from spectra_tpu_torch.util.capabilities import resolve_device
from spectra_tpu_torch.util.compinfo import CompInfo


def _as_matvec(mat, device):
    """A block product ``X -> M X`` for a product operator, a scipy sparse
    matrix (``SparseGenMatProd.create``, so a banded matrix runs K1), a
    dense array or a callable (called as it is)."""
    if mat is None:
        return None
    if callable(mat) and not hasattr(mat, "perform_op"):
        return mat
    if hasattr(mat, "perform_op"):
        return mat.perform_op
    from spectra_tpu_torch.matop.sparse import SparseGenMatProd, _is_scipy_sparse

    if _is_scipy_sparse(mat):
        return SparseGenMatProd.create(mat, device=device).perform_op
    m = torch.as_tensor(mat).to(device)
    return lambda X: m @ X


def _cholesky(G):
    """The lower Cholesky factor of the host matrix G, NaN where G is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(G)
    return L if int(info) == 0 else torch.full_like(L, torch.nan)


def _hermitian(G):
    return 0.5 * (G + G.mH)


class LOBPCGSolver:
    """Block preconditioned eigensolver for the smallest eigenpairs.

    Args:
      A: symmetric operator (product operator, scipy sparse, dense or a
        callable on (n, k) tensors).
      X: (n, nev) initial block; its column count is nev.
      device: where the blocks live; ``None`` means the operator's
        device for a product operator and the GPU otherwise (raising
        when there is none).

    ``set_B``, ``set_preconditioner`` and ``set_constraints`` mirror the
    reference's ``setB``, ``setPreconditioner`` and ``setConstraints``.
    """

    def __init__(self, A, X, device=None):
        if device is None and hasattr(A, "perform_op"):
            device = A.device
        self._device = resolve_device(device)
        self._A = _as_matvec(A, self._device)
        #: The row mesh of a sharded A, else None.
        self._mesh = getattr(A, "mesh", None)
        self._n = A.rows() if self._mesh is not None else None
        self._X0 = self._rows(X).to(self._device)
        self._B = None
        self._T = None
        self._Y = None
        self._info = CompInfo.NotComputed
        self._vals = None
        self._vecs = None
        self._resid = None
        self._niter = 0

    def set_B(self, B):
        self._B = _as_matvec(B, self._device)

    setB = set_B

    def set_preconditioner(self, T):
        self._T = _as_matvec(T, self._device)

    setPreconditioner = set_preconditioner

    def set_constraints(self, Y):
        """Deflate against the (B-orthonormal) columns of Y (over a sharded
        A, the whole block or the rank's rows)."""
        self._Y = self._rows(Y).to(self._device, self._X0.dtype)

    setConstraints = set_constraints

    # -- helpers -------------------------------------------------------
    def _rows(self, X):
        """``X`` as a tensor; over a mesh a whole block is cut to the
        rank's rows."""
        X = torch.as_tensor(X)
        if self._mesh is not None and X.shape[0] == self._n:
            X = self._mesh.local_rows(X)
        return X

    def _guard(self, seed: int, n: int, k: int, like):
        """``k`` unit random guard columns from ``RandomState(seed)``,
        drawn at the global length ``n`` and cut to the rank's rows."""
        guard = np.random.RandomState(seed).normal(size=(n, k))
        guard = torch.from_numpy(guard / np.linalg.norm(guard, axis=0))
        if self._mesh is not None:
            guard = self._mesh.local_rows(guard)
        return guard.to(like.device, like.dtype)

    def _reduce(self, t):
        return t if self._mesh is None else self._mesh.all_reduce(t)

    def _apply_B(self, X):
        return X if self._B is None else self._B(X)

    def _host_gram(self, X, Y):
        """``X^H Y`` symmetrized, on the host."""
        return _hermitian(self._reduce(X.mH @ Y).cpu())

    def _b_orthonormalize(self, X, _attempt: int = 0):
        """X B-orthonormalized through the Cholesky factor of ``X^H B X``;
        returns ``(X, ok)``. A failed factor gets one rank-revealing
        recovery: X is rotated into the Gram matrix's eigenbasis and its
        numerically null directions are replaced by random guards."""
        G = self._host_gram(X, self._apply_B(X))
        L = _cholesky(G).to(X.device, X.dtype)
        # X L^{-H}, one triangular solve
        Xo = torch.linalg.solve_triangular(L, X.mH, upper=False).mH
        bad = ~torch.isfinite(Xo).all()
        ok = not bool(bad if self._mesh is None
                      else self._mesh.all_reduce(bad.to(torch.float64), "max"))
        if ok or _attempt >= 1:
            return Xo, ok
        s, U = eigh_host(G)
        n = X.shape[0] if self._mesh is None else self._n
        thresh = abs(float(s[-1])) * 1e-12
        k_bad = int((~(s > thresh)).sum())
        if k_bad == 0 or k_bad >= X.shape[1]:
            return Xo, False
        Xr = X @ U.to(X.device, X.dtype)
        Xr[:, :k_bad] = self._guard(1234 + _attempt, n, k_bad, Xr)
        return self._b_orthonormalize(Xr, _attempt + 1)

    def _deflate(self, R):
        if self._Y is None:
            return R
        Y = self._Y
        return R - Y @ self._reduce(self._apply_B(Y).mH @ R)

    def _rayleigh_ritz_x(self, X, AX):
        """Rotate X and AX into the Ritz basis of span(X)."""
        theta, C = eigh_host(self._host_gram(X, AX))
        C = C.to(X.device, X.dtype)
        return theta, X @ C, AX @ C

    # -- main loop -----------------------------------------------------
    def compute(self, maxit: int = 100, tol_div_n: float = 1e-7,
                soft_locking: bool = True) -> int:
        """Iterate; the convergence bar is ``tol = tol_div_n * n`` on each
        residual column norm (LOBPCGSolver.h compute(maxit, tol_div_n)).

        ``soft_locking`` (default on; the reference has no locking)
        restricts the residual block W to the columns whose pairs have
        not converged, rounded up to one of the widths {ceil(m/4),
        ceil(m/2), m} and filled with random guard directions; converged
        vectors stay in the Rayleigh-Ritz basis."""
        n, m = self._X0.shape
        if self._mesh is not None:
            n = self._n
        tol = tol_div_n * n
        dev = self._device

        X, ok = self._b_orthonormalize(self._deflate(self._X0))
        if not ok:
            self._info = CompInfo.NumericalIssue
            return 0
        theta, X, AX = self._rayleigh_ritz_x(X, self._A(X))
        P = AP = None

        nconv = 0
        for it in range(maxit):
            self._niter = it + 1
            theta_d = theta.to(dev, X.dtype)
            R = AX - self._apply_B(X) * theta_d[None, :]
            resid = col_norms(R, self._mesh).cpu()
            nconv = int((resid < tol).sum())
            if nconv >= m:
                self._info = CompInfo.Successful
                break

            R_act = R
            if soft_locking and 0 < nconv:
                n_act = m - nconv
                buckets = sorted({m, -(-m // 2), -(-m // 4)})
                width = next(b for b in buckets if b >= n_act)
                order = np.argsort((resid < tol).numpy(), kind="stable")
                R_act = R[:, torch.from_numpy(order[:width]).to(dev)]
                if width > n_act:
                    R_act[:, n_act:] = self._guard(it, n, width - n_act, R)
            W = R_act if self._T is None else self._T(R_act)
            W, ok = self._b_orthonormalize(self._deflate(W))
            if not ok:
                self._info = CompInfo.NumericalIssue
                break

            blocks = [X, W] if P is None else [X, W, P]
            ablocks = [AX, self._A(W)] if P is None else [AX, self._A(W), AP]
            S = torch.cat(blocks, dim=1)
            AS = torch.cat(ablocks, dim=1)
            gramA = self._host_gram(S, AS)
            gramB = self._host_gram(S, self._apply_B(S))
            # Generalized Rayleigh-Ritz through the Cholesky whitening of B.
            L = _cholesky(gramB)
            if not bool(torch.isfinite(L).all()):
                if P is not None:
                    # Drop P and retry with the two-block space.
                    P = AP = None
                    continue
                # Even [X, W] is B-degenerate: rebuild X through the
                # rank-revealing orthonormalization.
                X, ok = self._b_orthonormalize(X)
                if not ok:
                    self._info = CompInfo.NumericalIssue
                    break
                theta, X, AX = self._rayleigh_ritz_x(X, self._A(X))
                continue
            Linv = torch.linalg.inv(L)
            w, Z = eigh_host(_hermitian(Linv @ gramA @ Linv.mH))
            C = Linv.mH @ Z[:, :m]
            theta = w[:m]

            Cd = C.to(dev, S.dtype)
            X_new, AX_new = S @ Cd, AS @ Cd
            # Implicit P: the component of the update orthogonal to X.
            Cp = Cd.clone()
            Cp[:m, :] = 0.0
            P, AP = S @ Cp, AS @ Cp
            p_norms = col_norms(P, self._mesh)
            p_norms = torch.where(p_norms > 0, p_norms, torch.ones_like(p_norms))
            P, AP = P / p_norms, AP / p_norms
            X, AX = X_new, AX_new
        else:
            self._info = CompInfo.NotConverging

        if self._info == CompInfo.NotComputed:
            self._info = CompInfo.NotConverging
        self._vals = theta[:m].numpy()
        self._vecs = X
        theta_d = theta[:m].to(dev, X.dtype)
        self._resid = col_norms(
            AX - self._apply_B(X) * theta_d[None, :], self._mesh
        ).cpu().numpy()
        return nconv

    # -- accessors -----------------------------------------------------
    def info(self) -> CompInfo:
        return self._info

    def num_iterations(self) -> int:
        return self._niter

    def eigenvalues(self) -> np.ndarray:
        return self._vals

    def eigenvectors(self) -> torch.Tensor:
        """The (n, nev) block of eigenvectors, on the solver's device (over
        a sharded A, the rank's rows)."""
        return self._vecs

    def residuals(self) -> np.ndarray:
        return self._resid
