"""scipy.sparse.linalg-compatible convenience frontend.

Port of :mod:`spectra_tpu.api`. One call, scipy's surface, routed onto
the class-based solver stack (the frontend adds nothing the classes
cannot do, it only routes):

    w, v = spectra_tpu_torch.eigsh(A, k=6, sigma=0.0)   # nearest 0
    w, v = spectra_tpu_torch.eigs(A, k=6, which="LR")   # general A
    u, s, vt = spectra_tpu_torch.svds(A, k=5)

Semantics follow scipy where scipy and the reference agree (``which``
strings, the shift-invert meaning of ``which``, generalized modes
``normal``/``buckling``/``cayley``, ascending ``eigsh`` order,
ArpackNoConvergence-style partial results). Deliberate deviations, as in
the JAX package:

  * default ``tol=1e-10`` and ``ncv`` defaults mirror the reference's
    (``HermEigsBase.h:366-367``), not ARPACK's machine-eps default;
  * ``A`` may also be any operator of the port (``rows()``/
    ``perform_op``); it passes through as it is, on its own device.

``device`` (the port's idiom) goes to the operator constructors when a
matrix is wrapped; ``None`` means the GPU and raises without one. Results
are numpy arrays on the host, as scipy returns them.
"""

from __future__ import annotations

import numpy as np

from spectra_tpu_torch.util.geigsmode import GEigsMode
from spectra_tpu_torch.util.selection import SortRule

__all__ = ["eigsh", "eigs", "svds", "NoConvergence"]


class NoConvergence(RuntimeError):
    """Raised when fewer than k pairs converge (mirrors scipy's
    ``ArpackNoConvergence``): the converged subset is attached."""

    def __init__(self, msg, eigenvalues, eigenvectors):
        super().__init__(msg)
        self.eigenvalues = eigenvalues
        self.eigenvectors = eigenvectors


_WHICH_SYM = {
    "LM": SortRule.LargestMagn,
    "SM": SortRule.SmallestMagn,
    "LA": SortRule.LargestAlge,
    "SA": SortRule.SmallestAlge,
    "BE": SortRule.BothEnds,
}

_WHICH_GEN = {
    "LM": SortRule.LargestMagn,
    "SM": SortRule.SmallestMagn,
    "LR": SortRule.LargestReal,
    "SR": SortRule.SmallestReal,
    "LI": SortRule.LargestImag,
    "SI": SortRule.SmallestImag,
}


def _is_operator(A) -> bool:
    return hasattr(A, "perform_op") and hasattr(A, "rows")


def _is_scipy_sparse(A) -> bool:
    return hasattr(A, "tocsr") and not hasattr(A, "perform_op")


def _nsize(A) -> int:
    return A.rows() if _is_operator(A) else A.shape[0]


def _is_complex(A) -> bool:
    if _is_operator(A):
        return A.dtype.is_complex
    return np.issubdtype(
        A.dtype if _is_scipy_sparse(A) else np.asanyarray(A).dtype,
        np.complexfloating,
    )


def _default_ncv(n, k, min_extra):
    # scipy's default, clipped to the solver's legal range.
    ncv = min(n, max(2 * k + 1, 20))
    return max(ncv, k + min_extra)


def _matprod(A, hermitian: bool, device):
    """Wrap a matrix as the right MatProd operator on ``device`` (an
    operator passes through)."""
    if _is_operator(A):
        return A
    if hermitian and _is_complex(A):
        from spectra_tpu_torch.matop.dense import DenseHermMatProd
        from spectra_tpu_torch.matop.sparse import SparseHermMatProd

        if _is_scipy_sparse(A):
            return SparseHermMatProd.create(A, device=device)
        return DenseHermMatProd.create(np.asarray(A), device=device)
    if hermitian:
        from spectra_tpu_torch.matop.dense import DenseSymMatProd
        from spectra_tpu_torch.matop.sparse import SparseSymMatProd

        if _is_scipy_sparse(A):
            # Full matrix given (scipy convention), not a triangle.
            return SparseSymMatProd.from_full(A, device=device)
        return DenseSymMatProd.create(np.asarray(A), device=device)
    from spectra_tpu_torch.matop.dense import DenseGenMatProd
    from spectra_tpu_torch.matop.sparse import SparseGenMatProd

    if _is_scipy_sparse(A):
        return SparseGenMatProd.create(A, device=device)
    return DenseGenMatProd.create(np.asarray(A), device=device)


def _host(x):
    """A solver's result as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _finish(solver, k, n, return_eigenvectors, ascending):
    w = _host(solver.eigenvalues())
    nconv = int(len(w))
    v = _host(solver.eigenvectors()) if return_eigenvectors else None
    if ascending and w.size:
        order = np.argsort(w)
        w = w[order]
        if v is not None:
            v = v[:, order]
    if nconv < k:
        raise NoConvergence(
            f"only {nconv}/{k} eigenpairs converged "
            f"(info={solver.info()}, {solver.num_iterations()} restarts, "
            f"{solver.num_operations()} operator applications); the "
            "converged subset is attached (.eigenvalues/.eigenvectors)",
            w,
            v if return_eigenvectors else np.zeros((n, 0)),
        )
    return (w, v) if return_eigenvectors else w


def eigsh(
    A,
    k: int = 6,
    M=None,
    sigma=None,
    which: str = "LM",
    v0=None,
    ncv: int | None = None,
    maxiter: int = 1000,
    tol: float = 1e-10,
    return_eigenvectors: bool = True,
    mode: str = "normal",
    method: str = "auto",
    device=None,
):
    """k eigenpairs of the symmetric/Hermitian problem ``A x = l x`` (or
    ``A x = l M x``), scipy.sparse.linalg.eigsh-compatible.

    ``A``/``M``: numpy array, scipy sparse matrix, or any operator of
    the port. ``sigma`` enables shift-invert (``which`` then refers to
    the transformed values ``1/(l - sigma)``, as in scipy and the
    reference). ``mode`` in {"normal", "buckling", "cayley"} maps to the
    reference's GEigsMode spectral transforms. ``method`` picks the
    sparse shift-solve backend ("auto", "splu", "mg", "minres", "cheb",
    "cg", "bicgstab"). ``device`` places the wrapped matrices.

    Returns ``(w, v)`` with ``w`` ascending (scipy convention), or ``w``
    alone when ``return_eigenvectors=False``. Raises
    :class:`NoConvergence` (partial results attached) when fewer than k
    pairs converge.
    """
    import spectra_tpu_torch as stt

    n = _nsize(A)
    try:
        selection = _WHICH_SYM[which.upper()]
    except KeyError:
        raise ValueError(
            f"which={which!r}: expected one of {sorted(_WHICH_SYM)}"
        ) from None
    if not 1 <= k < n:
        raise ValueError(f"k={k} must satisfy 1 <= k < n={n}")
    ncv = _default_ncv(n, k, 1) if ncv is None else ncv
    if mode not in ("normal", "buckling", "cayley"):
        raise ValueError("mode must be 'normal', 'buckling' or 'cayley'")
    if mode != "normal" and (sigma is None or M is None):
        raise ValueError(f"mode='{mode}' requires both sigma and M")

    if M is None and sigma is None:
        op = _matprod(A, True, device)
        cls = stt.HermEigsSolver if _is_complex(A) else stt.SymEigsSolver
        solver = cls(op, nev=k, ncv=ncv)
    elif M is None:
        # Standard shift-invert.
        if _is_operator(A):
            if not hasattr(A, "set_shift"):
                raise ValueError(
                    "operator A with sigma must provide set_shift(sigma)"
                )
            op = A
        elif _is_scipy_sparse(A):
            if _is_complex(A):
                raise NotImplementedError(
                    "sparse complex-Hermitian shift-invert: build a "
                    "shift-solve operator and use SymEigsShiftSolver"
                )
            op = stt.SparseSymShiftSolve.create(A, method=method, device=device)
        elif _is_complex(A):
            op = stt.DenseHermShiftSolve.create(np.asarray(A), device=device)
        else:
            op = stt.DenseSymShiftSolve.create(np.asarray(A), device=device)
        solver = stt.SymEigsShiftSolver(op, nev=k, ncv=ncv, sigma=float(sigma))
    elif sigma is None:
        # Generalized, Cholesky mode (B spd).
        op = _matprod(A, True, device)
        if _is_operator(M):
            bop = M
        elif _is_scipy_sparse(M):
            bop = stt.SparseCholesky.create(M.tocsr(), device=device)
        else:
            bop = stt.DenseCholesky.create(np.asarray(M), device=device)
        solver = stt.SymGEigsSolver(op, bop, nev=k, ncv=ncv)
    else:
        # Generalized spectral transforms.
        geigs_mode = {
            "normal": GEigsMode.ShiftInvert,
            "buckling": GEigsMode.Buckling,
            "cayley": GEigsMode.Cayley,
        }[mode]
        shift_op = stt.SymShiftInvert.create(
            A, M, method=None if method == "auto" else method, device=device
        )
        # Buckling: the metric operator is K (= A); ShiftInvert and
        # Cayley: it is B (= M).
        bop = _matprod(A if geigs_mode == GEigsMode.Buckling else M, True, device)
        solver = stt.SymGEigsShiftSolver(
            shift_op, bop, nev=k, ncv=ncv, sigma=float(sigma), mode=geigs_mode
        )

    solver.init(v0)
    solver.compute(selection, maxit=int(maxiter), tol=float(tol))
    return _finish(solver, k, n, return_eigenvectors, ascending=True)


def eigs(
    A,
    k: int = 6,
    sigma=None,
    which: str = "LM",
    v0=None,
    ncv: int | None = None,
    maxiter: int = 1000,
    tol: float = 1e-10,
    return_eigenvectors: bool = True,
    method: str = "auto",
    device=None,
):
    """k eigenpairs of a general (non-symmetric) ``A``,
    scipy.sparse.linalg.eigs-compatible. A real ``sigma`` uses the real
    shift-invert solver; a complex ``sigma`` (on a real matrix) the
    complex-shift solver with the reference's two-root recovery
    (GenEigsComplexShiftSolver.h:55-128)."""
    import spectra_tpu_torch as stt

    n = _nsize(A)
    try:
        selection = _WHICH_GEN[which.upper()]
    except KeyError:
        raise ValueError(
            f"which={which!r}: expected one of {sorted(_WHICH_GEN)}"
        ) from None
    if not 1 <= k <= n - 2:
        raise ValueError(f"k={k} must satisfy 1 <= k <= n - 2 = {n - 2}")
    ncv = _default_ncv(n, k, 2) if ncv is None else ncv

    if sigma is None:
        solver = stt.GenEigsSolver(_matprod(A, False, device), nev=k, ncv=ncv)
    elif np.iscomplexobj(sigma) and complex(sigma).imag != 0.0:
        s = complex(sigma)
        if _is_operator(A):
            op = A
        elif _is_scipy_sparse(A):
            op = stt.SparseGenComplexShiftSolve.create(A, method=method, device=device)
        else:
            op = stt.DenseGenComplexShiftSolve.create(np.asarray(A), device=device)
        solver = stt.GenEigsComplexShiftSolver(
            op, nev=k, ncv=ncv, sigmar=s.real, sigmai=s.imag
        )
    else:
        if _is_operator(A):
            op = A
        elif _is_scipy_sparse(A):
            op = stt.SparseGenRealShiftSolve.create(A, method=method, device=device)
        else:
            op = stt.DenseGenRealShiftSolve.create(np.asarray(A), device=device)
        solver = stt.GenEigsRealShiftSolver(
            op, nev=k, ncv=ncv, sigma=float(np.real(sigma))
        )

    solver.init(v0)
    solver.compute(selection, maxit=int(maxiter), tol=float(tol))
    return _finish(solver, k, n, return_eigenvectors, ascending=False)


def svds(
    A,
    k: int = 6,
    ncv: int | None = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    return_singular_vectors: bool = True,
    device=None,
):
    """Largest k singular triplets, scipy.sparse.linalg.svds-compatible:
    returns ``(u, s, vh)`` with ``s`` ascending (scipy convention), or
    ``s`` alone. Wraps
    :class:`~spectra_tpu_torch.contrib.partial_svd.PartialSVDSolver`
    (Gram-matrix Lanczos, reference: contrib/PartialSVDSolver.h:117-203).
    """
    from spectra_tpu_torch.contrib.partial_svd import PartialSVDSolver

    m, n = A.shape if not _is_operator(A) else (A.rows(), A.cols())
    if not 1 <= k < min(m, n):
        raise ValueError(f"k={k} must satisfy 1 <= k < min(m, n)")
    ncv = _default_ncv(min(m, n), k, 1) if ncv is None else ncv
    solver = PartialSVDSolver(A, ncomp=k, ncv=ncv, device=device)
    nconv = solver.compute(maxit=int(maxiter), tol=float(tol))
    s = _host(solver.singular_values())[::-1]  # ascending
    if nconv < k:
        raise NoConvergence(
            f"only {nconv}/{k} singular values converged; the converged "
            "subset is attached (.eigenvalues holds singular values)",
            s,
            None,
        )
    if not return_singular_vectors:
        return s
    u = _host(solver.matrix_U(k))[:, ::-1]
    v = _host(solver.matrix_V(k))[:, ::-1]
    return u, s, v.conj().T
