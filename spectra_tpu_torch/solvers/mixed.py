"""Mixed-precision solve mode: an f32 restarted Lanczos, then an f64
Rayleigh-Ritz refinement.

Port of :mod:`spectra_tpu.solvers.mixed` (:38-181). For tolerances of
about 1e-6 and looser, the whole IRLM runs on an f32 twin of the
operator (K1's f32 entry on a DIA matrix, half the bytes of every SpMV
and basis product). The k converged Ritz vectors are then refined
against the original f64 operator, a few block-Krylov rounds on
``span([U, A U])``:

    W  = A U                      (one (n, k) block product)
    Q  = qr([U, W])               (thin QR, (n, 2k))
    T  = Q^T (A Q)                (one (n, 2k) block product)
    T S = S Theta                 (accurate eigh, (2k, 2k), host)
    eigenpairs: (Theta, Q S), the k wanted ones

Error model: f32 Lanczos delivers residuals down to about
``c eps_f32 ||A||`` (c ~ 10-100), so the mode accepts
``tol >= MIXED_TOL_FLOOR = 1e-6`` and raises for tighter requests. The
refined eigenvalue errors fall to O(r^2 / gap); the returned residuals
are re-measured in f64 and gated, and ``mixed_report()`` reports them.

The n-length work stays on the solver's device: the block products
(K1's f64 block entry on a DIA matrix), the thin QR and the projection.
Only the (2k, 2k) ``eigh`` and the selection run on the host. The twin
runs with f32 matrix products at full f32 precision (no TF32), which
the call sets and restores, as the JAX package runs it under
``jax.default_matmul_precision("float32")``.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.ops.gemv import col_norms

#: minimum accepted tol in mixed mode (see module docstring).
MIXED_TOL_FLOOR = 1e-6


def _cast_rows_f32(op):
    """The f32 twin of a :class:`~spectra_tpu_torch.parallel.mesh.
    RowShardedMatProd`: its local DIA, ELL, hi/lo (as f32 DIA of the
    planes' sum) or dense rows in f32, on the same mesh."""
    from spectra_tpu_torch.parallel.mesh import _HiLoRows
    from spectra_tpu_torch.sparse.formats import DiaMatrix

    local = op.local
    if torch.is_tensor(local):
        local = local.to(torch.float32)
    elif isinstance(local, _HiLoRows):
        local = local.to_dia(op.n_cols, torch.float32)
    elif isinstance(local, DiaMatrix):
        local = dataclasses.replace(local, data=local.data.to(torch.float32))
    else:
        local = dataclasses.replace(local, vals=local.vals.to(torch.float32))
    return dataclasses.replace(op, local=local, diag=op.diag.to(torch.float32))


def cast_op_f32(op):
    """An f32 twin of a MatProd operator (or of its rows on a mesh), or
    None if unsupported (a halo-exchange stencil operator, as the JAX
    package has no twin for it either)."""
    from spectra_tpu_torch.matop.dense import DenseSymMatProd
    from spectra_tpu_torch.parallel.mesh import RowShardedMatProd
    from spectra_tpu_torch.sparse.formats import (
        DiaHiLoMatrix,
        DiaMatrix,
        EllMatrix,
    )

    if isinstance(op, RowShardedMatProd):
        return _cast_rows_f32(op)
    ell = getattr(op, "ell", None)
    if ell is not None:
        if isinstance(ell, DiaHiLoMatrix):
            store = ell.to_dia()
            store = dataclasses.replace(store, data=store.data.to(torch.float32))
        elif isinstance(ell, DiaMatrix):
            store = dataclasses.replace(ell, data=ell.data.to(torch.float32))
        elif isinstance(ell, EllMatrix):
            store = dataclasses.replace(ell, vals=ell.vals.to(torch.float32))
        else:
            return None
        return dataclasses.replace(op, ell=store)
    if isinstance(op, DenseSymMatProd):
        return dataclasses.replace(op, mat=op.mat.to(torch.float32))
    return None


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products at full f32 precision (no TF32) for the
    enclosed block; the earlier settings are restored afterwards."""
    precision = torch.get_float32_matmul_precision()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def _refine_rounds(op, U, selection, sorting, max_rounds=3, rtol_stop=5e-13):
    """Iterated f64 block-Krylov Rayleigh-Ritz on span([U, A U]).

    Each round enriches the subspace with one operator application on
    the (n, k) block, projects in f64 and keeps the k pairs ranked by
    ``selection``. Stops when the measured f64 residuals reach
    ``rtol_stop * max|theta|`` or stop improving. ``U`` is an (n, k)
    f64 tensor on the operator's device (over a row-sharded operator the
    rank's rows: the QR runs on the gathered block and ``T`` and the
    residual norms are all-reduced); returns ``(theta, V, resid)``
    with ``theta`` and ``resid`` numpy arrays and ``V`` a tensor on that
    device, and the number of rounds run (two block products each).
    """
    from spectra_tpu_torch.linalg.jacobi import eigh_accurate
    from spectra_tpu_torch.matop.internal_ops import whole_rows
    from spectra_tpu_torch.util.selection import argsort_np

    k = U.shape[1]
    mesh = getattr(op, "mesh", None)
    prev = np.inf
    best = None  # (theta, U, resid, worst) of the best round seen
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        W = op.perform_op(U)
        Q = whole_rows(lambda B: torch.linalg.qr(B)[0],
                       torch.cat([U, W], dim=1), mesh)
        AQ = op.perform_op(Q.contiguous())
        T = Q.mT @ AQ
        if mesh is not None:
            T = mesh.all_reduce(T)
        T = 0.5 * (T + T.mT)
        th_all, S_all = (a.numpy() for a in eigh_accurate(T))
        # the WANTED k by the selection rule; output order applied last
        order = np.asarray(argsort_np(selection, th_all))[:k]
        theta = th_all[order]
        S = torch.from_numpy(np.ascontiguousarray(S_all[:, order])).to(Q.device)
        U = Q @ S
        AU = AQ @ S
        th_dev = torch.from_numpy(theta).to(Q.device)
        resid = col_norms(AU - U * th_dev[None, :], mesh).cpu().numpy()
        worst = float(resid.max()) if len(resid) else 0.0
        scale = float(np.abs(theta).max()) if len(theta) else 1.0
        if best is None or worst < best[3]:
            best = (theta, U, resid, worst)
        if worst <= rtol_stop * scale or worst > 0.5 * prev:
            break
        prev = worst
    return best[0], best[1], best[2], rounds


def compute_mixed(solver, selection, maxit, tol, sorting) -> int:
    """Drive ``solver`` (a plain symmetric driver) in mixed precision.

    Returns nconv; stores (values, vectors, f64 residuals) on the solver
    for the accessors.
    """
    from spectra_tpu_torch.util.compinfo import CompInfo
    from spectra_tpu_torch.util.selection import argsort_np

    if tol < MIXED_TOL_FLOOR:
        raise ValueError(
            f"mixed precision accepts tol >= {MIXED_TOL_FLOOR:g} (f32 "
            "Lanczos residual floor ~ c*eps_f32*||A||); request "
            f"tol={tol:g} needs set_precision('double')"
        )
    op32 = cast_op_f32(solver._op)
    if op32 is None:
        raise ValueError(
            "mixed precision supports the dense/sparse MatProd "
            "operators (DenseSymMatProd, SparseSymMatProd); "
            f"got {type(solver._op).__name__}"
        )
    twin = type(solver)(op32, solver._nev, solver._ncv)
    # The f64 start vector cast to f32, as the JAX package casts it.
    twin.init(solver._v0.to(torch.float32))
    with full_f32_matmul():
        nconv32 = twin.compute(selection, maxit=maxit, tol=tol, sorting=sorting)
    solver._niter = twin.num_iterations()
    solver._nops = twin.num_operations()
    if nconv32 == 0:
        solver._info = twin.info()
        solver._mixed = (
            np.zeros(0),
            torch.zeros((solver._n_local, 0), dtype=solver._dtype, device=solver._device),
            np.zeros(0),
        )
        return 0
    U = twin.eigenvectors().to(torch.float64)
    theta, V, resid, solver._mixed_rounds = _refine_rounds(
        solver._op, U, selection, sorting
    )
    # Convergence gate on the re-measured f64 residuals: the f32
    # iteration cannot resolve relative gaps below ~eps_f32, and a
    # subspace it failed on must not be reported Successful (ARPACK's
    # test shape: resid <= tol * max(|theta|, ||Theta|| eps^{2/3})).
    scale = np.maximum(
        np.abs(theta),
        (np.abs(theta).max() if len(theta) else 1.0)
        * np.finfo(np.float32).eps ** (2.0 / 3.0),
    )
    conv = resid <= tol * scale
    keep = torch.from_numpy(np.flatnonzero(conv)).to(V.device)
    theta, V, resid = theta[conv], V[:, keep], resid[conv]
    order = np.asarray(argsort_np(sorting, theta))
    theta, resid = theta[order], resid[order]
    V = V[:, torch.from_numpy(order).to(V.device)]
    solver._mixed = (theta, V, resid)
    solver._info = (
        CompInfo.Successful if len(theta) == solver._nev
        else CompInfo.NotConverging
    )
    solver._nops += 3 * len(theta)
    return len(theta)
