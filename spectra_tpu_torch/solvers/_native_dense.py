"""Routing: small dense f64 problems to the native driver.

Port of :mod:`spectra_tpu.solvers._native_dense` (:51-130). A dense
solve at n in the hundreds or thousands is bound by the per-operation
cost of the restart machinery, which on the card is a launch and a
host read each; the native Krylov-Schur driver
(:mod:`spectra_tpu_torch.native.dense_eigs`) runs the whole iteration
on the host at BLAS/LAPACK speed. The route is the reference's: a real
f64 ``DenseSymMatProd`` or ``DenseGenMatProd``, n <= 8192, no B, no
Ritz transform, no restart chunk, no resumed checkpoint, and never a
deflated round of ``compute_locked`` (the driver has no deflation).

``SPECTRA_TPU_DENSE_DRIVER`` overrides: ``auto`` (the default),
``native`` (also above n = 8192) or ``torch`` (the IRLM on the
operator's device, the JAX package's ``jax``).

``sym`` picks the symmetric leg (an ``IRLMResult``) or the general
one (an ``IRAMResult`` with complex values and vectors).

A build failure raises (:func:`~spectra_tpu_torch.native.dense_eigs.load`).
A numerical failure of the driver (return codes -1 to -5) is never
silent: it prints one line to stderr, adds one to :data:`FALLBACKS`,
and the solve runs again on the IRLM or IRAM, as in the reference.
"""

import os
import sys

import numpy as np
import torch

from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.selection import SortRule, argsort_np

#: Larger problems stay on the IRLM unless the driver is ``native``.
_MAX_N = 8192

#: Native solves that failed numerically and ran again on the IRLM/IRAM.
FALLBACKS = 0

_MISSING = object()


def driver() -> str:
    """``SPECTRA_TPU_DENSE_DRIVER``: ``auto``, ``native`` or ``torch``."""
    mode = os.environ.get("SPECTRA_TPU_DENSE_DRIVER", "auto")
    if mode not in ("auto", "native", "torch"):
        raise ValueError(
            f"SPECTRA_TPU_DENSE_DRIVER={mode!r}: use 'auto', 'native' or 'torch'"
        )
    return mode


def _cached_mat(solver):
    """Host copy of the dense operator's matrix, read once per solver
    (the matrix never changes after construction), or None for any
    other operator."""
    mat = getattr(solver, "_native_mat_cache", _MISSING)
    if mat is _MISSING:
        from spectra_tpu_torch.matop.dense import DenseGenMatProd, DenseSymMatProd

        op = solver._op
        mat = (
            op.mat.detach().cpu().numpy()
            if isinstance(op, (DenseSymMatProd, DenseGenMatProd)) else None
        )
        solver._native_mat_cache = mat
    return mat


def eligible(solver, sym: bool = True) -> bool:
    mode = driver()
    if mode == "torch":
        return False
    if solver._restart_chunk is not None:
        return False
    if solver._resume_carry is not None:
        return False
    if type(solver)._ritz_transform is not None:
        return False
    if solver._has_bop:
        return False
    if solver._locking_round:
        return False
    mat = _cached_mat(solver)
    if mat is None or mat.dtype != np.float64 or mat.ndim != 2:
        return False
    return mat.shape[0] <= _MAX_N or mode == "native"


def compute(solver, sym: bool, selection: SortRule, maxit, tol, sorting):
    """Run the native driver; returns an ``IRLMResult`` (``sym``) or an
    ``IRAMResult`` with the eigenvectors on the operator's device, or
    None after a numerical failure (the caller then runs the IRLM or
    IRAM)."""
    global FALLBACKS
    from spectra_tpu_torch.native import dense_eigs as nd

    mat = _cached_mat(solver)
    v0 = solver._v0_host
    if v0 is None:
        v0 = solver._v0.detach().cpu().numpy()
    nev = solver._nev
    rc, out = nd.dense_eigs(
        mat, nev, solver._ncv, selection.value, sym, float(tol), int(maxit),
        np.asarray(v0, np.float64),
    )
    if out is None:
        FALLBACKS += 1
        print(
            f"[native dense driver] return code {rc}: the solve runs again "
            f"on the {'IRLM' if sym else 'IRAM'}",
            file=sys.stderr,
        )
        return None
    values, vectors = out["values"], out["vectors"]
    if sym:
        values, vectors = values.real, vectors.real
    conv = out["ritz_est"] < float(tol) * np.maximum(
        dtypes.eps23(torch.float64), np.abs(values)
    )
    ind = argsort_np(sorting, values)
    values, vectors, conv = values[ind], vectors[:, ind], conv[ind]
    device = solver._device
    V = torch.from_numpy(vectors.T.copy()).to(device)
    f = torch.zeros(mat.shape[0], dtype=V.dtype, device=device)
    if sym:
        from spectra_tpu_torch.solvers._herm_core import IRLMResult

        return IRLMResult(
            values=torch.from_numpy(values), vectors_small=torch.eye(nev, dtype=torch.float64),
            conv=torch.from_numpy(conv), nconv=out["nconv"], niter=out["niter"],
            nops=out["nops"], V=V, f=f,
        )
    from spectra_tpu_torch.solvers._gen_core import IRAMResult

    return IRAMResult(
        values=values, vectors_small=np.eye(nev, dtype=np.complex128), conv=conv,
        nconv=out["nconv"], niter=out["niter"], nops=out["nops"], V=V, f=f,
    )
