"""Rayleigh-Ritz extraction for the Jacobi-Davidson solvers.

Port of :mod:`spectra_tpu.linalg.ritz_pairs` (reference:
include/Spectra/LinAlg/RitzPairs.h:23-126): from a search space V and
``W = A V`` form the projected matrix ``V^H W``, decompose it, and
assemble Ritz values, small-space vectors, Ritz vectors ``V s`` and
residues ``A V s - V s theta``. The products run on V's device; the
small Hermitian eigenproblem runs on the host (:func:`eigh_host`,
LAPACK through numpy, the routine the JAX package's CPU route calls),
on one BLAS thread below the order :data:`ONE_THREAD_BELOW`.

The values are a CPU f64 tensor; the small vectors, Ritz vectors and
residues lie on V's device.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from spectra_tpu_torch.linalg.jacobi import nan_eigenpairs
from spectra_tpu_torch.ops.gemv import col_norms
from spectra_tpu_torch.util import blas_threads
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.selection import SortRule, argsort

#: Orders below which :func:`eigh_host` holds numpy's BLAS pool to the
#: calling thread. np.linalg.eigh on an H100 host (8 cores, OpenBLAS
#: 0.3.30, pthreads), median ms on one thread / on the default eight
#: (a range where two runs measured it): order 110 1.24 / 1.33, 256
#: 6.39-7.54 / 7.29-8.67, 320 13.68 / 12.64, 384 25.67 / 21.19, 512
#: 37.0-39.5 / 31.3-34.7, 1024 276 / 164. Besides, the eight threads
#: still spinning after a call slowed the Davidson loop's next PyTorch
#: operations by about 10 ms (PERF.md, sections 5 and 6).
ONE_THREAD_BELOW = 320


class RitzPairs(NamedTuple):
    values: torch.Tensor  # (m,) Ritz values, on the host
    small_vectors: torch.Tensor  # (m, m) eigenvectors of the projected problem
    vectors: torch.Tensor  # (n, m) Ritz vectors V s
    residues: torch.Tensor  # (n, m) A V s - V s theta


def eigh_host(M):
    """``(w, s)`` of the Hermitian matrix M (a tensor anywhere) by LAPACK
    on the host: ascending eigenvalues and the eigenvectors as columns,
    CPU tensors. A matrix with a non-finite entry gives NaNs, as
    ``jnp.linalg.eigh`` does (numpy would raise), so that the solvers
    stop on it with ``NumericalIssue``. Below the order
    :data:`ONE_THREAD_BELOW` the call runs on one BLAS thread
    (:func:`blas_threads.one_thread`)."""
    M = M.detach().cpu()
    if not torch.isfinite(M).all():
        return nan_eigenpairs(M)
    small = M.shape[-1] < ONE_THREAD_BELOW
    with blas_threads.one_thread() if small else contextlib.nullcontext():
        w, s = np.linalg.eigh(M.numpy())
    return torch.from_numpy(w), torch.from_numpy(s)


def compute_eigen_pairs(V, W, mesh=None) -> RitzPairs:
    """Rayleigh-Ritz on span(V) with ``W = A V`` precomputed; for V and W
    holding a rank's rows of a row ``mesh``, ``V^H W`` summed over the
    ranks."""
    H = V.mH @ W
    H = (H if mesh is None else mesh.all_reduce(H)).cpu()
    with span("jd.eigh"):
        values, small = eigh_host(0.5 * (H + H.mH))
    small = small.to(V.device, V.dtype)
    vectors = V @ small
    residues = W @ small - vectors * values.to(V.device, V.dtype)[None, :]
    return RitzPairs(values, small, vectors, residues)


def sort(pairs: RitzPairs, selection: SortRule) -> RitzPairs:
    """The pairs, wanted first (RitzPairs.h:55-66)."""
    ind = argsort(selection, pairs.values)
    dev = ind.to(pairs.vectors.device)
    return RitzPairs(
        values=pairs.values[ind],
        small_vectors=pairs.small_vectors[:, dev],
        vectors=pairs.vectors[:, dev],
        residues=pairs.residues[:, dev],
    )


def convergence(pairs: RitzPairs, tol, nev: int, mesh=None):
    """Per-pair flags by residual column norm (over a row ``mesh``, the
    norm of the whole column), and whether all of the first ``nev``
    converged (RitzPairs.h:73-87)."""
    norms = col_norms(pairs.residues[:, :nev], mesh).cpu()
    flags = norms < tol
    return flags, bool(flags.all())
