"""Ritz pairs and the host eigh of the Jacobi-Davidson solvers.

Port of :mod:`spectra_tpu.linalg.ritz_pairs` (reference:
include/Spectra/LinAlg/RitzPairs.h:23-126). The Rayleigh-Ritz step
itself is :func:`spectra_tpu_torch.solvers._jd_core._rayleigh_ritz`;
here are the pairs it hands on (:class:`RitzPairs`) and its small
Hermitian eigenproblem, which runs on the host (:func:`eigh_host`,
LAPACK through numpy, the routine the JAX package's CPU route calls),
on one BLAS thread below the order :data:`ONE_THREAD_BELOW`. LOBPCG's
Gram eighs call it too.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from spectra_tpu_torch.linalg.jacobi import nan_eigenpairs
from spectra_tpu_torch.util import blas_threads

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
    values: torch.Tensor  # (m,) Ritz values: a result's on the host, a correction's on V's device
    vectors: torch.Tensor  # (n, m) Ritz vectors V s, on V's device
    residues: torch.Tensor  # (n, m) A V s - V s theta, on V's device


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
