"""Eigen-decomposition of the small upper Hessenberg H, on the host.

Port of :mod:`spectra_tpu.linalg.hessenberg_eigen` (reference:
include/Spectra/LinAlg/UpperHessenbergEigen.h:33-454). H is the
replicated (ncv, ncv) Rayleigh matrix of the Arnoldi process; the JAX
package bridges it to the host LAPACK (``numpy.linalg.eig``) on the CPU,
and so does the port, always: the same call, so for real H the
complex-conjugate pairs come out exactly conjugate and adjacent, the
property the restart's pairing logic relies on (reference:
GenEigsBase.h:55-56).

``SPECTRA_TPU_EIGEN_BACKEND`` = ``auto`` (the default) or ``lapack``
calls LAPACK; ``native`` routes to the Schur pipeline of
:mod:`spectra_tpu_torch.linalg.schur`, as in the JAX package.
"""

import os

import numpy as np


def hessenberg_eigen(H):
    """Eigenvalues and unit-norm eigenvectors of a Hessenberg matrix.

    Returns numpy ``(evals (m,), evecs (m, m))``, both complex; for real
    H complex-conjugate pairs are exact and adjacent."""
    backend = os.environ.get("SPECTRA_TPU_EIGEN_BACKEND", "auto")
    if backend not in ("auto", "lapack", "native"):
        raise ValueError(
            f"SPECTRA_TPU_EIGEN_BACKEND={backend!r}: use 'auto', 'lapack' "
            "or 'native'"
        )
    H = np.asarray(H)
    if backend == "native":
        from spectra_tpu_torch.linalg.schur import hessenberg_eigen_native

        return hessenberg_eigen_native(H)
    cdtype = np.result_type(H.dtype, np.complex64)
    w, v = np.linalg.eig(H)
    return w.astype(cdtype, copy=False), v.astype(cdtype, copy=False)
