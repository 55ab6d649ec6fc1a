"""ctypes binding of the native dense Krylov-Schur driver.

Port of :mod:`spectra_tpu.native.dense_eigs` (:20-112). The library is
the port's own copy of the C++ source, ``csrc/dense_eigs.cpp``, built
by ``g++`` on first use into ``build/spectra_tpu_torch/``
(:mod:`spectra_tpu_torch.ops._build`). BLAS/LAPACK function pointers
are taken from scipy's ``cython_blas``/``cython_lapack`` capsules when
it is loaded, so the library links no BLAS and uses the one scipy and
ARPACK use.

Unlike the JAX package's loader, which marks a failed build and lets
the caller fall back without a word, a build or load failure here
raises, with the compiler's output.
"""

import ctypes
import threading

import numpy as np

#: The driver's return code when its BLAS/LAPACK pointers were never set.
NOT_INITIALIZED = -100

_lock = threading.Lock()
_lib = None


def _capsule_ptr(module, name):
    cap = module.__pyx_capi__[name]
    get_name = ctypes.pythonapi.PyCapsule_GetName
    get_name.restype = ctypes.c_char_p
    get_name.argtypes = [ctypes.py_object]
    get_ptr = ctypes.pythonapi.PyCapsule_GetPointer
    get_ptr.restype = ctypes.c_void_p
    get_ptr.argtypes = [ctypes.py_object, ctypes.c_char_p]
    return get_ptr(cap, get_name(cap))


def load() -> ctypes.CDLL:
    """The initialized library, built on first use; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from scipy.linalg import cython_blas, cython_lapack

            from spectra_tpu_torch.ops import _build

            lib = _build.load("dense_eigs")
            fns = (ctypes.c_void_p * 8)(
                _capsule_ptr(cython_blas, "dgemv"),
                _capsule_ptr(cython_blas, "dgemm"),
                _capsule_ptr(cython_blas, "ddot"),
                _capsule_ptr(cython_blas, "dnrm2"),
                _capsule_ptr(cython_lapack, "dgees"),
                _capsule_ptr(cython_lapack, "dtrsen"),
                _capsule_ptr(cython_lapack, "dsyev"),
                _capsule_ptr(cython_lapack, "dtrevc"),
            )
            lib.spectra_dense_eigs_init.restype = None
            lib.spectra_dense_eigs_init.argtypes = [ctypes.c_void_p * 8]
            lib.spectra_dense_eigs_init(fns)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.spectra_dense_eigs.restype = ctypes.c_int
            lib.spectra_dense_eigs.argtypes = [
                f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_int, f64p,
                f64p, f64p, f64p, f64p, i64p,
            ]
            lib.spectra_nev_adjusted.restype = ctypes.c_int
            lib.spectra_nev_adjusted.argtypes = [
                f64p, f64p, f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            _lib = lib
    return _lib


def _p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dense_eigs(A, nev, ncv, rule: int, sym: bool, tol: float, maxit: int, v0):
    """Run the native Krylov-Schur solve on the host.

    Returns ``(rc, result)``: ``rc`` is the driver's return code (0, or
    -1 to -5 for a numerical failure) and ``result`` a dict of the
    values, vectors, Ritz estimates and counts, or ``None`` when ``rc``
    is not 0. Raises when the driver reports that it was never
    initialized."""
    lib = load()
    A = np.ascontiguousarray(A, np.float64)
    v0 = np.ascontiguousarray(v0, np.float64)
    n = A.shape[0]
    evals_re = np.empty(ncv, np.float64)
    evals_im = np.empty(ncv, np.float64)
    evecs = np.empty((nev, n), np.complex128)  # (re, im) interleaved
    est = np.empty(nev, np.float64)
    stats = np.zeros(3, np.int64)
    rc = lib.spectra_dense_eigs(
        _p(A), n, nev, ncv, rule, int(sym), tol, maxit, _p(v0),
        _p(evals_re), _p(evals_im), _p(evecs), _p(est),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == NOT_INITIALIZED:
        raise RuntimeError("the native dense driver was not initialized")
    if rc != 0:
        return rc, None
    return rc, {
        "values": evals_re[:nev] + 1j * evals_im[:nev],
        "vectors": evecs.T.copy(),  # (n, nev) complex
        "ritz_est": est,
        "nconv": int(stats[0]),
        "niter": int(stats[1]),
        "nops": int(stats[2]),
    }


def nev_adjusted(wr, wi, est, nconv: int, nev: int, ncv: int, sym: bool) -> int:
    """The driver's restart size (dsaup2.f 677-684 / dnaup2.f 660-674)
    for Ritz values ``wr + i wi`` and estimates ``est``."""
    arrays = [np.ascontiguousarray(a, np.float64) for a in (wr, wi, est)]
    return load().spectra_nev_adjusted(
        *(_p(a) for a in arrays), nconv, nev, ncv, int(sym)
    )
