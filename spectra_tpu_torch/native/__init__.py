"""Host (C++) code of the port: the native sparse toolkit, and the
native dense Krylov-Schur driver (:mod:`spectra_tpu_torch.native.dense_eigs`).

Port of the helpers of :mod:`spectra_tpu.native` (:119-353): COO->CSR
assembly with duplicate summing, CSR->ELL and CSR->DIA conversion, the
row-partition halo census, a Matrix Market reader, a direct-to-DIA 2-D
Laplacian, and the threaded CSR product (:func:`spgemm`,
:func:`galerkin_rap`) and matvec (:func:`csr_matvec_builder`) behind the
multigrid hierarchy build. The library is the port's own copy of the
C++ source, ``csrc/sparse_kernels.cpp``, built by ``g++`` on first use
into ``build/spectra_tpu_torch/`` (:mod:`spectra_tpu_torch.ops._build`).

The JAX package's loader returns ``None`` when the build fails, and each
helper then runs numpy or scipy without a word. Here a build or load
failure raises, with the compiler's output. The one path to scipy is a
choice of format: the reader hands a complex or otherwise unsupported
``.mtx`` file to ``scipy.io.mmread``, as the JAX package does.
"""

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The sparse toolkit's library, built on first use; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from spectra_tpu_torch.ops import _build

            lib = _build.load("sparse_kernels")
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            sigs = {
                "spectra_coo_to_csr": (i64, [i64, i64, i64p, i64p, f64p, i64p, i64p, f64p]),
                "spectra_csr_to_ell": (i64, [i64, i64p, i64p, f64p, i64, i32p, f64p]),
                "spectra_csr_diagonals": (i64, [i64, i64p, i64p, i64, i64p]),
                "spectra_csr_to_dia": (None, [i64, i64p, i64p, f64p, i64, i64p, f64p]),
                "spectra_rowpart_halo": (i64, [i64, i64p, i64p, i64, i64p]),
                "spectra_read_matrix_market": (i64, [ctypes.c_char_p, i64p, i64p, i64p, f64p]),
                "spectra_laplacian2d_dia": (None, [i64, f64p, i64p]),
                "spectra_spgemm_nnz": (None, [i64, i64, i64p, i32p, i64p, i32p, i64p]),
                "spectra_spgemm_fill": (
                    None, [i64, i64, i64p, i32p, f64p, i64p, i32p, f64p, i64p, i32p, f64p],
                ),
                "spectra_csr_matvec": (None, [i64, i64p, i32p, f64p, f64p, f64p]),
            }
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def _f64(a):
    return np.ascontiguousarray(a, np.float64)


def coo_to_csr(n_rows, rows, cols, vals):
    """CSR ``(indptr, indices, data)`` from COO, duplicates summed and
    each row's columns sorted."""
    rows, cols, vals = _i64(rows), _i64(cols), _f64(vals)
    nnz = len(rows)
    lib = load()
    indptr = np.empty(n_rows + 1, np.int64)
    indices = np.empty(nnz, np.int64)
    data = np.empty(nnz, np.float64)
    out = lib.spectra_coo_to_csr(
        n_rows, nnz, _p(rows, ctypes.c_int64), _p(cols, ctypes.c_int64),
        _p(vals, ctypes.c_double), _p(indptr, ctypes.c_int64),
        _p(indices, ctypes.c_int64), _p(data, ctypes.c_double),
    )
    return indptr, indices[:out].copy(), data[:out].copy()


def csr_to_ell(n_rows, indptr, indices, data, pad_width=0):
    """Padded ELL ``(cols int32, vals float64)``, each (n_rows, L), from
    CSR arrays; L is the widest row (at least 1 and ``pad_width``)."""
    indptr, indices, data = _i64(indptr), _i64(indices), _f64(data)
    lib = load()
    args = (
        n_rows, _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
        _p(data, ctypes.c_double), pad_width,
    )
    L = lib.spectra_csr_to_ell(*args, None, None)
    cols = np.zeros((n_rows, L), np.int32)
    vals = np.zeros((n_rows, L), np.float64)
    lib.spectra_csr_to_ell(*args, _p(cols, ctypes.c_int32), _p(vals, ctypes.c_double))
    return cols, vals


def csr_to_dia(n_rows, n_cols, indptr, indices, data):
    """Row-aligned DIA ``(offsets tuple, data (d, n_rows))`` from CSR:
    ``data[k, i] = A[i, i + offsets[k]]``, offsets ascending."""
    indptr, indices, data = _i64(indptr), _i64(indices), _f64(data)
    lib = load()
    offsets = np.empty(n_rows + n_cols - 1, np.int64)
    nd = lib.spectra_csr_diagonals(
        n_rows, _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
        n_cols, _p(offsets, ctypes.c_int64),
    )
    offsets = np.ascontiguousarray(offsets[:nd])
    out = np.zeros((nd, n_rows), np.float64)
    lib.spectra_csr_to_dia(
        n_rows, _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
        _p(data, ctypes.c_double), nd, _p(offsets, ctypes.c_int64),
        _p(out, ctypes.c_double),
    )
    return tuple(int(o) for o in offsets), out


def rowpart_halo(n_rows, indptr, indices, n_parts):
    """Per-partition halo sizes (distinct remote x entries) of an equal
    row partition into ``n_parts``: the communication-volume planner."""
    indptr, indices = _i64(indptr), _i64(indices)
    counts = np.empty(n_parts, np.int64)
    load().spectra_rowpart_halo(
        n_rows, _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int64),
        n_parts, _p(counts, ctypes.c_int64),
    )
    return counts


def read_matrix_market(path):
    """Read a real, integer or pattern coordinate ``.mtx`` file (general,
    symmetric or skew-symmetric) into a scipy CSR matrix; a complex or
    other unsupported file goes to ``scipy.io.mmread``."""
    import scipy.sparse as sps

    lib = load()
    path = str(path)
    shape = np.empty(2, np.int64)
    n = lib.spectra_read_matrix_market(
        path.encode(), _p(shape, ctypes.c_int64), None, None, None
    )
    if n == -2:
        from scipy.io import mmread

        return mmread(path).tocsr()
    if n < 0:
        raise IOError(f"failed to parse Matrix Market file {path!r}")
    rows = np.empty(n, np.int64)
    cols = np.empty(n, np.int64)
    vals = np.empty(n, np.float64)
    lib.spectra_read_matrix_market(
        path.encode(), _p(shape, ctypes.c_int64),
        _p(rows, ctypes.c_int64), _p(cols, ctypes.c_int64),
        _p(vals, ctypes.c_double),
    )
    indptr, indices, data = coo_to_csr(int(shape[0]), rows, cols, vals)
    return sps.csr_matrix(
        (data, indices.astype(np.int32), indptr.astype(np.int32)),
        shape=(int(shape[0]), int(shape[1])),
    )


def laplacian2d_dia(g: int):
    """``(offsets, data)`` of the g x g grid Laplacian (5-point), direct
    to row-aligned DIA."""
    n = g * g
    data = np.empty((5, n), np.float64)
    offsets = np.empty(5, np.int64)
    load().spectra_laplacian2d_dia(
        g, _p(data, ctypes.c_double), _p(offsets, ctypes.c_int64)
    )
    return tuple(int(o) for o in offsets), data


def _csr_arrays(M):
    return (
        np.ascontiguousarray(M.indptr, np.int64),
        np.ascontiguousarray(M.indices, np.int32),
        np.ascontiguousarray(M.data, np.float64),
    )


def spgemm(A, B):
    """``C = A @ B`` for scipy sparse matrices, by the threaded Gustavson
    product: a scipy CSR matrix with sorted rows."""
    import scipy.sparse as sps

    lib = load()
    A = A.tocsr()
    B = B.tocsr()
    n_rows, n_mid = A.shape
    n_mid2, n_cols = B.shape
    if n_mid != n_mid2:
        raise ValueError(f"shapes {A.shape} and {B.shape} do not chain")
    Ap, Aj, Ax = _csr_arrays(A)
    Bp, Bj, Bx = _csr_arrays(B)
    row_nnz = np.empty(n_rows, np.int64)
    lib.spectra_spgemm_nnz(
        n_rows, n_cols, _p(Ap, ctypes.c_int64), _p(Aj, ctypes.c_int32),
        _p(Bp, ctypes.c_int64), _p(Bj, ctypes.c_int32),
        _p(row_nnz, ctypes.c_int64),
    )
    Cp = np.empty(n_rows + 1, np.int64)
    Cp[0] = 0
    np.cumsum(row_nnz, out=Cp[1:])
    nnz = int(Cp[-1])
    Cj = np.empty(nnz, np.int32)
    Cx = np.empty(nnz, np.float64)
    lib.spectra_spgemm_fill(
        n_rows, n_cols, _p(Ap, ctypes.c_int64), _p(Aj, ctypes.c_int32),
        _p(Ax, ctypes.c_double), _p(Bp, ctypes.c_int64),
        _p(Bj, ctypes.c_int32), _p(Bx, ctypes.c_double),
        _p(Cp, ctypes.c_int64), _p(Cj, ctypes.c_int32),
        _p(Cx, ctypes.c_double),
    )
    return sps.csr_matrix((Cx, Cj, Cp), shape=(n_rows, n_cols))


def galerkin_rap(A, P):
    """The Galerkin coarse operator ``P^T (A P)``, two threaded
    products."""
    AP = spgemm(A, P)
    Pt = P.T.tocsr()
    return spgemm(Pt, AP)


def csr_matvec_builder(A):
    """A threaded ``x -> A @ x`` over the CSR of ``A`` (numpy f64 in and
    out): the hierarchy build's power iteration."""
    lib = load()
    A = A.tocsr()
    n_rows = A.shape[0]
    Ap, Aj, Ax = _csr_arrays(A)

    def mv(x):
        x = _f64(x)
        y = np.empty(n_rows, np.float64)
        lib.spectra_csr_matvec(
            n_rows, _p(Ap, ctypes.c_int64), _p(Aj, ctypes.c_int32),
            _p(Ax, ctypes.c_double), _p(x, ctypes.c_double),
            _p(y, ctypes.c_double),
        )
        return y

    return mv
