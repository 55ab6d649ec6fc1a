"""The port's native host sparse toolkit (``spectra_tpu_torch/native``,
built from ``spectra_tpu_torch/csrc/sparse_kernels.cpp``) against the JAX
package's (``spectra_tpu.native``): the 8 cases of
``tests/test_native.py`` with scipy as ground truth, each helper also
held **bitwise** to the JAX package's on the same inputs (both libraries
are the same C++ built with the same flags), and the multigrid
hierarchy of the 3-D g=16 Laplacian bitwise equal to the one JAX's
``build_level_chain`` builds. A failing build raises.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.io import mmwrite

from spectra_tpu import native as jnative
from spectra_tpu_torch import native
from spectra_tpu_torch.ops import _build


def _rand_coo(n, nnz, seed=0, with_dups=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    if with_dups:
        rows[: nnz // 10] = rows[nnz // 2 : nnz // 2 + nnz // 10]
        cols[: nnz // 10] = cols[nnz // 2 : nnz // 2 + nnz // 10]
    return rows, cols, vals


def _lap2d(g):
    l1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), l1) + sps.kron(l1, sps.eye(g))).tocsr()


def _lap3d(g):
    l1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    e = sps.eye(g)
    return (
        sps.kron(sps.kron(l1, e), e) + sps.kron(sps.kron(e, l1), e)
        + sps.kron(sps.kron(e, e), l1)
    ).tocsr()


def _same(a, b):
    """Bitwise equality of two results (arrays, tuples, CSR matrices)."""
    if sps.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape
        for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        return
    if isinstance(a, tuple) and not isinstance(a[0], (int, np.integer)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, tuple):
        assert a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_native_available():
    """The port's library builds from its own source and loads."""
    lib = native.load()
    assert lib is native.load()
    assert _build._source("sparse_kernels") == _build.CSRC / "sparse_kernels.cpp"
    assert jnative.available()


def test_coo_to_csr_dedup():
    n, nnz = 50, 400
    rows, cols, vals = _rand_coo(n, nnz)
    indptr, indices, data = out = native.coo_to_csr(n, rows, cols, vals)
    ref = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(indices, ref.indices)
    np.testing.assert_allclose(data, ref.data, atol=1e-14)
    _same(out, jnative.coo_to_csr(n, rows, cols, vals))


def test_csr_to_ell_matches_python():
    n = 30
    rng = np.random.RandomState(1)
    A = sps.random(n, n, density=0.2, random_state=rng, format="csr")
    cols, vals = native.csr_to_ell(
        n, A.indptr.astype(np.int64), A.indices.astype(np.int64), A.data
    )
    from spectra_tpu.sparse.formats import _ell_arrays_from_csr

    pc, pv = _ell_arrays_from_csr(A.indptr, A.indices, A.data, n)
    np.testing.assert_array_equal(cols, pc)
    np.testing.assert_allclose(vals, pv)
    _same((cols, vals), jnative.csr_to_ell(
        n, A.indptr.astype(np.int64), A.indices.astype(np.int64), A.data))
    _same(native.csr_to_ell(n, A.indptr, A.indices, A.data, pad_width=12),
          jnative.csr_to_ell(n, A.indptr, A.indices, A.data, pad_width=12))


def test_csr_to_dia_roundtrip():
    g = 12
    A = _lap2d(g)
    offsets, data = out = native.csr_to_dia(
        A.shape[0], A.shape[1], A.indptr.astype(np.int64),
        A.indices.astype(np.int64), A.data,
    )
    assert offsets == (-g, -1, 0, 1, g)
    D = np.zeros(A.shape)
    for k, off in enumerate(offsets):
        i = np.arange(A.shape[0])
        j = i + off
        ok = (j >= 0) & (j < A.shape[1])
        D[i[ok], j[ok]] = data[k, ok]
    np.testing.assert_allclose(D, A.toarray())
    _same(out, jnative.csr_to_dia(A.shape[0], A.shape[1], A.indptr, A.indices, A.data))
    # a rectangular matrix with random data
    R = sps.random(40, 55, density=0.1, random_state=2, format="csr")
    _same(native.csr_to_dia(40, 55, R.indptr, R.indices, R.data),
          jnative.csr_to_dia(40, 55, R.indptr, R.indices, R.data))


def test_rowpart_halo():
    g = 16
    A = _lap2d(g)
    counts = native.rowpart_halo(
        g * g, A.indptr.astype(np.int64), A.indices.astype(np.int64), 4
    )
    assert counts[0] == g and counts[-1] == g
    assert all(c == 2 * g for c in counts[1:-1])
    _same(counts, jnative.rowpart_halo(g * g, A.indptr, A.indices, 4))
    R = sps.random(300, 300, density=0.02, random_state=3, format="csr")
    _same(native.rowpart_halo(300, R.indptr, R.indices, 7),
          jnative.rowpart_halo(300, R.indptr, R.indices, 7))


def test_matrix_market_roundtrip(tmp_path):
    rng = np.random.RandomState(7)
    A = sps.random(40, 30, density=0.15, random_state=rng, format="coo")
    path = tmp_path / "m.mtx"
    mmwrite(str(path), A)
    B = native.read_matrix_market(str(path))
    np.testing.assert_allclose(B.toarray(), A.toarray(), atol=1e-12)
    _same(B, jnative.read_matrix_market(str(path)))


def test_matrix_market_symmetric(tmp_path):
    rng = np.random.RandomState(8)
    A = sps.random(25, 25, density=0.2, random_state=rng, format="coo")
    S = (A + A.T).tocoo()
    path = tmp_path / "s.mtx"
    mmwrite(str(path), S, symmetry="symmetric")
    B = native.read_matrix_market(str(path))
    np.testing.assert_allclose(B.toarray(), S.toarray(), atol=1e-12)
    _same(B, jnative.read_matrix_market(str(path)))


def test_laplacian2d_dia_generator():
    g = 10
    offsets, data = out = native.laplacian2d_dia(g)
    from spectra_tpu_torch.sparse.formats import DiaMatrix

    dia = DiaMatrix(
        data=torch.from_numpy(data), offsets=offsets, n_rows=g * g, n_cols=g * g
    )
    np.testing.assert_allclose(dia.to_dense().numpy(), _lap2d(g).toarray())
    _same(out, jnative.laplacian2d_dia(g))


@pytest.mark.parametrize("shape", [(70, 50, 90), (300, 300, 300), (1, 4, 1)])
def test_spgemm_and_matvec_bitwise_jax(shape):
    """The threaded product and matvec: within 1e-13 of scipy's and
    bitwise the JAX package's."""
    m, k, n = shape
    A = sps.random(m, k, density=0.1, random_state=4, format="csr")
    B = sps.random(k, n, density=0.1, random_state=5, format="csr")
    C = native.spgemm(A, B)
    ref = (A @ B).toarray()
    np.testing.assert_allclose(C.toarray(), ref, rtol=0, atol=1e-13)
    _same(C, jnative.spgemm(A, B))
    x = np.random.default_rng(6).normal(size=k)
    y = native.csr_matvec_builder(A)(x)
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-13)
    _same(y, jnative.csr_matvec_builder(A)(x))


def test_galerkin_rap_bitwise_jax():
    from spectra_tpu_torch.linalg.multigrid import prolong_matrix

    A = _lap3d(12)
    P = prolong_matrix((12, 12, 12), "clip")
    C = native.galerkin_rap(A, P)
    np.testing.assert_allclose(C.toarray(), (P.T @ (A @ P)).toarray(), rtol=0, atol=1e-13)
    _same(C, jnative.galerkin_rap(A, P))


def test_hierarchy_g16_bitwise_jax():
    """The MG hierarchy of the 3-D g=16 Laplacian (shifted by 0.3): every
    level's CSR, inverse diagonal and ``lam``, and the coarse inverse,
    bitwise the JAX package's ``build_level_chain``."""
    from spectra_tpu.linalg import multigrid as jmg
    from spectra_tpu_torch.linalg import multigrid as pmg

    A = (_lap3d(16) - 0.3 * sps.eye(16 ** 3)).tocsr()
    csr, dims, boundary = pmg.resolve_grid(A)
    jcsr, jdims, jboundary = jmg.resolve_grid(A)
    assert (dims, boundary) == (jdims, jboundary) == ((16, 16, 16), "clip")
    levels, cinv, dpl = pmg.build_level_chain(csr, dims, boundary, max_coarse_n=64)
    jlevels, jcinv, jdpl = jmg.build_level_chain(jcsr, jdims, jboundary, max_coarse_n=64)
    assert len(levels) == len(jlevels) == 2 and dpl == jdpl
    for lv, jlv in zip(levels, jlevels):
        _same(lv["csr"], jlv["csr"])
        _same(lv["inv_diag"], jlv["inv_diag"])
        assert lv["lam"] == jlv["lam"] and lv["dims"] == jlv["dims"]
    _same(cinv, jcinv)


def test_failing_build_raises(monkeypatch):
    """A library that does not build raises with the compiler's output;
    nothing falls back to scipy."""
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    A = _lap2d(4)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on sparse_kernels.cpp"):
        native.csr_to_dia(16, 16, A.indptr, A.indices, A.data)
    from spectra_tpu_torch.sparse.formats import dia_from_scipy

    with pytest.raises(RuntimeError, match="g\\+\\+ failed on sparse_kernels.cpp"):
        dia_from_scipy(A, device="cpu")
