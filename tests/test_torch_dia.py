"""The port's DIA/ELL formats and DIA SpMV against the JAX package.

The port runs on the CPU, so ``dia_spmv`` takes its plain version; the
JAX kernel runs as ``tests/test_pallas_ops.py`` runs it
(``interpret=True``). Tolerances: atol 1e-5 in f32 and 1e-12 in f64,
as in ``test_pallas_ops.py``; 1e-12 for the other methods. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu.ops import dia_spmv_pallas
from spectra_tpu.sparse import formats as jf
from spectra_tpu_torch.convert import dia_from_numpy, ell_from_numpy
from spectra_tpu_torch.matop.sparse import SparseSymMatProd
from spectra_tpu_torch.ops import dia_spmv as dmod
from spectra_tpu_torch.sparse import formats as pf

torch.set_num_threads(1)


def _laplacian_2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _unaligned(n=777):
    return sps.diags(
        [np.ones(n - 3), 2.0 + np.arange(n), -np.ones(n - 1)], [-3, 0, 1]
    ).tocsr()


def _banded(n_rows, n_cols, offsets, seed):
    rng = np.random.default_rng(seed)
    diags = [rng.normal(size=n_rows) for _ in offsets]
    return sps.diags(diags, offsets, shape=(n_rows, n_cols)).tocsr()


def _pair(A, dtype=None):
    """The JAX DiaMatrix and the port's, built from the same arrays."""
    jd = jf.dia_from_scipy(A, dtype=dtype)
    pd = dia_from_numpy(
        np.asarray(jd.data), jd.offsets, jd.n_rows, jd.n_cols, device="cpu"
    )
    return jd, pd


@pytest.mark.parametrize(
    "case, dtype",
    [("lap24", np.float32), ("lap24", np.float64), ("n777", np.float64)],
)
def test_dia_spmv_matches_pallas_and_jax(case, dtype):
    A = _laplacian_2d(24) if case == "lap24" else _unaligned()
    jd, pd = _pair(A, dtype)
    x = np.random.default_rng(0).normal(size=A.shape[1]).astype(dtype)
    want_pallas = np.asarray(
        dia_spmv_pallas(jd.data, jd.offsets, jnp.asarray(x), chunk=1024,
                        interpret=True)
    )
    want_jax = np.asarray(jd.matvec(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    plain = dmod.dia_spmv_plain(pd.data, pd.offsets, xt, pd.n_cols).numpy()
    got = pd.matvec(xt).numpy()
    atol = 1e-5 if dtype == np.float32 else 1e-12
    for y in (plain, got):
        assert y.dtype == dtype
        np.testing.assert_allclose(y, want_pallas, atol=atol)
        np.testing.assert_allclose(y, want_jax, atol=atol)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("shape", [(777, 777), (40, 55), (55, 40)])
def test_dia_methods_match_jax(shape):
    n_rows, n_cols = shape
    A = (
        _unaligned()
        if shape == (777, 777)
        else _banded(n_rows, n_cols, (-7, -1, 0, 2, 9), seed=3)
    )
    jd, pd = _pair(A)
    rng = np.random.default_rng(1)
    x = rng.normal(size=n_cols)
    X = rng.normal(size=(n_cols, 4))
    u = rng.normal(size=n_rows)
    tol = dict(atol=1e-12, rtol=0)
    y = pd.matvec(torch.from_numpy(x)).numpy()
    Y = pd.matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(y, A @ x, **tol)
    np.testing.assert_allclose(Y, A @ X, **tol)
    if n_rows <= n_cols:
        # For n_rows > n_cols the JAX package's dynamic_slice clamps its
        # start index and shifts the product (ROADMAP.md section 3).
        np.testing.assert_allclose(y, np.asarray(jd.matvec(x)), **tol)
        np.testing.assert_allclose(Y, np.asarray(jd.matmat(X)), **tol)
    np.testing.assert_allclose(
        pd.rmatvec(torch.from_numpy(u)).numpy(), np.asarray(jd.rmatvec(u)),
        **tol,
    )
    np.testing.assert_allclose(
        pd.diagonal().numpy(), np.asarray(jd.diagonal()), **tol
    )
    np.testing.assert_allclose(
        pd.to_dense().numpy(), np.asarray(jd.to_dense()), **tol
    )
    np.testing.assert_allclose(pd.to_dense().numpy(), A.toarray(), **tol)
    for i, j in [(0, 0), (5, 6), (9, 2), (10, 1), (3, 30)]:
        assert float(pd.element(i, j)) == float(jd.element(i, j))


def test_matmat_columns_equal_matvecs():
    _, pd = _pair(_laplacian_2d(12))
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(144, 6)))
    Y = pd.matmat(X)
    for c in range(6):
        np.testing.assert_array_equal(
            Y[:, c].numpy(), pd.matvec(X[:, c].contiguous()).numpy()
        )


def test_ell_matches_jax():
    A = sps.random(60, 45, density=0.1, random_state=4, format="csr")
    je = jf.ell_from_scipy(A)
    pe = ell_from_numpy(
        np.asarray(je.cols), np.asarray(je.vals), je.n_rows, je.n_cols,
        device="cpu",
    )
    rng = np.random.default_rng(5)
    x = rng.normal(size=45)
    X = rng.normal(size=(45, 3))
    u = rng.normal(size=60)
    tol = dict(atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        pe.matvec(torch.from_numpy(x)).numpy(), np.asarray(je.matvec(x)), **tol
    )
    np.testing.assert_allclose(
        pe.matmat(torch.from_numpy(X)).numpy(), np.asarray(je.matmat(X)), **tol
    )
    np.testing.assert_allclose(
        pe.rmatvec(torch.from_numpy(u)).numpy(), np.asarray(je.rmatvec(u)),
        **tol,
    )
    np.testing.assert_allclose(
        pe.diagonal().numpy(), np.asarray(je.diagonal()), **tol
    )
    np.testing.assert_allclose(pe.to_dense().numpy(), A.toarray(), **tol)
    i, j = int(A.nonzero()[0][0]), int(A.nonzero()[1][0])
    assert float(pe.element(i, j)) == float(je.element(i, j))


def test_ell_host_converters_match_jax():
    A = sps.random(30, 30, density=0.2, random_state=6, format="csr")
    for jm, pm in [
        (jf.ell_from_scipy(A), pf.ell_from_scipy(A, device="cpu")),
        (jf.ell_from_dense(A.toarray()),
         pf.ell_from_dense(A.toarray(), device="cpu")),
    ]:
        np.testing.assert_array_equal(pm.cols.numpy(), np.asarray(jm.cols))
        np.testing.assert_array_equal(pm.vals.numpy(), np.asarray(jm.vals))


@pytest.mark.parametrize("case", ["laplacian", "banded", "rectangular"])
def test_dia_from_scipy_matches_jax(case):
    A = {
        "laplacian": lambda: _laplacian_2d(20),
        "banded": lambda: _banded(300, 300, (-40, -3, 0, 1, 17), seed=7),
        "rectangular": lambda: _banded(50, 70, (-5, 0, 12), seed=8),
    }[case]()
    jd = jf.dia_from_scipy(A)
    pd = pf.dia_from_scipy(A, device="cpu")
    assert pd.offsets == tuple(jd.offsets)
    assert (pd.n_rows, pd.n_cols) == (jd.n_rows, jd.n_cols)
    np.testing.assert_array_equal(pd.data.numpy(), np.asarray(jd.data))
    assert pf.dia_suitability(A) == jf.dia_suitability(A)
    f32 = pf.dia_from_scipy(A, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32


def test_symmetrize_matches_jax():
    A = sps.random(40, 40, density=0.15, random_state=9, format="csr")
    for uplo in ("L", "U"):
        want = jf.symmetrize_scipy(A, uplo).toarray()
        np.testing.assert_array_equal(
            pf.symmetrize_scipy(A, uplo).toarray(), want
        )


def test_format_routing():
    lap = _laplacian_2d(10)
    assert isinstance(
        SparseSymMatProd.from_full(lap, device="cpu").ell, pf.DiaMatrix
    )
    rnd = sps.random(50, 50, density=0.3, random_state=1)
    rnd = (rnd + rnd.T).tocsr()
    assert isinstance(
        SparseSymMatProd.from_full(rnd, device="cpu").ell, pf.EllMatrix
    )
    hilo = SparseSymMatProd.from_full(lap, format="dia_hilo", device="cpu").ell
    assert isinstance(hilo, pf.DiaHiLoMatrix)
    # "auto" never routes to hi/lo planes on the CPU
    assert isinstance(
        SparseSymMatProd.from_full(lap, format="auto", device="cpu").ell,
        pf.DiaMatrix,
    )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    data = torch.ones((3, 10), dtype=torch.float64)
    x = torch.ones(10, dtype=torch.float64)
    dmod.dia_spmv(data, (-1, 0, 1), x, 10)
    with pytest.raises(TypeError):
        dmod.dia_spmv(data, (-1, 0, 1), x.float(), 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0), x, 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0, 1), torch.ones(9, dtype=torch.float64), 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0, 1), torch.ones((10, 4)).double().mT, 10)
    many = tuple(range(dmod.MAX_DIAGS + 1))
    with pytest.raises(ValueError):
        dmod.dia_spmv(torch.ones((len(many), 10)).double(), many, x, 10)


def test_cpu_path_launches_no_kernel():
    before = dmod.LAUNCHES
    _, pd = _pair(_laplacian_2d(8))
    pd.matvec(torch.ones(64, dtype=torch.float64))
    assert dmod.LAUNCHES == before
