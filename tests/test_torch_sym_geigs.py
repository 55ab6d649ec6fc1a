"""The port's generalized symmetric solvers against the JAX package, in
the five modes, on the CPU.

Every class of ``tests/test_sym_geigs.py`` (the mode x storage grid of
the reference's test/SymGEigs.cpp and test/SymGEigsShift.cpp), Example
115 of ``tests/test_regression_examples.py``, and config #5a's operator
(``scripts/tpu_generalized_1m.py``) at g=16. Each case builds its
matrices as the reference test does, runs both packages on them from the
same start vector, and holds the port to the JAX package: the same
``nconv``, ``CompInfo``, restart and operation counts, and eigenvalues
within 1e-10. The port is also held to the reference test's own checks
(``||A U - B U Lambda||_inf`` and ``scipy.linalg.eigh``).
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.util.geigsmode import GEigsMode as JMode
from spectra_tpu.util.rng import SimpleRandom
import spectra_tpu_torch as stt

torch.set_num_threads(1)

CPU = "cpu"


def _rand_sym(n, seed=123):
    rng = np.random.RandomState(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    return A + A.T


def _spd(n, seed=42):
    rng = np.random.RandomState(seed)
    M = rng.uniform(size=(n, n)) - 0.5
    B = (M + M.T) * 0.1
    np.fill_diagonal(B, np.abs(B).sum(axis=1) + 1.0)
    return B


def _sparse_sym(n, density=0.1, seed=123):
    rng = np.random.RandomState(seed)
    A = sps.random(n, n, density=density, random_state=rng, format="csr")
    return (A + A.T).tocsr()


def _sparse_spd(n, density=0.1, seed=42):
    B = _sparse_sym(n, density, seed) * 0.1
    d = np.abs(B).sum(axis=1).A1 + 1.0
    return (B + sps.diags(d)).tocsr()


def _grid_pair(g, aniso=1.37):
    """``tests/test_sym_geigs.py``'s grid pair: an (anisotropic) 2-D
    Laplacian and the FEM mass matrix ``kron(I, tridiag(1/6, 2/3, 1/6))``."""
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    A = (sps.kron(sps.eye(g), lap1) + aniso * sps.kron(lap1, sps.eye(g))).tocsr()
    m1 = sps.diags([1.0 / 6, 2.0 / 3, 1.0 / 6], [-1, 0, 1], shape=(g, g))
    return A, sps.kron(sps.eye(g), m1).tocsr()


def _dense(x):
    return x.toarray() if sps.issparse(x) else x


def _run(solver, rule, v0=None, **kw):
    solver.init(v0)
    nconv = solver.compute(rule, **kw)
    return nconv, solver


def _agree(jax_run, port_run, counts=True):
    """Both packages' runs agree: nconv, info, eigenvalues (1e-10) and,
    with ``counts``, restarts and operations."""
    (jn, j), (pn, p) = jax_run, port_run
    assert pn == jn
    assert p.info().name == j.info().name
    jv, pv = np.asarray(j.eigenvalues()), p.eigenvalues()
    np.testing.assert_allclose(np.sort(pv), np.sort(jv), rtol=0, atol=1e-10)
    if counts:
        assert p.num_iterations() == j.num_iterations()
        assert p.num_operations() == j.num_operations()
    return pv, p.eigenvectors().numpy()


def _resid(A, B, vals, vecs):
    return np.abs(_dense(A) @ vecs - _dense(B) @ vecs * vals[None, :]).max()


class TestCholeskyMode:
    def test_dense(self):
        n, k, m = 100, 5, 20
        A, B = _rand_sym(n), _spd(n)
        j = _run(st.SymGEigsSolver(
            st.DenseSymMatProd.create(A), st.DenseCholesky.create(B), nev=k, ncv=m
        ), st.SortRule.LargestAlge)
        bop = stt.DenseCholesky.create(B, device=CPU)
        assert bop.info() == stt.CompInfo.Successful
        p = _run(stt.SymGEigsSolver(
            stt.DenseSymMatProd.create(A, device=CPU), bop, nev=k, ncv=m
        ), stt.SortRule.LargestAlge)
        vals, vecs = _agree(j, p)
        assert p[0] == k and _resid(A, B, vals, vecs) < 1e-9
        w = scipy.linalg.eigh(A, B, eigvals_only=True)
        np.testing.assert_allclose(np.sort(vals), np.sort(w[-k:]), atol=1e-9)

    def test_dense_not_spd_is_numerical_issue(self):
        B = -_spd(20)
        assert stt.DenseCholesky.create(B, device=CPU).info() == stt.CompInfo.NumericalIssue
        assert st.DenseCholesky.create(B).info() == st.CompInfo.NumericalIssue

    def test_sparse(self):
        n, k, m = 100, 5, 20
        A, B = _sparse_sym(n), _sparse_spd(n)
        j = _run(st.SymGEigsSolver(
            st.SparseSymMatProd.from_full(A), st.SparseCholesky.create(B), nev=k, ncv=m
        ), st.SortRule.LargestAlge)
        bop = stt.SparseCholesky.create(B, device=CPU)
        assert bop.info() == stt.CompInfo.Successful
        p = _run(stt.SymGEigsSolver(
            stt.SparseSymMatProd.from_full(A, device=CPU), bop, nev=k, ncv=m
        ), stt.SortRule.LargestAlge)
        vals, vecs = _agree(j, p)
        assert _resid(A, B, vals, vecs) < 1e-9
        w = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
        np.testing.assert_allclose(np.sort(vals), np.sort(w[-k:]), atol=1e-9)

    def test_sparse_triangular_solves_match_jax(self):
        B = _sparse_spd(60)
        jc, pc = st.SparseCholesky.create(B), stt.SparseCholesky.create(B, device=CPU)
        x = np.random.default_rng(3).normal(size=(60, 2))
        for name in ("lower_triangular_solve", "upper_triangular_solve"):
            want = np.asarray(getattr(jc, name)(x))
            got = getattr(pc, name)(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, want)


class TestRegularInverseMode:
    def test_sparse(self):
        n, k, m = 100, 5, 20
        A, B = _sparse_sym(n), _sparse_spd(n)
        j = _run(st.SymGEigsSolver(
            st.SparseSymMatProd.from_full(A), st.SparseRegularInverse.create(B),
            nev=k, ncv=m, mode=JMode.RegularInverse,
        ), st.SortRule.LargestAlge)
        p = _run(stt.SymGEigsSolver(
            stt.SparseSymMatProd.from_full(A, device=CPU),
            stt.SparseRegularInverse.create(B, device=CPU),
            nev=k, ncv=m, mode=stt.GEigsMode.RegularInverse,
        ), stt.SortRule.LargestAlge)
        vals, vecs = _agree(j, p)
        assert _resid(A, B, vals, vecs) < 1e-7
        w = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
        np.testing.assert_allclose(np.sort(vals), np.sort(w[-k:]), atol=1e-7)

    def test_unconverged_solve_is_poisoned(self):
        B = _sparse_spd(50)
        binv = stt.SparseRegularInverse.create(B, cg_maxiter=1, device=CPU)
        x = torch.from_numpy(np.random.default_rng(0).normal(size=50))
        assert torch.isnan(binv.solve(x)).all()
        good = stt.SparseRegularInverse.create(B, device=CPU).solve(x).numpy()
        np.testing.assert_allclose(B @ good, x.numpy(), atol=1e-9)


class TestShiftInvertMode:
    @pytest.mark.parametrize(
        "a_storage,b_storage",
        [("dense", "dense"), ("sparse", "sparse"), ("dense", "sparse"), ("sparse", "dense")],
    )
    def test_storage_grid(self, a_storage, b_storage):
        n, k, m, sigma = 80, 4, 16, 0.3
        Ad, Bd = _rand_sym(n), _spd(n)
        A = _sparse_sym(n) if a_storage == "sparse" else Ad
        if a_storage == "sparse":
            Ad = A.toarray()
        B = sps.csr_matrix(Bd) if b_storage == "sparse" else Bd
        if b_storage == "sparse":
            jb, pb = st.SparseSymMatProd.from_full(B), stt.SparseSymMatProd.from_full(B, device=CPU)
        else:
            jb, pb = st.DenseSymMatProd.create(Bd), stt.DenseSymMatProd.create(Bd, device=CPU)
        j = _run(st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(A, B), jb, nev=k, ncv=m, sigma=sigma
        ), st.SortRule.LargestMagn)
        op = stt.SymShiftInvert.create(A, B, device=CPU)
        p = _run(stt.SymGEigsShiftSolver(op, pb, nev=k, ncv=m, sigma=sigma),
                 stt.SortRule.LargestMagn)
        vals, vecs = _agree(j, p)
        assert p[1].info() == stt.CompInfo.Successful
        assert _resid(Ad, Bd, vals, vecs) < 1e-9
        w = scipy.linalg.eigh(Ad, Bd, eigvals_only=True)
        closest = w[np.argsort(np.abs(w - sigma))[:k]]
        np.testing.assert_allclose(np.sort(vals), np.sort(closest), atol=1e-9)
        solve = op.set_shift(sigma)
        expect = "splu" if a_storage == b_storage == "sparse" else "BK"
        assert getattr(solve, "method", "BK") == expect

    def test_singular_shift_raises(self):
        A = np.diag([1.0, 2.0, 3.0, 4.0])
        op = stt.SymShiftInvert.create(A, np.eye(4), device=CPU)
        with pytest.raises(stt.matop.shift_solve.ShiftFactorizationError):
            op.set_shift(2.0)

    def test_bicgstab_names_its_slice(self):
        """BiCGStab came with the general shift-solves: ``method="bicgstab"``
        builds the on-device iterative operator, as in the JAX package,
        and its solves agree with the JAX package's within 1e-10."""
        A, B = _grid_pair(6)
        op = stt.SymShiftInvert.create(A, B, method="bicgstab", device=CPU).set_shift(0.0)
        assert op.method == "bicgstab"
        jop = st.SymShiftInvert.create(A, B, method="bicgstab").set_shift(0.0)
        x = np.random.default_rng(2).normal(size=A.shape[0])
        np.testing.assert_allclose(
            op.perform_op(torch.from_numpy(x)).numpy(), np.asarray(jop.perform_op(x)),
            rtol=0, atol=1e-10,
        )


class TestBucklingMode:
    def test_dense(self):
        n, k, m, sigma = 80, 4, 16, 1.0
        K = _spd(n, seed=5)
        KG = _rand_sym(n, seed=6)
        j = _run(st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(K, KG), st.DenseSymMatProd.create(K),
            nev=k, ncv=m, sigma=sigma, mode=JMode.Buckling,
        ), st.SortRule.LargestMagn)
        p = _run(stt.SymGEigsShiftSolver(
            stt.SymShiftInvert.create(K, KG, device=CPU),
            stt.DenseSymMatProd.create(K, device=CPU),
            nev=k, ncv=m, sigma=sigma, mode=stt.GEigsMode.Buckling,
        ), stt.SortRule.LargestMagn)
        vals, vecs = _agree(j, p)
        assert _resid(K, KG, vals, vecs) < 1e-8
        w = np.real(scipy.linalg.eig(K, KG, right=False))
        nu = w / (w - sigma)
        closest = w[np.argsort(-np.abs(nu))[:k]]
        np.testing.assert_allclose(np.sort(vals), np.sort(closest), atol=1e-8)

    def test_zero_sigma_raises(self):
        K = _spd(10)
        op = stt.SymShiftInvert.create(K, _rand_sym(10), device=CPU)
        with pytest.raises(ValueError):
            stt.SymGEigsShiftSolver(
                op, stt.DenseSymMatProd.create(K, device=CPU), 2, 6, 0.0,
                stt.GEigsMode.Buckling,
            )


class TestCayleyMode:
    def test_dense(self):
        n, k, m, sigma = 80, 4, 16, 0.5
        A, B = _rand_sym(n, seed=9), _spd(n, seed=10)
        j = _run(st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(A, B), st.DenseSymMatProd.create(B),
            nev=k, ncv=m, sigma=sigma, mode=JMode.Cayley,
        ), st.SortRule.LargestMagn)
        p = _run(stt.SymGEigsShiftSolver(
            stt.SymShiftInvert.create(A, B, device=CPU),
            stt.DenseSymMatProd.create(B, device=CPU),
            nev=k, ncv=m, sigma=sigma, mode=stt.GEigsMode.Cayley,
        ), stt.SortRule.LargestMagn)
        vals, vecs = _agree(j, p)
        assert _resid(A, B, vals, vecs) < 1e-9
        w = scipy.linalg.eigh(A, B, eigvals_only=True)
        nu = (w + sigma) / (w - sigma)
        closest = w[np.argsort(-np.abs(nu))[:k]]
        np.testing.assert_allclose(np.sort(vals), np.sort(closest), atol=1e-9)

    def test_other_modes_reject_the_direct_ones(self):
        op = stt.SymShiftInvert.create(_rand_sym(10), _spd(10), device=CPU)
        bop = stt.DenseSymMatProd.create(_spd(10), device=CPU)
        with pytest.raises(ValueError):
            stt.SymGEigsShiftSolver(op, bop, 2, 6, 0.5, stt.GEigsMode.Cholesky)
        with pytest.raises(ValueError):
            stt.SymGEigsSolver(bop, bop, 2, 6, stt.GEigsMode.Cayley)


class TestIterativeShiftInvert:
    """``SymShiftInvert`` through the iterative solves on the device."""

    @pytest.mark.parametrize("method", ["minres", "cheb"])
    def test_generalized_sigma0(self, method):
        A, B = _grid_pair(14)
        j = _run(st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(A, B, method=method),
            st.SparseSymMatProd.from_full(B), nev=4, ncv=16, sigma=0.0,
        ), st.SortRule.LargestMagn, tol=1e-8)
        p = _run(stt.SymGEigsShiftSolver(
            stt.SymShiftInvert.create(A, B, method=method, device=CPU),
            stt.SparseSymMatProd.from_full(B, device=CPU), nev=4, ncv=16, sigma=0.0,
        ), stt.SortRule.LargestMagn, tol=1e-8)
        vals, vecs = _agree(j, p)
        assert p[0] == 4 and p[1].info() == stt.CompInfo.Successful
        w = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
        np.testing.assert_allclose(np.sort(vals), np.sort(w)[:4], atol=1e-7)
        assert _resid(A, B, vals, vecs) < 1e-6

    @pytest.mark.parametrize("mode_name", ["Buckling", "Cayley"])
    def test_iterative_route_other_modes(self, mode_name):
        g = 10
        lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
        K = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
        K = K + 0.5 * sps.eye(g * g)
        m1 = sps.diags([1.0 / 6, 2.0 / 3, 1.0 / 6], [-1, 0, 1], shape=(g, g))
        B = sps.kron(sps.eye(g), m1).tocsr()
        # Buckling's second operator supplies K; ShiftInvert/Cayley take B.
        second = K if mode_name == "Buckling" else B
        j = _run(st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(K, B, method="minres"),
            st.SparseSymMatProd.from_full(second), nev=3, ncv=12, sigma=0.25,
            mode=getattr(JMode, mode_name),
        ), st.SortRule.LargestMagn, tol=1e-9)
        p = _run(stt.SymGEigsShiftSolver(
            stt.SymShiftInvert.create(K, B, method="minres", device=CPU),
            stt.SparseSymMatProd.from_full(second, device=CPU), nev=3, ncv=12,
            sigma=0.25, mode=getattr(stt.GEigsMode, mode_name),
        ), stt.SortRule.LargestMagn, tol=1e-9)
        vals, vecs = _agree(j, p)
        assert p[0] == 3 and _resid(K, B, vals, vecs) < 1e-7

    def test_matvec_granularity_parity(self):
        """The stepped driver through the B-inner product gives the plain
        driver's counts and values, in the port as in the JAX package."""
        A, B = _grid_pair(14)

        def port(stepped):
            e = stt.SymGEigsShiftSolver(
                stt.SymShiftInvert.create(A, B, method="minres", device=CPU),
                stt.SparseSymMatProd.from_full(B, device=CPU), nev=4, ncv=16,
                sigma=0.0,
            )
            e.set_matvec_granularity(stepped)
            return _run(e, stt.SortRule.LargestMagn, tol=1e-8)

        j = st.SymGEigsShiftSolver(
            st.SymShiftInvert.create(A, B, method="minres"),
            st.SparseSymMatProd.from_full(B), nev=4, ncv=16, sigma=0.0,
        )
        j.set_matvec_granularity(True)
        j_run = _run(j, st.SortRule.LargestMagn, tol=1e-8)
        plain, stepped = port(False), port(True)
        _agree(j_run, stepped)
        assert stepped[1].num_iterations() == plain[1].num_iterations()
        assert stepped[1].num_operations() == plain[1].num_operations()
        np.testing.assert_array_equal(
            np.sort(stepped[1].eigenvalues()), np.sort(plain[1].eigenvalues())
        )


def test_example115_semidefinite_cholesky():
    """``tests/test_regression_examples.py::TestExample115`` (reference:
    Example3.cpp case 1): semidefinite A in the Cholesky mode."""
    C = sps.coo_matrix(
        (
            [1.1807575e8, 304744.5, -152372.25, 304744.5, 152372.25,
             15403.85, 152372.25, 101581.5, -152372.25, 101581.5],
            ([0, 1, 1, 2, 2, 3, 4, 4, 5, 5], [0, 1, 5, 2, 4, 3, 2, 4, 1, 5]),
        ),
        shape=(6, 6),
    ).tocsr()
    M = sps.diags([1000.0, 1000.0, 1000.0, 0.0, 0.0, 0.0]).tocsr()
    A, B = M, (C + 1.0e5 * M).tocsr()
    j = _run(st.SymGEigsSolver(
        st.SparseSymMatProd.from_full(A), st.SparseCholesky.create(B), nev=4, ncv=5
    ), st.SortRule.LargestMagn)
    bop = stt.SparseCholesky.create(B, device=CPU)
    assert bop.info() == stt.CompInfo.Successful
    p = _run(stt.SymGEigsSolver(
        stt.SparseSymMatProd.from_full(A, device=CPU), bop, nev=4, ncv=5
    ), stt.SortRule.LargestMagn)
    vals, vecs = _agree(j, p)
    assert p[1].info() == stt.CompInfo.Successful
    assert _resid(A, B, vals, vecs) < 1e-9


def _config5a_analytic(g, k=10):
    """The k smallest of ``A x = lambda B x`` for config #5a's pair:
    ``(lambda_a + lambda_b) / mu_b``, with b the inner axis, on which B
    acts (``lambda_i = 2 - 2 cos theta_i``, ``mu_i = (2 + cos theta_i) / 3``,
    ``theta_i = i pi / (g + 1)``)."""
    theta = np.arange(1, g + 1) * np.pi / (g + 1)
    lam, mu = 2.0 - 2.0 * np.cos(theta), (2.0 + np.cos(theta)) / 3.0
    return np.sort(((lam[:, None] + lam[None, :]) / mu[None, :]).ravel())[:k]


def test_config5a_operator_g16_matches_jax_and_analytic():
    """Config #5a through the calls of ``scripts/tpu_generalized_1m.py``:
    ``SymShiftInvert(A, B, method="mg").set_shift(0)``,
    ``SymGEigsShiftSolver.from_factored(op, bop, 10, 30, 0)``, the
    stepped driver, ``compute(LargestMagn, maxit=50, tol=1e-10)``."""
    g = 16
    A, B = _grid_pair(g, aniso=1.0)
    v0 = SimpleRandom(0).random_vec(g * g)
    j = st.SymGEigsShiftSolver.from_factored(
        st.SymShiftInvert.create(A, B, method="mg").set_shift(0.0),
        st.SparseSymMatProd.from_full(B), 10, 30, 0.0,
    )
    j.set_matvec_granularity(True)
    op = stt.SymShiftInvert.create(A, B, method="mg", device=CPU).set_shift(0.0)
    assert op.method == "mg"
    p = stt.SymGEigsShiftSolver.from_factored(
        op, stt.SparseSymMatProd.from_full(B, device=CPU), 10, 30, 0.0
    )
    p.set_matvec_granularity(True)
    kw = dict(maxit=50, tol=1e-10)
    vals, vecs = _agree(_run(j, st.SortRule.LargestMagn, v0, **kw),
                        _run(p, stt.SortRule.LargestMagn, v0, **kw))
    w = _config5a_analytic(g)
    np.testing.assert_allclose(np.sort(vals), w, rtol=1e-10, atol=0)
    assert _resid(A, B, vals, vecs) / abs(A).sum(axis=1).max() < 1e-9


def test_config5a_analytic_formula_matches_eigh():
    A, B = _grid_pair(12, aniso=1.0)
    w = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    np.testing.assert_allclose(_config5a_analytic(12, 144), w, rtol=0, atol=1e-12)
