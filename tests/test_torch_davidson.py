"""The port's Jacobi-Davidson family against the JAX package, on the CPU.

Every case of ``tests/test_davidson.py`` (the orthogonalization
routines, Davidson on dense and sparse operators, the knobs,
``compute_with_guess``, the fixed-buffer route against the host loop,
the stagnation guard), each through both of the port's JD routes
(``SPECTRA_TPU_JD_DRIVER`` ``auto`` and ``host``) against the JAX
package's compiled route on the same matrix (the reference test holds
the two routes to the same count; ``test_routes_agree`` runs the JAX
package's host loop too): ``nconv``, ``CompInfo`` and the iteration
count agree, the eigenvalues agree within the reference test's 1e-7
(1e-9 between the packages), and the Ritz vectors agree up to sign. Also config #5b's
matrix (``bench.py:386-402``) at n = 2,000 and a vanishing DPR
denominator, which ends both packages with ``NumericalIssue``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.linalg import orthogonalization as jorth
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import orthogonalization as porth
from spectra_tpu_torch.solvers import _jd_core

torch.set_num_threads(1)

CPU = "cpu"
ROUTES = ["auto", "host"]


def _diag_dominant(n, seed=42):
    rng = np.random.RandomState(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    A = (A + A.T) * 0.5
    np.fill_diagonal(A, np.arange(1.0, n + 1) + np.abs(A).sum(axis=1))
    return A


def _sparse_diag_dominant(n=200):
    A = _diag_dominant(n, seed=9)
    A[np.abs(A) < 0.4] = 0.0
    idx = np.arange(n - 1)
    A[idx, idx + 1] += 0.05
    A[idx + 1, idx] += 0.05
    np.fill_diagonal(A, np.arange(1.0, n + 1) + np.abs(A).sum(axis=1))
    return A


def _same_up_to_sign(U, W, atol):
    for j in range(U.shape[1]):
        s = np.sign(U[np.argmax(np.abs(U[:, j])), j] * W[np.argmax(np.abs(U[:, j])), j])
        np.testing.assert_allclose(U[:, j], s * W[:, j], atol=atol)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fn", ["qr", "gs", "mgs", "twice"])
def test_orthogonalization_matches_jax(fn, route):
    """``TestOrthogonalization`` (``route`` only varies the seed)."""
    rng = np.random.default_rng(ROUTES.index(route))
    if fn == "twice":
        Q0 = np.linalg.qr(rng.normal(size=(50, 5)))[0]
        A = np.concatenate([Q0, rng.normal(size=(50, 3))], axis=1)
        out = porth.twice_is_enough(torch.from_numpy(A), 5).numpy()
        np.testing.assert_allclose(out[:, :5], Q0, atol=1e-14)
        np.testing.assert_allclose(out.T @ out, np.eye(8), atol=1e-12)
        np.testing.assert_allclose(out, np.asarray(jorth.twice_is_enough(A, 5)), atol=1e-12)
        return
    A = rng.normal(size=(40, 8))
    pfn, jfn = {
        "qr": (porth.qr_orthogonalisation, jorth.qr_orthogonalisation),
        "gs": (porth.gram_schmidt_orthogonalisation, jorth.gram_schmidt_orthogonalisation),
        "mgs": (porth.modified_gram_schmidt_orthogonalisation,
                jorth.modified_gram_schmidt_orthogonalisation),
    }[fn]
    Q = pfn(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(Q.T @ Q, np.eye(8), atol=1e-12)
    np.testing.assert_allclose(Q @ (Q.T @ A), A, atol=1e-12)
    np.testing.assert_allclose(Q, np.asarray(jfn(A)), atol=1e-12)
    if fn == "qr":
        assert pfn(torch.from_numpy(A)).is_contiguous()


def _run(monkeypatch, route, A, k, sel, maxit=200, tol=1e-9, sparse=False, knobs=None,
         guess=None, jax_route="auto", niter_slack=0):
    """Davidson through the JAX package on ``jax_route`` and the port on
    ``route``; returns (jax, port) after checking nconv, CompInfo, the
    iteration count (within ``niter_slack``), the values and the
    vectors."""
    if sparse:
        jop = st.SparseSymMatProd.from_full(sps.csr_matrix(A))
        pop = stt.SparseSymMatProd.from_full(sps.csr_matrix(A), device=CPU)
    else:
        jop = st.DenseSymMatProd.create(A)
        pop = stt.DenseSymMatProd.create(A, device=CPU)
    out = []
    for pkg, op, r in ((st, jop, jax_route), (stt, pop, route)):
        monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", r)
        s = pkg.DavidsonSymEigsSolver(op, nev=k, **(knobs or {}).get("init", {}))
        for name, value in (knobs or {}).get("set", {}).items():
            getattr(s, name)(value)
        rule = getattr(pkg.SortRule, sel)
        if guess is None:
            nconv = s.compute(rule, maxit=maxit, tol=tol)
        else:
            nconv = s.compute_with_guess(guess, rule, maxit, tol)
        out.append((s, nconv))
    (j, jn), (p, pn) = out
    assert pn == jn
    assert p.info().name == j.info().name
    assert abs(p.num_iterations() - j.num_iterations()) <= niter_slack
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-9)
    _same_up_to_sign(p.eigenvectors().numpy(), np.asarray(j.eigenvectors()), 1e-7)
    return j, p


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "n,k,seed,sel",
    [(100, 3, 42, "LargestAlge"), (400, 5, 42, "LargestAlge"), (120, 4, 7, "SmallestAlge")],
)
def test_davidson_dense_matches_jax(monkeypatch, route, n, k, seed, sel):
    """``TestDavidson.test_largest`` and ``test_smallest``."""
    A = _diag_dominant(n, seed)
    _, p = _run(monkeypatch, route, A, k, sel)
    assert p.info() == stt.CompInfo.Successful
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-7
    w = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.sort(vals), w[-k:] if sel == "LargestAlge" else w[:k],
                               atol=1e-7)


@pytest.mark.parametrize("route", ROUTES)
def test_davidson_sparse_matches_jax(monkeypatch, route):
    """``TestDavidson.test_sparse_op``: an ELL operator."""
    A = _sparse_diag_dominant()
    _, p = _run(monkeypatch, route, A, 3, "LargestAlge", maxit=300, sparse=True)
    assert p.info() == stt.CompInfo.Successful
    np.testing.assert_allclose(np.sort(p.eigenvalues()), np.linalg.eigvalsh(A)[-3:], atol=1e-7)


@pytest.mark.parametrize("route", ROUTES)
def test_davidson_knobs_match_jax(monkeypatch, route):
    """``TestDavidson.test_knobs``. Its second residual meets tol at the
    twelfth iteration within 0.2 % (9.99e-10 in the JAX package, 1.001e-9
    in the port: the products' rounding, CPU BLAS against XLA), so the
    port may take one iteration more there."""
    knobs = dict(init=dict(nvec_init=4, nvec_max=20),
                 set=dict(set_correction_size=3, set_max_search_space_size=16,
                          set_initial_search_space_size=4))
    _, p = _run(monkeypatch, route, _diag_dominant(50), 2, "LargestAlge", maxit=100,
                knobs=knobs, niter_slack=1)
    assert p.info() == stt.CompInfo.Successful


@pytest.mark.parametrize("route", ROUTES)
def test_compute_with_guess_matches_jax(monkeypatch, route):
    A = _diag_dominant(80)
    guess = np.linalg.qr(np.random.default_rng(5).normal(size=(80, 6)))[0]
    _, p = _run(monkeypatch, route, A, 3, "LargestAlge", guess=guess)
    assert p.info() == stt.CompInfo.Successful
    np.testing.assert_allclose(np.sort(p.eigenvalues()), np.linalg.eigvalsh(A)[-3:], atol=1e-7)


@pytest.mark.parametrize("sel", ["LargestAlge", "SmallestAlge"])
def test_routes_agree(monkeypatch, sel):
    """``TestCompiledDriver.test_matches_host_loop``: the same schedule
    gives the same iteration count on both routes, each equal to the
    JAX package's."""
    A = _diag_dominant(90, seed=11)
    runs = {r: _run(monkeypatch, r, A, 3, sel, jax_route=r)[1] for r in ROUTES}
    assert runs["auto"].num_iterations() == runs["host"].num_iterations()
    assert runs["auto"].num_operations() == runs["host"].num_operations()
    np.testing.assert_allclose(np.sort(runs["auto"].eigenvalues()),
                               np.sort(runs["host"].eigenvalues()), rtol=1e-9, atol=1e-9)


def test_stagnation_guard_returns_best_iterate(monkeypatch):
    """``TestCompiledDriver.test_stagnation_guard_returns_best_iterate``:
    below the residual floor the loop stops on patience with the best
    snapshot. Where patience fires follows the rounding of the residual
    floor, so the count is held to the guard, not to the JAX package's."""
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "auto")
    A = _diag_dominant(150, seed=5)
    p = stt.DavidsonSymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=3)
    p.compute(stt.SortRule.LargestAlge, maxit=500, tol=1e-17)
    assert p.info() == stt.CompInfo.NotConverging
    assert p.num_iterations() < 500
    np.testing.assert_allclose(np.sort(p.eigenvalues()), np.linalg.eigvalsh(A)[-3:], atol=1e-9)


def test_compiled_path_selected(monkeypatch):
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "auto")
    A = _diag_dominant(60, seed=3)
    p = stt.DavidsonSymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=2)
    j = st.DavidsonSymEigsSolver(st.DenseSymMatProd.create(A), nev=2)
    for rule in ("LargestAlge", "BothEnds"):
        assert p._use_compiled(getattr(stt.SortRule, rule)) == j._use_compiled(
            getattr(st.SortRule, rule)) == (rule != "BothEnds")
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "host")
    assert not p._use_compiled(stt.SortRule.LargestAlge)
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "fast")
    with pytest.raises(ValueError, match="SPECTRA_TPU_JD_DRIVER"):
        p._use_compiled(stt.SortRule.LargestAlge)
    assert _jd_core.schedule(20, 10, 100) == list(range(20, 120, 10))


@pytest.mark.parametrize("route", ROUTES)
def test_vanishing_dpr_denominator_is_numerical_issue(monkeypatch, route):
    """A diagonal matrix: the initial Ritz pairs are exact, at tol 0
    the DPR correction is 0/0, and both packages end with
    ``NumericalIssue`` and the last finite values."""
    _, p = _run(monkeypatch, route, np.diag(np.arange(1.0, 41.0)), 2, "LargestAlge",
                maxit=50, tol=0.0)
    assert p.info() == stt.CompInfo.NumericalIssue
    np.testing.assert_array_equal(p.eigenvalues(), [40.0, 39.0])


def _config5b(n):
    d = np.linspace(1.0, 100.0, n) ** 2
    return sps.diags(
        [np.full(n, 0.25), np.full(n, 0.5), d, np.full(n, 0.5), np.full(n, 0.25)],
        [-1000, -1, 0, 1, 1000], shape=(n, n), format="csr",
    ), d


def test_config5b_matches_jax(monkeypatch):
    """Config #5b's matrix (``bench.py:386-402``) at n = 2,000 on the
    fixed-buffer route: DIA, equal iteration counts, values within
    1e-9 ||A|| of the JAX package's and of ``eigvalsh``."""
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "auto")
    A, d = _config5b(2000)
    tol = 1e-9 * float(d.max())
    pop = stt.SparseSymMatProd.from_full(A, device=CPU)
    assert type(pop.ell).__name__ == "DiaMatrix"
    assert pop.ell.offsets == (-1000, -1, 0, 1, 1000)
    p = stt.DavidsonSymEigsSolver(pop, nev=10)
    pn = p.compute(stt.SortRule.LargestAlge, maxit=150, tol=tol)
    j = st.DavidsonSymEigsSolver(st.SparseSymMatProd.from_full(A), nev=10)
    jn = j.compute(st.SortRule.LargestAlge, maxit=150, tol=tol)
    assert pn == jn == 10
    assert p.info() == stt.CompInfo.Successful
    assert p.num_iterations() == j.num_iterations()
    assert p.num_operations() == 20 + 10 * (p.num_iterations() - 1)
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()),
                               atol=1e-9 * d.max())
    w = np.linalg.eigvalsh(A.toarray())[::-1][:10]
    np.testing.assert_allclose(np.sort(p.eigenvalues())[::-1], w, atol=1e-9 * d.max())
    U = p.eigenvectors().numpy()
    assert np.linalg.norm(A @ U - U * p.eigenvalues()[None, :], axis=0).max() <= tol
    assert np.abs(U.T @ U - np.eye(10)).max() <= 1e-10
