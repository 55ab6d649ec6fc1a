"""The port's Jacobi-Davidson family against the JAX package, on the CPU.

Every case of ``tests/test_davidson.py`` (the orthogonalization
routines, Davidson on dense and sparse operators, the knobs,
``compute_with_guess``, the compiled route against the host loop, the
stagnation guard) on the port's one JD iteration
(``solvers/_jd_core.py``), each beside the JAX package on the same
matrix: its compiled route, or its host loop for what only that loop
serves there (``BothEnds``, a JD subclass with only
``calculate_correction_vector``, a schedule wider than n).
``nconv``, ``CompInfo`` and the iteration count agree, the eigenvalues
agree within the reference test's 1e-7 (1e-9 between the packages),
and the Ritz vectors agree up to sign. Also config #5b's matrix
(``bench.py:386-402``) at n = 2,000 and a vanishing DPR denominator,
which ends both packages with ``NumericalIssue``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.linalg import orthogonalization as jorth
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import orthogonalization as porth
from spectra_tpu_torch.solvers import _jd_core, jd_sym_eigs

torch.set_num_threads(1)

CPU = "cpu"
#: Davidson itself, or a JD subclass with only the reference's seam.
VARIANTS = ["davidson", "subclass"]


class _JaxDprOnly(st.DavidsonSymEigsSolver):
    """Davidson without the JAX package's compiled-route seam, so that
    the JAX package runs its host loop."""

    _correction_kernel = None


class _DprOnly(stt.JDSymEigsBase):
    """A JD subclass with only the reference's seam: Davidson's initial
    space and the DPR correction, read from ``self._ritz_pairs``."""

    def __init__(self, op, nev, nvec_init=None, nvec_max=None):
        super().__init__(op, nev, nvec_init, nvec_max)
        self._diagonal = op.diagonal()

    setup_initial_search_space = stt.DavidsonSymEigsSolver.setup_initial_search_space

    def calculate_correction_vector(self):
        pairs, k = self._ritz_pairs, self._correction_size
        return pairs.residues[:, :k] / (pairs.values[:k][None, :] - self._diagonal[:, None])


SOLVERS = {"davidson": (st.DavidsonSymEigsSolver, stt.DavidsonSymEigsSolver),
           "subclass": (_JaxDprOnly, _DprOnly)}


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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["qr", "gs", "mgs", "twice"])
def test_orthogonalization_matches_jax(fn, seed):
    """``TestOrthogonalization``."""
    rng = np.random.default_rng(seed)
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


def _run(monkeypatch, variant, A, k, sel, maxit=200, tol=1e-9, sparse=False, knobs=None,
         guess=None, jax_route="auto", niter_slack=0):
    """The ``variant`` solver through the JAX package on ``jax_route``
    and through the port; returns (jax, port) after checking nconv,
    CompInfo, the iteration count (within ``niter_slack``), the values
    and the vectors."""
    if sparse:
        jop = st.SparseSymMatProd.from_full(sps.csr_matrix(A))
        pop = stt.SparseSymMatProd.from_full(sps.csr_matrix(A), device=CPU)
    else:
        jop = st.DenseSymMatProd.create(A)
        pop = stt.DenseSymMatProd.create(A, device=CPU)
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", jax_route)  # the JAX package's switch
    out = []
    for pkg, op, solver in zip((st, stt), (jop, pop), SOLVERS[variant]):
        s = solver(op, nev=k, **(knobs or {}).get("init", {}))
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


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize(
    "n,k,seed,sel",
    [(100, 3, 42, "LargestAlge"), (400, 5, 42, "LargestAlge"), (120, 4, 7, "SmallestAlge"),
     (12, 2, 42, "LargestAlge"), (8, 3, 42, "LargestAlge")],
)
def test_davidson_dense_matches_jax(monkeypatch, variant, n, k, seed, sel):
    """``TestDavidson.test_largest`` and ``test_smallest``; at n = 12
    and 8 the growth schedule passes n (at 8 after the clamp to
    i0 = c = n // 3 < nev), where the JAX package runs its host loop."""
    A = _diag_dominant(n, seed)
    _, p = _run(monkeypatch, variant, A, k, sel)
    assert p.info() == stt.CompInfo.Successful
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-7
    w = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.sort(vals), w[-k:] if sel == "LargestAlge" else w[:k],
                               atol=1e-7)


def _both_ends(w, k):
    """The ``BothEnds`` values of the ascending ``w``, ascending."""
    return np.sort(np.concatenate([w[: k // 2], w[len(w) - (k + 1) // 2:]]))


@pytest.mark.parametrize("sel", ["LargestAlge", "BothEnds"])
def test_davidson_sparse_matches_jax(monkeypatch, sel):
    """``TestDavidson.test_sparse_op``: an ELL operator."""
    A = _sparse_diag_dominant()
    _, p = _run(monkeypatch, "davidson", A, 3, sel, maxit=300, sparse=True)
    assert p.info() == stt.CompInfo.Successful
    np.testing.assert_allclose(np.sort(p.eigenvalues()),
                               _both_ends(np.linalg.eigvalsh(A), 3) if sel == "BothEnds"
                               else np.linalg.eigvalsh(A)[-3:], atol=1e-7)


@pytest.mark.parametrize("variant", VARIANTS)
def test_davidson_knobs_match_jax(monkeypatch, variant):
    """``TestDavidson.test_knobs``. Its second residual meets tol at the
    twelfth iteration within 0.2 % (9.99e-10 in the JAX package, 1.001e-9
    in the port: the products' rounding, CPU BLAS against XLA), so the
    port may take one iteration more there."""
    knobs = dict(init=dict(nvec_init=4, nvec_max=20),
                 set=dict(set_correction_size=3, set_max_search_space_size=16,
                          set_initial_search_space_size=4))
    _, p = _run(monkeypatch, variant, _diag_dominant(50), 2, "LargestAlge", maxit=100,
                knobs=knobs, niter_slack=1)
    assert p.info() == stt.CompInfo.Successful


@pytest.mark.parametrize("sel", ["LargestAlge", "BothEnds"])
def test_compute_with_guess_matches_jax(monkeypatch, sel):
    A = _diag_dominant(80)
    guess = np.linalg.qr(np.random.default_rng(5).normal(size=(80, 6)))[0]
    _, p = _run(monkeypatch, "davidson", A, 3, sel, guess=guess)
    assert p.info() == stt.CompInfo.Successful
    w = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.sort(p.eigenvalues()),
                               _both_ends(w, 3) if sel == "BothEnds" else w[-3:], atol=1e-7)


@pytest.mark.parametrize("sel", ["LargestAlge", "SmallestAlge"])
def test_routes_agree(monkeypatch, sel):
    """``TestCompiledDriver.test_matches_host_loop``: the port's one
    loop takes the iterations of both JAX routes, and the operator
    columns of the JAX host loop (counted at its operator)."""
    A = _diag_dominant(90, seed=11)
    jax_cols = []
    perform_op = st.DenseSymMatProd.perform_op
    monkeypatch.setattr(st.DenseSymMatProd, "perform_op",
                        lambda self, X: jax_cols.append(np.shape(X)[-1]) or perform_op(self, X))
    runs = {}
    for r in ("auto", "host"):
        jax_cols.clear()
        runs[r] = _run(monkeypatch, "davidson", A, 3, sel, jax_route=r)
    p = runs["host"][1]
    assert (p.num_iterations() == runs["auto"][0].num_iterations()
            == runs["host"][0].num_iterations())
    assert runs["auto"][1].num_operations() == p.num_operations() == sum(jax_cols)
    np.testing.assert_allclose(np.sort(p.eigenvalues()),
                               np.sort(np.asarray(runs["host"][0].eigenvalues())),
                               rtol=1e-9, atol=1e-9)


def test_stagnation_guard_returns_best_iterate():
    """``TestCompiledDriver.test_stagnation_guard_returns_best_iterate``:
    below the residual floor the loop stops on patience with the best
    snapshot. Where patience fires follows the rounding of the residual
    floor, so the count is held to the guard, not to the JAX package's."""
    A = _diag_dominant(150, seed=5)
    p = stt.DavidsonSymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=3)
    p.compute(stt.SortRule.LargestAlge, maxit=500, tol=1e-17)
    assert p.info() == stt.CompInfo.NotConverging
    assert p.num_iterations() < 500
    np.testing.assert_allclose(np.sort(p.eigenvalues()), np.linalg.eigvalsh(A)[-3:], atol=1e-9)


def test_compiled_path_selected(monkeypatch):
    """Every solve runs ``jd_compute`` once: ``BothEnds``, a subclass
    with only ``calculate_correction_vector`` and a schedule wider than
    n among them; the JAX package's ``SPECTRA_TPU_JD_DRIVER=host``
    changes nothing in the port."""
    calls = []
    jd_compute = jd_sym_eigs.jd_compute
    monkeypatch.setattr(jd_sym_eigs, "jd_compute",
                        lambda *a, **kw: calls.append(kw["selection"]) or jd_compute(*a, **kw))

    def solve(cls, A, nev, rule):
        s = cls(stt.DenseSymMatProd.create(A, device=CPU), nev=nev)
        nconv = s.compute(getattr(stt.SortRule, rule), maxit=100, tol=1e-9)
        return s, (nconv, s.info(), s.num_iterations(), s.num_operations(),
                   s.eigenvalues().tobytes(), s.eigenvectors().numpy().tobytes())

    A = _diag_dominant(60, seed=3)
    for cls, rule in ((stt.DavidsonSymEigsSolver, "LargestAlge"),
                      (stt.DavidsonSymEigsSolver, "BothEnds"), (_DprOnly, "LargestAlge")):
        _, out = solve(cls, A, 2, rule)
        assert out[1] == stt.CompInfo.Successful
    tiny, _ = solve(stt.DavidsonSymEigsSolver, _diag_dominant(8), 3, "LargestAlge")
    assert _jd_core.schedule(tiny._initial_search_space_size, tiny._correction_size,
                             tiny._max_search_space_size)[-1] > 8
    assert [r.name for r in calls] == ["LargestAlge", "BothEnds", "LargestAlge", "LargestAlge"]
    assert _jd_core.schedule(20, 10, 100) == list(range(20, 120, 10))
    _, auto = solve(stt.DavidsonSymEigsSolver, A, 2, "LargestAlge")
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "host")
    _, host = solve(stt.DavidsonSymEigsSolver, A, 2, "LargestAlge")
    assert host == auto and len(calls) == 6


@pytest.mark.parametrize("sel", ["LargestAlge", "BothEnds"])
def test_vanishing_dpr_denominator_is_numerical_issue(monkeypatch, sel):
    """A diagonal matrix: the initial Ritz pairs are exact, at tol 0
    the DPR correction is 0/0, and both packages end with
    ``NumericalIssue`` and the last finite values."""
    _, p = _run(monkeypatch, "davidson", np.diag(np.arange(1.0, 41.0)), 2, sel,
                maxit=50, tol=0.0)
    assert p.info() == stt.CompInfo.NumericalIssue
    np.testing.assert_array_equal(p.eigenvalues(),
                                  [40.0, 1.0] if sel == "BothEnds" else [40.0, 39.0])


def _config5b(n):
    d = np.linspace(1.0, 100.0, n) ** 2
    return sps.diags(
        [np.full(n, 0.25), np.full(n, 0.5), d, np.full(n, 0.5), np.full(n, 0.25)],
        [-1000, -1, 0, 1, 1000], shape=(n, n), format="csr",
    ), d


def test_config5b_matches_jax(monkeypatch):
    """Config #5b's matrix (``bench.py:386-402``) at n = 2,000 on the
    port's one loop: DIA, equal iteration counts, values within 1e-9
    ||A|| of the JAX package's compiled route and of ``eigvalsh``."""
    monkeypatch.setenv("SPECTRA_TPU_JD_DRIVER", "auto")  # the JAX package's switch
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
