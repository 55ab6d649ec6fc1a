"""The port's general (non-symmetric) solvers against the JAX package, on
the CPU.

Cases of ``tests/test_gen_eigs.py``, ``tests/test_gen_ks.py``,
``tests/test_gen_embed.py`` and the general case of
``tests/test_robustness.py``, each run through both packages on the
same seeded matrix and start: ``nconv``, ``CompInfo`` and eigenvalues
(within 1e-10) agree, and so do the restart and operation counts (the
``SimpleRandom`` start, simple spectra). A real f64 dense matrix runs
on both dense drivers: ``auto`` (the native Krylov-Schur driver, the
same C++ source in both packages) and ``torch`` (the port's IRAM,
against the JAX package's compiled IRAM, ``jax``).

Also: the Arnoldi factorization and one implicit restart of each kind
(``_restart_real``, ``_restart_complex``) fed the JAX package's
factorization through ``convert.krylov_state_from_numpy`` (H and V
within 1e-12); config #4's operator (``bench.py:272-300``) at g=16,
where the similarity that makes its spectrum real has condition number
about 7, so the eigenvalues agree with the JAX package's within 1e-9
and with the analytic ones within 1e-8; and the matvec-granularity
parity of ``tests/test_gen_eigs.py:128-155``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spectra_tpu as st
from spectra_tpu.linalg import krylov as jkry
from spectra_tpu.matop.arnoldi_op import ArnoldiOp as JArnoldiOp
from spectra_tpu.matop.gen_embed import RealEmbeddedGenMatProd as JEmbed
from spectra_tpu.solvers import _gen_core as jcore
from spectra_tpu.util.rng import SimpleRandom
import spectra_tpu_torch as stt
from spectra_tpu_torch import convert
from spectra_tpu_torch.linalg import krylov as pkry
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp as PArnoldiOp
from spectra_tpu_torch.solvers import _gen_core as pcore
from spectra_tpu_torch.solvers import _native_dense

torch.set_num_threads(1)

CPU = "cpu"
#: (the port's dense driver, the JAX package's name for it)
DRIVERS = {"native": ("auto", "auto"), "torch": ("torch", "jax")}


def _rand_mat(n, seed=123, complex_=False):
    rng = np.random.RandomState(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    if complex_:
        A = A + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A


def _residual(A, p):
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    Ad = A.toarray() if sps.issparse(A) else A
    return np.abs(Ad @ vecs - vecs * vals[None, :]).max()


def _pair(monkeypatch, make, A, nev, ncv, rule="LargestMagn", driver="torch",
          v0=None, maxit=1000, tol=1e-10, sorting=None, restart=None,
          counts=True, device_op=None):
    """Run ``make(pkg, A)`` (an operator) through both packages'
    ``GenEigsSolver``; returns ``(jax solver, port solver)`` after
    checking nconv, CompInfo, the eigenvalues (1e-10) and the counts."""
    sorting = sorting or rule
    ours, theirs = DRIVERS[driver]
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", theirs)
    j = st.GenEigsSolver(make(st, A), nev=nev, ncv=ncv)
    if restart:
        j.set_restart_method(restart)
    j.init(v0)
    jn = j.compute(getattr(st.SortRule, rule), maxit, tol, getattr(st.SortRule, sorting))
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", ours)
    fallbacks = _native_dense.FALLBACKS
    p = stt.GenEigsSolver(make(stt, A), nev=nev, ncv=ncv)
    if restart:
        p.set_restart_method(restart)
    p.init(v0)
    pn = p.compute(getattr(stt.SortRule, rule), maxit, tol, getattr(stt.SortRule, sorting))
    assert _native_dense.FALLBACKS == fallbacks
    assert pn == jn and p.info().name == j.info().name
    jv, pv = np.asarray(j.eigenvalues()), p.eigenvalues()
    assert pv.dtype == np.complex128
    np.testing.assert_allclose(np.sort_complex(pv), np.sort_complex(jv), rtol=0, atol=1e-10)
    if counts:
        assert (p.num_iterations(), p.num_operations()) == (
            j.num_iterations(), j.num_operations()
        )
    return j, p


def _dense(pkg, A):
    return pkg.DenseGenMatProd.create(A) if pkg is st else pkg.DenseGenMatProd.create(A, device=CPU)


def _sparse(pkg, A):
    return pkg.SparseGenMatProd.create(A) if pkg is st else pkg.SparseGenMatProd.create(A, device=CPU)


@pytest.mark.parametrize("driver", ["native", "torch"])
@pytest.mark.parametrize("n,k,m", [(10, 3, 6), (100, 10, 30)])
@pytest.mark.parametrize("rule", ["LargestMagn", "LargestReal"])
def test_gen_eigs_real_dense(monkeypatch, driver, n, k, m, rule):
    """``TestGenEigsReal::test_dense``."""
    A = _rand_mat(n)
    _, p = _pair(monkeypatch, _dense, A, k, m, rule, driver)
    assert p.info() == stt.CompInfo.Successful and len(p.eigenvalues()) == k
    assert _residual(A, p) < 1e-9
    w = np.linalg.eigvals(A)
    for v in p.eigenvalues():
        assert np.min(np.abs(w - v)) < 1e-8


def test_gen_eigs_sparse(monkeypatch):
    """``TestGenEigsReal::test_sparse``: ELL storage (not banded)."""
    A = sps.random(120, 120, density=0.1, random_state=np.random.RandomState(11),
                   format="csr")
    _, p = _pair(monkeypatch, _sparse, A, 6, 24)
    assert p.info() == stt.CompInfo.Successful and _residual(A, p) < 1e-9


@pytest.mark.parametrize("driver", ["native", "torch"])
def test_matches_true_top_magnitude(monkeypatch, driver):
    A = _rand_mat(60, seed=3)
    _, p = _pair(monkeypatch, _dense, A, 6, 20, driver=driver)
    w = np.linalg.eigvals(A)
    want = w[np.argsort(-np.abs(w), kind="stable")[:6]]
    np.testing.assert_allclose(np.sort_complex(np.round(p.eigenvalues(), 9)),
                               np.sort_complex(np.round(want, 9)), atol=1e-8)


@pytest.mark.parametrize("n,k,m", [(10, 3, 6), (80, 6, 20)])
def test_gen_eigs_complex_dense(monkeypatch, n, k, m):
    """``TestGenEigsComplex::test_dense_complex``: complex V and H."""
    A = _rand_mat(n, seed=5, complex_=True)
    _, p = _pair(monkeypatch, _dense, A, k, m)
    assert p.info() == stt.CompInfo.Successful and _residual(A, p) < 1e-9
    assert p.eigenvectors().dtype == torch.complex128
    w = np.linalg.eigvals(A)
    want = w[np.argsort(-np.abs(w), kind="stable")[:k]]
    np.testing.assert_allclose(np.sort_complex(np.round(p.eigenvalues(), 9)),
                               np.sort_complex(np.round(want, 9)), atol=1e-8)


def test_bounds():
    op = stt.DenseGenMatProd.create(_rand_mat(10), device=CPU)
    with pytest.raises(ValueError):
        stt.GenEigsSolver(op, nev=9, ncv=10)
    with pytest.raises(ValueError):
        stt.GenEigsSolver(op, nev=3, ncv=4)
    with pytest.raises(ValueError):
        stt.GenEigsSolver(op, nev=3, ncv=6).set_restart_method("thick")


def test_gen_matvec_granularity_matches_host_driver(monkeypatch):
    """``tests/test_gen_eigs.py:128-155``: the stepped driver replays the
    host-driven IRAM's decisions exactly; here both are the port's one
    loop, bitwise, and equal the JAX package's host driver's counts."""
    A = _rand_mat(200)
    v0 = SimpleRandom(0).random_vec(200)
    monkeypatch.setenv("SPECTRA_TPU_GEN_DRIVER", "host")
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "jax")
    j = st.GenEigsSolver(st.DenseGenMatProd.create(A), nev=4, ncv=12)
    j.init(v0)
    j.compute(st.SortRule.LargestMagn)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    runs = []
    for stepped in (False, True):
        p = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=CPU), nev=4, ncv=12)
        p.set_matvec_granularity(stepped)
        p.init(v0)
        assert p.compute(stt.SortRule.LargestMagn) == 4
        runs.append(p)
    ref, stepped = runs
    assert (stepped.num_iterations(), stepped.num_operations()) == (
        ref.num_iterations(), ref.num_operations()
    ) == (j.num_iterations(), j.num_operations())
    np.testing.assert_array_equal(stepped.eigenvalues(), ref.eigenvalues())
    np.testing.assert_allclose(np.sort_complex(stepped.eigenvalues()),
                               np.sort_complex(np.asarray(j.eigenvalues())), atol=1e-10)
    assert len(stepped.convergence_history()) == stepped.num_iterations() - 1


def test_restart_chunk_equals_single_shot(monkeypatch):
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    A = _rand_mat(100)
    runs = []
    for chunk in (None, 3):
        p = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=CPU), nev=6, ncv=16)
        p.set_restart_chunk(chunk)
        p.init()
        p.compute()
        runs.append(p)
    np.testing.assert_array_equal(runs[0].eigenvalues(), runs[1].eigenvalues())
    assert runs[0].num_operations() == runs[1].num_operations()
    assert runs[1].convergence_history()[-1]["nconv"] == 6


@pytest.mark.parametrize("complex_", [False, True])
def test_arnoldi_factorization_and_one_restart_match_jax(complex_):
    """The Arnoldi factorization from the same start, then one implicit
    restart of the port (``_restart_real`` / ``_restart_complex``) fed
    the JAX package's factorization: the new H and V within 1e-12 of the
    JAX package's restart."""
    n, nev, ncv = 100, 6, 20
    A = _rand_mat(n, complex_=complex_)
    v0 = SimpleRandom(0).random_vec(n, np.complex128 if complex_ else np.float64)
    jop = JArnoldiOp.create(st.DenseGenMatProd.create(A))
    pop = PArnoldiOp.create(stt.DenseGenMatProd.create(A, device=CPU))
    js = jkry.factorize_from(
        jop, jkry.init(jop, jnp.asarray(v0), ncv, jax.random.PRNGKey(0)), 1, "arnoldi"
    )
    ps = pkry.factorize_from(pop, pkry.init(pop, torch.from_numpy(v0), ncv), 1, "arnoldi")
    assert ps.H.dtype == (torch.complex128 if complex_ else torch.float64)
    np.testing.assert_allclose(ps.H.numpy(), np.asarray(js.H), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ps.V.numpy(), np.asarray(js.V), rtol=0, atol=1e-12)
    assert ps.nops == int(js.nops) and abs(ps.beta - float(js.beta)) < 1e-12

    ritz_val, ritz_est, _ = jcore._retrieve_ritzpair(js.H, st.SortRule.LargestMagn, nev)
    _, nconv = jcore._num_converged(ritz_val, ritz_est, js.beta, 1e-10, nev)
    k_new = int(jcore._nev_adjusted(nconv, ritz_val, ritz_est, nev, ncv))
    state = convert.krylov_state_from_numpy(
        np.asarray(js.V), np.asarray(js.H), np.asarray(js.f), float(js.beta),
        int(js.k), int(js.nops), device=CPU,
    )
    jrestart = jcore._restart_complex if complex_ else jcore._restart_real
    prestart = pcore._restart_complex if complex_ else pcore._restart_real
    want = jrestart(jop, js, ritz_val, k_new, ncv)
    got = prestart(pop, state, np.asarray(ritz_val), k_new, ncv)
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.V.numpy(), np.asarray(want.V), rtol=0, atol=1e-12)
    assert got.nops == int(want.nops)
    # the host rules agree on the JAX package's Ritz values
    pv, pe, _ = pcore._retrieve_ritzpair(np.asarray(js.H), stt.SortRule.LargestMagn, nev)
    np.testing.assert_array_equal(pv, np.asarray(ritz_val))
    assert pcore._nev_adjusted(nconv, pv, pe, nev, ncv, torch.float64) == k_new


def _config4(g):
    """``bench.py:272-300``: the 2-D convection-diffusion operator."""
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))
            + 0.3 * sps.kron(sps.eye(g), upw1)).tocsr()


def test_config4_shape_g16(monkeypatch):
    """Config #4's calls at g=16 (n=256): ``SparseGenMatProd.create``
    (DIA, the DIA kernel's plain version here), ``GenEigsSolver(op, 6,
    30)``, ``init(SimpleRandom(0))``, ``compute(LargestMagn, maxit=500,
    tol=1e-10)``. At g=16 the similarity ``diag(1.3^{i/2})`` that makes
    the spectrum real has condition number 1.3^7.5 ~ 7, so the computed
    values are the analytic ones within 1e-8."""
    g = 16
    A = _config4(g)
    v0 = SimpleRandom(0).random_vec(g * g)
    j, p = _pair(monkeypatch, _sparse, A, 6, 30, v0=v0, maxit=500, tol=1e-10)
    assert type(p._op.ell).__name__ == "DiaMatrix"
    assert p.info() == stt.CompInfo.Successful and _residual(A, p) < 1e-9
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-9)
    theta = np.arange(1, g + 1) * np.pi / (g + 1)
    exact = (4.3 - 2 * np.cos(theta)[:, None] - 2 * np.sqrt(1.3) * np.cos(theta)[None, :]).ravel()
    want = np.sort(exact)[::-1][:6]
    np.testing.assert_allclose(np.sort(p.eigenvalues().real)[::-1], want, atol=1e-8)


@pytest.mark.parametrize("driver", ["native", "torch"])
def test_gen_n1000(monkeypatch, driver):
    """``tests/test_robustness.py::TestReferenceSizeGridGen`` (a ``slow``
    case in the reference; seconds here): n=1000, k=10, ncv=30."""
    A = np.random.default_rng(7).uniform(size=(1000, 1000)) - 0.5
    _, p = _pair(monkeypatch, _dense, A, 10, 30, driver=driver)
    assert p.info() == stt.CompInfo.Successful and _residual(A, p) < 1e-9


# -- Krylov-Schur restarts (tests/test_gen_ks.py) ---------------------------

def _normal(n, seed):
    return np.random.default_rng(seed).normal(size=(n, n))


def test_ks_matches_implicit_restart_exactly(monkeypatch):
    """With exact shifts the two restarts are equivalent (Stewart 2001):
    the same counts, in the port as in the JAX package."""
    A = _normal(200, 0)
    runs = {}
    for method in ("implicit", "krylov_schur"):
        _, p = _pair(monkeypatch, _dense, A, 5, 16, maxit=500, restart=method)
        assert p.info() == stt.CompInfo.Successful
        runs[method] = p
    imp, ks = runs["implicit"], runs["krylov_schur"]
    assert (imp.num_iterations(), imp.num_operations()) == (
        ks.num_iterations(), ks.num_operations()
    )
    np.testing.assert_allclose(imp.eigenvalues(), ks.eigenvalues(), rtol=1e-8)


@pytest.mark.parametrize("rule", ["LargestMagn", "LargestReal"])
def test_ks_residuals(monkeypatch, rule):
    A = _normal(150, 3)
    _, p = _pair(monkeypatch, _dense, A, 4, 14, rule, maxit=500, restart="krylov_schur")
    assert _residual(A, p) < 1e-8


def test_ks_shift_invert_transform(monkeypatch):
    """The back-transform runs on the Krylov-Schur path too."""
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    A, sigma = _normal(120, 5), 0.3
    j = st.GenEigsRealShiftSolver(st.DenseGenRealShiftSolve.create(A), 3, 12, sigma)
    j.set_restart_method("krylov_schur")
    j.init()
    jn = j.compute(st.SortRule.LargestMagn, maxit=500, tol=1e-10)
    p = stt.GenEigsRealShiftSolver(stt.DenseGenRealShiftSolve.create(A, device=CPU), 3, 12,
                                   sigma)
    p.set_restart_method("krylov_schur")
    p.init()
    assert p.compute(stt.SortRule.LargestMagn, maxit=500, tol=1e-10) == jn == 3
    assert (p.num_iterations(), p.num_operations()) == (j.num_iterations(), j.num_operations())
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-10)
    assert _residual(A, p) < 1e-7


def test_ks_sparse_op(monkeypatch):
    M = sps.random(300, 300, density=0.03, random_state=np.random.default_rng(9),
                   format="csr") + sps.diags(np.linspace(1.0, 2.0, 300))
    _, p = _pair(monkeypatch, _sparse, M.tocsr(), 3, 12, maxit=500, restart="krylov_schur")
    assert _residual(M, p) < 1e-8


def test_ks_invalid_method_and_complex_rejected():
    A = _normal(30, 1)
    s = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=CPU), nev=2, ncv=8)
    with pytest.raises(ValueError):
        s.set_restart_method("bogus")
    C = A + 1j * _normal(30, 2)
    sc = stt.GenEigsSolver(stt.DenseGenMatProd.create(C, device=CPU), nev=2, ncv=8)
    sc.set_restart_method("krylov_schur")
    sc.init()
    with pytest.raises(ValueError):
        sc.compute(stt.SortRule.LargestMagn)


def test_ks_matvec_granularity_matches(monkeypatch):
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    A = np.random.default_rng(11).uniform(size=(150, 150)) - 0.5
    v0 = SimpleRandom(0).random_vec(150)
    runs = []
    for stepped in (False, True):
        s = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=CPU), nev=4, ncv=12)
        s.set_restart_method("krylov_schur")
        s.set_matvec_granularity(stepped)
        s.init(v0)
        assert s.compute(stt.SortRule.LargestMagn) == 4
        runs.append(s)
    assert (runs[0].num_iterations(), runs[0].num_operations()) == (
        runs[1].num_iterations(), runs[1].num_operations()
    )
    np.testing.assert_array_equal(runs[0].eigenvalues(), runs[1].eigenvalues())


def test_ks_locking_hard_spectrum(monkeypatch):
    """Locked Schur blocks stay exact while the clustered tail converges:
    every eigenpair matches numpy within 1e-7 (complex pairs included)."""
    n = 250
    rng = np.random.default_rng(42)
    D = np.zeros((n, n))
    c, s = np.cos(0.6), np.sin(0.6)
    D[:2, :2] = 50.0 * np.array([[c, -s], [s, c]])
    D[2:4, 2:4] = 40.0 * np.array([[c, s], [-s, c]])
    D[4, 4] = -30.0
    D[5:, 5:] = np.diag(1.0 + 0.01 * rng.standard_normal(n - 5))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ D @ Q.T
    _, p = _pair(monkeypatch, _dense, A, 6, 16, v0=SimpleRandom(0).random_vec(n),
                 maxit=500, restart="krylov_schur")
    assert len(p.eigenvalues()) >= 6
    w = np.linalg.eigvals(A)
    want = np.sort_complex(w[np.argsort(-np.abs(w))[:6]])[-6:]
    np.testing.assert_allclose(np.sort_complex(p.eigenvalues())[-6:], want, atol=1e-7)


# -- the real embedding (tests/test_gen_embed.py) ---------------------------

def _rand_complex(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))


def _embed_pair(C, k, ncv, rule="LargestMagn", maxit=500, tol=1e-12, v0=None,
                sorting=None):
    """Both packages' embedded solve of C; returns the port's solver
    after checking nconv, info, values (1e-10) and counts."""
    sorting = getattr(st.SortRule, sorting) if sorting else None
    j = st.GenEigsSolver(JEmbed.create(C), nev=k, ncv=ncv)
    j.init(v0)
    jn = j.compute(getattr(st.SortRule, rule), maxit, tol, sorting)
    p = stt.GenEigsSolver(stt.RealEmbeddedGenMatProd.create(C, device=CPU), nev=k, ncv=ncv)
    p.init(v0)
    pn = p.compute(getattr(stt.SortRule, rule), maxit, tol,
                   None if sorting is None else getattr(stt.SortRule, sorting.name))
    assert pn == jn and p.info().name == j.info().name
    np.testing.assert_allclose(np.sort_complex(p.eigenvalues()),
                               np.sort_complex(np.asarray(j.eigenvalues())), atol=1e-10)
    assert (p.num_iterations(), p.num_operations()) == (j.num_iterations(), j.num_operations())
    return p


def _check_embedded(C, p, k, rule, atol=1e-8):
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    assert len(vals) == k
    Cd = C.toarray() if sps.issparse(C) else C
    assert np.abs(Cd @ vecs - vecs * vals[None, :]).max() < atol
    w = np.linalg.eigvals(Cd)
    key = np.abs if rule == "LargestMagn" else np.real
    want = w[np.argsort(-key(w))][:k]
    np.testing.assert_allclose(np.sort(key(vals)), np.sort(key(want)), atol=atol)


@pytest.mark.parametrize("rule", ["LargestMagn", "LargestReal"])
def test_embedded_dense_complex(rule):
    C = _rand_complex(60, 3)
    p = _embed_pair(C, 4, 16, rule, sorting=rule)
    _check_embedded(C, p, 4, rule)


def test_embedded_sparse_complex():
    n, k = 200, 5
    rng = np.random.default_rng(11)
    C = sps.random(n, n, density=0.05, random_state=4, format="csr")
    C = C + 1j * sps.random(n, n, density=0.05, random_state=5, format="csr")
    C = (C + sps.diags(3.0 + rng.normal(size=n))).tocsr()
    p = _embed_pair(C, k, 30, maxit=800)
    _check_embedded(C, p, k, "LargestMagn")


def test_embedded_matches_direct_complex_solver():
    C = _rand_complex(80, 17)
    direct = stt.GenEigsSolver(stt.DenseGenMatProd.create(C, device=CPU), nev=4, ncv=24)
    direct.init()
    direct.compute(stt.SortRule.LargestMagn, maxit=500, tol=1e-12)
    emb = _embed_pair(C, 4, 24)
    np.testing.assert_allclose(np.sort(np.abs(direct.eigenvalues())),
                               np.sort(np.abs(emb.eigenvalues())), atol=1e-9)


def test_embedded_real_eigenvalue_matrix():
    rng = np.random.default_rng(23)
    n = 50
    d = np.diag(np.linspace(1.0, 5.0, n))
    S = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)) * 0.1
    C = np.linalg.solve(S, d @ S)
    p = _embed_pair(C, 3, 20, maxit=800)
    np.testing.assert_allclose(np.sort(p.eigenvalues().real)[::-1],
                               np.linspace(1.0, 5.0, n)[::-1][:3], atol=1e-7)
    assert np.abs(p.eigenvalues().imag).max() < 1e-7


def test_embedded_complex_v0_realifies():
    C = _rand_complex(40, 31)
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=40) + 1j * rng.normal(size=40)
    p = _embed_pair(C, 3, 16, tol=1e-11, v0=v0)
    assert len(p.eigenvalues()) == 3


def test_embedded_largest_imag():
    """LargestImag through the rotated embedding returns C's true
    largest-imaginary eigenvalues, not phantoms."""
    C = _rand_complex(60, 41) - 3.0j * np.eye(60)
    p = _embed_pair(C, 3, 28, "LargestImag", maxit=800, sorting="LargestImag")
    w = np.linalg.eigvals(C)
    np.testing.assert_allclose(np.sort(p.eigenvalues().imag)[::-1],
                               np.sort(w.imag)[::-1][:3], atol=1e-8)
    assert np.abs(p.eigenvalues()[:, None] - w[None, :]).min(axis=1).max() < 1e-8


def test_embedded_operators_match_jax():
    C = _rand_complex(12, 2)
    x = np.random.default_rng(1).normal(size=24)
    for make in (lambda M: M, sps.csr_matrix):
        jop = JEmbed.create(make(C))
        pop = stt.RealEmbeddedGenMatProd.create(make(C), device=CPU)
        np.testing.assert_allclose(pop.perform_op(torch.from_numpy(x)).numpy(),
                                   np.asarray(jop.perform_op(jnp.asarray(x))), atol=1e-13)
        rot = stt.RotatedEmbeddedGenMatProd(embed=pop)
        from spectra_tpu.matop.gen_embed import RotatedEmbeddedGenMatProd as JRot
        np.testing.assert_allclose(rot.perform_op(torch.from_numpy(x)).numpy(),
                                   np.asarray(JRot(embed=jop).perform_op(jnp.asarray(x))),
                                   atol=1e-13)
        assert (pop.rows(), pop.cols(), pop.n_orig, rot.n_orig) == (24, 24, 12, 12)
