"""The port's Hessenberg, Schur and Ritz-extraction kernels against the
JAX package, on the CPU.

Cases of ``tests/test_hessenberg.py``, ``tests/test_schur.py``,
``tests/test_schur_reorder.py`` and ``tests/test_native_eigen.py``,
plus ``givens_rotation_complex``. The port runs these (ncv, ncv)
kernels on the host in numpy; the JAX package in XLA on the CPU.

Tolerances: a sweep's H and Q agree with the JAX outputs within 1e-13
times max(1, |H|). With an exact double shift (an eigenvalue pair of H,
as the restarts use) the chase is forward unstable: once the block
deflates its entries follow rounding, so both packages are held to what
they mean instead (the similarity, the deflation, the spectrum of the
trailing and the leading blocks). The Schur forms are compared by their
eigenvalues (1e-8, the reference test's own bar) and their defining
properties; ``schur_reorder``
is numpy in both packages and must agree bitwise; the LAPACK route of
``hessenberg_eigen`` must agree bitwise (the same ``numpy.linalg.eig``
call), the native route within 1e-8 with exact conjugate pairs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import spectra_tpu as st
from spectra_tpu.linalg import givens as jgiv
from spectra_tpu.linalg import hessenberg as jh
from spectra_tpu.linalg import hessenberg_eigen as jhe
from spectra_tpu.linalg import schur as jschur
from spectra_tpu.linalg import schur_reorder as jreorder
from spectra_tpu.native import dense_eigs as jnd
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import givens as pgiv
from spectra_tpu_torch.linalg import hessenberg as ph
from spectra_tpu_torch.linalg import hessenberg_eigen as phe
from spectra_tpu_torch.linalg import schur as pschur
from spectra_tpu_torch.linalg import schur_reorder as preorder
from spectra_tpu_torch.native import dense_eigs as pnd

CPU = "cpu"


def _rand_hess(m, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(m, m))
    if complex_:
        H = H + 1j * rng.normal(size=(m, m))
    return np.triu(H, -1)


def _close(got, want, H, tol=1e-13):
    np.testing.assert_allclose(
        got, np.asarray(want), rtol=0, atol=tol * max(1.0, np.abs(H).max())
    )


def _check_similarity(H, H_new, Q, atol=1e-12):
    m = H.shape[0]
    np.testing.assert_allclose(Q.conj().T @ Q, np.eye(m), atol=atol)
    np.testing.assert_allclose(Q.conj().T @ H @ Q, H_new, atol=atol)
    assert np.abs(np.tril(H_new, -2)).max() == 0.0, "not Hessenberg"


@pytest.mark.parametrize(
    "x,y",
    [(3.0 + 1j, -2.0 + 0.5j), (1e-300j, 4.0), (0.0, 2.0 - 3.0j), (0.0, 0.0),
     (-5.0, 0.0), (2.5 - 1j, 1e200 + 1j)],
)
def test_givens_rotation_complex_matches_jax(x, y):
    want = [complex(v) for v in jgiv.givens_rotation_complex(
        jnp.asarray(x, jnp.complex128), jnp.asarray(y, jnp.complex128))]
    c, s, r = pgiv.givens_rotation_complex(x, y)
    np.testing.assert_allclose([c, s, r], want, rtol=1e-15, atol=0)
    assert isinstance(c, float)
    # G^H [x, y] = [r, 0] with the hessenberg.py convention
    assert abs(np.conj(s) * x + c * y) <= 1e-15 * max(abs(x), abs(y), 1e-300)
    assert abs(c * x - s * y - r) <= 1e-15 * max(abs(r), 1e-300)


@pytest.mark.parametrize("m", [6, 20, 60])
def test_hessenberg_qr_real_matches_jax(m):
    H = _rand_hess(m, seed=m)
    H_new, Q = ph.hessenberg_qr(H, 0.37)
    want_H, want_Q = jh.hessenberg_qr(jnp.asarray(H), 0.37)
    _close(H_new, want_H, H)
    _close(Q, want_Q, H)
    _check_similarity(H, H_new, Q)


@pytest.mark.parametrize("m", [6, 24])
def test_hessenberg_qr_complex_matches_jax(m):
    H = _rand_hess(m, seed=m, complex_=True)
    H_new, Q = ph.hessenberg_qr(H, 0.2 - 0.5j)
    want_H, want_Q = jh.hessenberg_qr(jnp.asarray(H), 0.2 - 0.5j)
    _close(H_new, want_H, H)
    _close(Q, want_Q, H)
    _check_similarity(H, H_new, Q)


def test_hessenberg_qr_exact_shift_deflates():
    m = 12
    H = _rand_hess(m, seed=3)
    lam = np.linalg.eigvals(H)
    mu = float(lam[np.abs(lam.imag) < 1e-12][0].real)
    H_new, Q = ph.hessenberg_qr(H, mu)
    want_H, want_Q = jh.hessenberg_qr(jnp.asarray(H), mu)
    assert abs(H_new[m - 1, m - 2]) < 1e-8
    np.testing.assert_allclose(H_new[m - 1, m - 1], mu, atol=1e-8)
    _close(H_new, want_H, H)
    _close(Q, want_Q, H)
    _check_similarity(H, H_new, Q)


@pytest.mark.parametrize("m", [6, 20, 30])
def test_double_shift_qr_generic_pair_matches_jax(m):
    H = _rand_hess(m, seed=m + 100)
    H_new, Q = ph.double_shift_qr(H, 0.7, 2.0)
    want_H, want_Q = jh.double_shift_qr(jnp.asarray(H), 0.7, 2.0)
    _close(H_new, want_H, H)
    _close(Q, want_Q, H)
    _check_similarity(H, H_new, Q, atol=1e-10)


@pytest.mark.parametrize("m", [6, 20, 60])
def test_double_shift_qr_exact_pair(m):
    """``tests/test_hessenberg.py::test_double_shift_qr``: an exact pair
    (as a restart's shifts are) deflates into the trailing 2x2 block. The
    sweep's entries then depend on rounding (the exact-shift chase is
    forward unstable: 1e-9 apart from the JAX outputs at m=20), so both
    packages are held to the similarity and, at m <= 20, the deflation
    and the same spectrum of the leading block (1e-8)."""
    H = _rand_hess(m, seed=m + 100)
    lam = np.linalg.eigvals(H)
    cplx = lam[lam.imag > 1e-9]
    mu = cplx[np.argmax(np.abs(cplx))]
    s, t = 2 * mu.real, abs(mu) ** 2
    H_new, Q = ph.double_shift_qr(H, s, t)
    want_H, _ = jh.double_shift_qr(jnp.asarray(H), s, t)
    want_H = np.asarray(want_H)
    _check_similarity(H, H_new, Q, atol=1e-10)
    if m > 20:
        return  # the reference holds m=60 to the similarity only
    k = m - 2
    for got in (H_new, want_H):
        assert abs(got[k, k - 1]) < 1e-7 * max(1.0, np.abs(H).max())
        np.testing.assert_allclose(
            np.sort_complex(np.linalg.eigvals(got[k:, k:])),
            np.sort_complex([mu.conj(), mu]), atol=1e-7,
        )
    np.testing.assert_allclose(
        np.sort_complex(np.round(np.linalg.eigvals(H_new[:k, :k]), 8)),
        np.sort_complex(np.round(np.linalg.eigvals(want_H[:k, :k]), 8)), atol=1e-8,
    )


def test_double_shift_exact_pair_deflates():
    m = 10
    H = _rand_hess(m, seed=17)
    mu = np.linalg.eigvals(H)
    mu = mu[mu.imag > 1e-9][0]
    H_new, _ = ph.double_shift_qr(H, 2 * mu.real, abs(mu) ** 2)
    assert abs(H_new[m - 2, m - 3]) < 1e-7
    np.testing.assert_allclose(
        np.sort_complex(np.linalg.eigvals(H_new[m - 2 :, m - 2 :])),
        np.sort_complex([mu.conj(), mu]), atol=1e-7,
    )


def test_double_shift_with_deflated_blocks():
    """H with an exact internal zero subdiagonal (two blocks): the sweep
    re-seeds at the boundary, as in the JAX package."""
    m = 12
    H = _rand_hess(m, seed=23)
    H[6, 5] = 0.0
    mu = np.linalg.eigvals(H)
    mu = mu[mu.imag > 1e-9][0]
    H_new, Q = ph.double_shift_qr(H, 2 * mu.real, abs(mu) ** 2)
    _check_similarity(H, H_new, Q, atol=1e-10)
    assert abs(H_new[6, 5]) < 1e-12
    want_H, _ = jh.double_shift_qr(jnp.asarray(H), 0.7, 2.0)
    got_H, _ = ph.double_shift_qr(H, 0.7, 2.0)
    _close(got_H, want_H, H)


def test_householder3_matches_jax():
    eps = np.finfo(np.float64).eps
    for x in ([1.0, 0.45, 0.045], [-1.0, 0.2, -0.7], [1.0, 1e-20, 0.0], [0.0, 0.0, 0.0]):
        want = np.asarray(jh._householder3(jnp.asarray(x), eps))
        np.testing.assert_allclose(ph._householder3(np.asarray(x), eps), want,
                                   rtol=0, atol=1e-15)


def test_clip_to_hessenberg():
    M = np.arange(25.0).reshape(5, 5)
    C = ph.clip_to_hessenberg(M)
    np.testing.assert_array_equal(C, np.asarray(jh.clip_to_hessenberg(jnp.asarray(M))))
    assert np.abs(np.tril(C, -2)).max() == 0


@pytest.mark.parametrize("m", [10, 30, 100])
def test_schur_decomposition(m):
    H = _rand_hess(m, seed=m)
    res = pschur.hessenberg_schur(H)
    assert res.converged, f"not converged in {res.n_iter} iterations"
    T, U = res.T, res.U
    np.testing.assert_allclose(U.T @ U, np.eye(m), atol=1e-11)
    np.testing.assert_allclose(U @ T @ U.T, H, atol=1e-10)
    sub = np.diag(T, -1)
    assert not np.any((sub[:-1] != 0) & (sub[1:] != 0))
    assert np.abs(np.tril(T, -2)).max() == 0
    want = jschur.hessenberg_schur(jnp.asarray(H))
    np.testing.assert_allclose(
        np.sort_complex(np.round(pschur.schur_eigenvalues(T), 8)),
        np.sort_complex(np.round(np.asarray(jschur.schur_eigenvalues(want.T)), 8)),
        atol=1e-8,
    )


@pytest.mark.parametrize("m", [10, 40])
def test_schur_eigenvalues(m):
    H = _rand_hess(m, seed=m + 7)
    res = pschur.hessenberg_schur(H)
    assert res.converged
    np.testing.assert_allclose(
        np.sort_complex(np.round(pschur.schur_eigenvalues(res.T), 8)),
        np.sort_complex(np.round(np.linalg.eigvals(H), 8)), atol=1e-7,
    )
    # the same quasi-triangular T gives the same values in both packages
    np.testing.assert_allclose(
        pschur.schur_eigenvalues(res.T),
        np.asarray(jschur.schur_eigenvalues(jnp.asarray(res.T))), rtol=0, atol=1e-14,
    )


def test_schur_already_triangular():
    T = np.triu(np.random.default_rng(1).normal(size=(8, 8)))
    res = pschur.hessenberg_schur(T)
    assert res.converged and res.n_iter == 0
    np.testing.assert_array_equal(res.T, T)
    assert int(jschur.hessenberg_schur(jnp.asarray(T)).n_iter) == 0


def test_schur_with_multiple_blocks():
    m = 20
    H = _rand_hess(m, seed=3)
    H[10, 9] = 0.0
    res = pschur.hessenberg_schur(H)
    assert res.converged
    np.testing.assert_allclose(
        np.sort_complex(np.round(pschur.schur_eigenvalues(res.T), 8)),
        np.sort_complex(np.round(np.linalg.eigvals(H), 8)), atol=1e-7,
    )


def _random_schur(m, seed):
    H = _rand_hess(m, seed)
    res = jschur.hessenberg_schur(jnp.asarray(H))
    assert bool(res.converged)
    return H, np.asarray(res.T), np.asarray(res.U)


@pytest.mark.parametrize("m,seed", [(10, 0), (20, 1), (30, 2)])
def test_reorder_largest_magnitude(m, seed):
    H, T, U = _random_schur(m, seed)
    lam = np.asarray(jschur.schur_eigenvalues(jnp.asarray(T)))
    select = np.zeros(m, bool)
    select[np.argsort(-np.abs(lam), kind="stable")[:4]] = True
    T2, U2, k = preorder.schur_reorder(T, U, select)
    jT2, jU2, jk = jreorder.schur_reorder(T, U, select)
    assert k == jk >= 4
    np.testing.assert_array_equal(T2, jT2)
    np.testing.assert_array_equal(U2, jU2)
    np.testing.assert_allclose(U2.T @ U2, np.eye(m), atol=1e-11)
    np.testing.assert_allclose(U2 @ T2 @ U2.T, H, atol=1e-9)
    lead = pschur.schur_eigenvalues(T2[:k, :k])
    for w in lam[select]:
        assert np.min(np.abs(lead - w)) < 1e-7


def test_reorder_selects_smallest():
    H, T, U = _random_schur(16, 5)
    lam = pschur.schur_eigenvalues(T)
    select = np.zeros(16, bool)
    select[np.argsort(np.abs(lam), kind="stable")[:3]] = True
    T2, U2, k = preorder.schur_reorder(T, U, select)
    np.testing.assert_allclose(U2 @ T2 @ U2.T, H, atol=1e-9)
    lead = pschur.schur_eigenvalues(T2[:k, :k])
    for w in lam[select]:
        assert np.min(np.abs(lead - w)) < 1e-7


def test_block_partition():
    T = np.diag([1.0, 2.0, 3.0, 4.0])
    T[2, 1], T[1, 2] = 0.5, -0.5
    assert preorder._block_starts(T) == jreorder._block_starts(T) == [(0, 1), (1, 2), (3, 1)]


def test_invariant_subspace_property():
    m = 24
    H, T, U = _random_schur(m, 7)
    lam = pschur.schur_eigenvalues(T)
    select = np.zeros(m, bool)
    select[np.argsort(-lam.real, kind="stable")[:5]] = True
    T2, U2, k = preorder.schur_reorder(T, U, select)
    Vk = U2[:, :k]
    assert np.abs(H @ Vk - Vk @ T2[:k, :k]).max() < 1e-9


@pytest.mark.parametrize("m", [8, 30])
def test_complexify_schur(m):
    H = _rand_hess(m, seed=m)
    res = pschur.hessenberg_schur(H)
    Tc, Uc = pschur.complexify_schur(res.T, res.U)
    assert np.abs(np.tril(Tc, -1)).max() == 0
    np.testing.assert_allclose(Uc.conj().T @ Uc, np.eye(m), atol=1e-11)
    np.testing.assert_allclose(Uc @ Tc @ Uc.conj().T, H, atol=1e-10)
    jTc, jUc = jschur.complexify_schur(jnp.asarray(res.T), jnp.asarray(res.U))
    _close(Tc, jTc, H, tol=1e-12)
    _close(Uc, jUc, H, tol=1e-12)


@pytest.mark.parametrize("m", [10, 40])
def test_complex_schur(m):
    H = _rand_hess(m, seed=m, complex_=True)
    res = pschur.hessenberg_schur_complex(H)
    assert res.converged
    T, U = res.T, res.U
    assert np.abs(np.tril(T, -1)).max() == 0
    np.testing.assert_allclose(U.conj().T @ U, np.eye(m), atol=1e-11)
    np.testing.assert_allclose(U @ T @ U.conj().T, H, atol=1e-10)
    want = jschur.hessenberg_schur_complex(jnp.asarray(H))
    np.testing.assert_allclose(
        np.sort_complex(np.round(np.diag(T), 8)),
        np.sort_complex(np.round(np.diag(np.asarray(want.T)), 8)), atol=1e-8,
    )


def test_triangular_eigenvectors():
    m = 20
    rng = np.random.default_rng(5)
    T = np.triu(rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m)))
    Y = pschur.triangular_eigenvectors(T)
    assert np.abs(T @ Y - Y * np.diag(T)[None, :]).max() < 1e-10
    np.testing.assert_allclose(np.linalg.norm(Y, axis=0), np.ones(m), atol=1e-12)
    _close(Y, jschur.triangular_eigenvectors(jnp.asarray(T)), T, tol=1e-12)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("m", [12, 35])
def test_native_eigen_pairs(m, complex_):
    H = _rand_hess(m, seed=m + 1, complex_=complex_)
    evals, evecs = pschur.hessenberg_eigen_native(H)
    assert np.abs(H @ evecs - evecs * evals[None, :]).max() < 1e-9
    want, _ = jschur.hessenberg_eigen_native(jnp.asarray(H))
    np.testing.assert_allclose(
        np.sort_complex(np.round(evals, 8)),
        np.sort_complex(np.round(np.asarray(want), 8)), atol=1e-7,
    )
    if not complex_:
        for i in range(m - 1):
            if evals[i].imag > 0:
                assert evals[i + 1] == np.conj(evals[i])


@pytest.mark.parametrize("backend", ["auto", "lapack", "native"])
@pytest.mark.parametrize("complex_", [False, True])
def test_hessenberg_eigen_backends(monkeypatch, backend, complex_):
    """The LAPACK route is the JAX package's CPU route bit for bit; the
    native route agrees within 1e-8; real H gives exact, adjacent
    conjugate pairs on both."""
    H = _rand_hess(20, seed=4, complex_=complex_)
    monkeypatch.setenv("SPECTRA_TPU_EIGEN_BACKEND", backend)
    w, v = phe.hessenberg_eigen(H)
    assert w.dtype == v.dtype == np.complex128
    if backend == "native":
        ww, _ = jschur.hessenberg_eigen_native(jnp.asarray(H))
        np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(np.asarray(ww)),
                                   atol=1e-8)
    else:
        jw, jv = jhe.hessenberg_eigen_lapack(jnp.asarray(H))
        np.testing.assert_array_equal(w, np.asarray(jw))
        np.testing.assert_array_equal(v, np.asarray(jv))
    assert np.abs(H @ v - v * w[None, :]).max() < 1e-9
    if not complex_:
        i = 0
        while i < len(w):
            if w[i].imag != 0:
                assert w[i + 1] == np.conj(w[i])
                i += 2
            else:
                i += 1


def test_hessenberg_eigen_backend_rejects_unknown(monkeypatch):
    monkeypatch.setenv("SPECTRA_TPU_EIGEN_BACKEND", "bogus")
    with pytest.raises(ValueError, match="SPECTRA_TPU_EIGEN_BACKEND"):
        phe.hessenberg_eigen(np.eye(3))


@pytest.mark.parametrize("driver", [("auto", "auto"), ("torch", "jax")])
@pytest.mark.parametrize("complex_", [False, True])
def test_gen_solver_native_eigen_backend(monkeypatch, driver, complex_):
    """``tests/test_native_eigen.py::TestGenSolverNativeBackend``: the
    solver with the native Ritz extraction, on the dense driver ``auto``
    (a real f64 matrix goes to the native Krylov-Schur driver) and on the
    IRAM, against the JAX package under the same settings."""
    monkeypatch.setenv("SPECTRA_TPU_EIGEN_BACKEND", "native")
    if complex_:
        rng = np.random.RandomState(7)
        A = (rng.uniform(size=(50, 50)) - 0.5) + 1j * (rng.uniform(size=(50, 50)) - 0.5)
        nev, ncv = 4, 16
    else:
        A = np.random.RandomState(123).uniform(size=(80, 80)) - 0.5
        nev, ncv = 5, 20
    ours, theirs = driver
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", theirs)
    j = st.GenEigsSolver(st.DenseGenMatProd.create(A), nev=nev, ncv=ncv)
    j.init()
    jn = j.compute(st.SortRule.LargestMagn)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", ours)
    p = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=CPU), nev=nev, ncv=ncv)
    p.init()
    pn = p.compute(stt.SortRule.LargestMagn)
    assert pn == jn == nev and p.info() == stt.CompInfo.Successful
    assert p.info().name == j.info().name
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-10)
    assert (p.num_iterations(), p.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9


def test_native_degenerate_complex_pairs():
    """``tests/test_native_eigen.py::test_native_degenerate_complex_pairs``
    on the port's copy of the driver: two conjugate pairs with identical
    eigenvalues do not cross-match; counts equal the JAX package's."""
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s], [s, c]])
    A = np.zeros((10, 10))
    A[:2, :2] = 1.3 * R
    A[2:4, 2:4] = 1.3 * R
    A[4:, 4:] = np.diag([0.9, 0.5, 0.3, -0.2, 0.1, -0.05])
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((10, 10)))
    A = Q @ A @ Q.T
    v0 = rng.standard_normal(10)
    rc, out = pnd.dense_eigs(A, 4, 9, 0, False, 1e-10, 2000, v0)
    want = jnd.dense_eigs(A, 4, 9, 0, False, 1e-10, 2000, v0)
    assert rc == 0 and out["nconv"] == int(want["nconv"]) == 4
    assert (out["niter"], out["nops"]) == (int(want["niter"]), int(want["nops"]))
    w, V = out["values"], out["vectors"]
    np.testing.assert_allclose(w, want["values"], atol=1e-12)
    assert np.abs(A @ V - V * w[None, :]).max(axis=0)[:4].max() < 1e-8
