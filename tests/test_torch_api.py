"""The port's scipy-style frontends (``spectra_tpu_torch/api.py``:
``eigsh``, ``eigs``, ``svds``, ``NoConvergence``) against the JAX
package's: the 14 cases of ``tests/test_api.py``.

Each case calls both packages on the same seeded matrices (the port with
``device="cpu"``), holds the port to the reference test's assertions,
and its results to the JAX package's within the reference test's own
tolerance: the same number of pairs, the same ``NoConvergence`` subset.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt

CPU = dict(device="cpu")


def _sym(n, seed=123):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 0.5, size=(n, n))
    return A + A.T


def _spd(n, seed=7):
    rng = np.random.default_rng(seed)
    B = rng.uniform(-0.5, 0.5, size=(n, n))
    return B @ B.T + n * np.eye(n)


def _both(name, *args, **kw):
    """(port result, JAX result) of the frontend ``name``."""
    port = getattr(stt, name)(*args, **kw, **CPU)
    ref = getattr(st, name)(*args, **kw)
    return port, ref


def _close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_eigsh_dense_largest_matches_numpy():
    A = _sym(100)
    (w, v), (jw, _) = _both("eigsh", A, k=5, which="LA")
    wt = np.linalg.eigvalsh(A)
    assert w.shape == (5,) and v.shape == (100, 5)
    assert isinstance(w, np.ndarray) and isinstance(v, np.ndarray)
    assert np.all(np.diff(w) >= 0)  # scipy's ascending order
    np.testing.assert_allclose(w, wt[-5:], atol=1e-9)
    _close(w, jw, 1e-9)
    assert np.abs(A @ v - v * w[None, :]).max() < 1e-9


@pytest.mark.parametrize("which", ["LM", "SA", "BE"])
def test_eigsh_which_rules(which):
    A = _sym(60)
    w, jw = _both("eigsh", A, k=4, which=which, return_eigenvectors=False)
    wt = np.linalg.eigvalsh(A)
    if which == "LM":
        expect = wt[np.argsort(np.abs(wt))[-4:]]
    elif which == "SA":
        expect = wt[:4]
    else:  # BE: 2 from each end
        expect = np.concatenate([wt[:2], wt[-2:]])
    np.testing.assert_allclose(np.sort(w), np.sort(expect), atol=1e-9)
    _close(w, jw, 1e-9)


def test_eigsh_sparse_shift_invert_matches_scipy():
    g = 12
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    A = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    sigma = 0.3
    (w, v), (jw, _) = _both("eigsh", A, k=4, sigma=sigma)
    ws = spla.eigsh(A, k=4, sigma=sigma, return_eigenvectors=False)
    np.testing.assert_allclose(w, np.sort(ws), atol=1e-9)
    _close(w, jw, 1e-9)
    assert np.abs(A @ v - v * w[None, :]).max() < 1e-8


def test_eigsh_generalized_cholesky():
    A, B = _sym(50), _spd(50)
    (w, v), (jw, _) = _both("eigsh", A, k=3, M=B, which="LA")
    wt = np.sort(np.real(np.linalg.eigvals(np.linalg.solve(B, A))))
    np.testing.assert_allclose(w, wt[-3:], atol=1e-8)
    _close(w, jw, 1e-8)
    assert np.abs(A @ v - (B @ v) * w[None, :]).max() < 1e-8


@pytest.mark.parametrize("mode", ["normal", "buckling", "cayley"])
def test_eigsh_generalized_shift_modes(mode):
    A, B = _spd(40, seed=3), _spd(40, seed=4)
    sigma = 1.0
    (w, v), (jw, _) = _both("eigsh", A, k=3, M=B, sigma=sigma, mode=mode)
    assert np.abs(A @ v - (B @ v) * w[None, :]).max() < 1e-8
    _close(w, jw, 1e-8)
    wt = np.real(np.linalg.eigvals(np.linalg.solve(B, A)))
    if mode == "buckling":
        assert w.shape == (3,)
    else:
        expect = wt[np.argsort(np.abs(wt - sigma))[:3]]
        np.testing.assert_allclose(np.sort(w), np.sort(expect), atol=1e-8)


def test_eigsh_complex_hermitian():
    rng = np.random.default_rng(5)
    H = rng.normal(size=(40, 40)) + 1j * rng.normal(size=(40, 40))
    H = H + H.conj().T
    (w, v), (jw, _) = _both("eigsh", H, k=3, which="LA")
    wt = np.linalg.eigvalsh(H)
    np.testing.assert_allclose(w, wt[-3:], atol=1e-8)
    _close(w, jw, 1e-8)
    assert v.dtype == np.complex128
    assert np.abs(H @ v - v * w[None, :]).max() < 1e-8


def test_eigsh_operator_passthrough():
    A = _sym(80)
    op = stt.DenseSymMatProd.create(A, **CPU)
    w = stt.eigsh(op, k=3, which="LA", return_eigenvectors=False)
    jw = st.eigsh(st.DenseSymMatProd.create(A), k=3, which="LA",
                  return_eigenvectors=False)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A)[-3:], atol=1e-9)
    _close(w, jw, 1e-9)
    # an operator keeps its own device: no device argument is needed
    assert stt.eigsh(op, k=3, which="LA", return_eigenvectors=False).shape == (3,)


def test_eigsh_no_convergence_partial_results():
    A = _sym(200, seed=9)
    errs = []
    for mod, dev in ((stt, CPU), (st, {})):
        with pytest.raises(mod.NoConvergence) as ei:
            mod.eigsh(A, k=6, ncv=7, maxiter=1, which="LA", **dev)
        errs.append(ei.value)
    err, jerr = errs
    assert err.eigenvalues.shape[0] < 6
    assert err.eigenvalues.shape == jerr.eigenvalues.shape
    assert err.eigenvectors.shape == (200, err.eigenvalues.shape[0])
    _close(err.eigenvalues, jerr.eigenvalues, 1e-8)
    if err.eigenvalues.size:
        wt = np.linalg.eigvalsh(A)
        for lam in err.eigenvalues:
            assert np.abs(wt - lam).min() < 1e-8


def test_eigsh_validation_errors():
    A = _sym(20)
    for mod, dev in ((stt, CPU), (st, {})):
        with pytest.raises(ValueError):
            mod.eigsh(A, k=0, **dev)
        with pytest.raises(ValueError):
            mod.eigsh(A, k=3, which="XX", **dev)
        with pytest.raises(ValueError):
            mod.eigsh(A, k=3, M=np.eye(20), mode="buckling", **dev)


def test_eigs_general_matches_scipy():
    rng = np.random.default_rng(11)
    A = rng.uniform(-0.5, 0.5, size=(80, 80))
    (w, v), (jw, _) = _both("eigs", A, k=4, which="LM")
    wt = np.linalg.eigvals(A)
    expect = wt[np.argsort(-np.abs(wt))[:4]]
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(expect), atol=1e-8)
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(jw), atol=1e-8)
    assert np.abs(A @ v - v * w[None, :]).max() < 1e-8


def _match_up_to_conj(w, expect, atol):
    for lam in w:
        assert np.minimum(np.abs(expect - lam), np.abs(expect - np.conj(lam))).min() < atol


def test_eigs_real_shift():
    rng = np.random.default_rng(13)
    A = rng.uniform(-0.5, 0.5, size=(60, 60))
    sigma = 0.1
    w, jw = _both("eigs", A, k=3, sigma=sigma, return_eigenvectors=False)
    wt = np.linalg.eigvals(A)
    expect = wt[np.argsort(np.abs(wt - sigma))[:3]]
    _match_up_to_conj(w, expect, 1e-8)
    assert w.shape == jw.shape
    _match_up_to_conj(w, jw, 1e-8)


def test_eigs_complex_shift():
    rng = np.random.default_rng(17)
    A = rng.uniform(-0.5, 0.5, size=(60, 60))
    sigma = 0.1 + 0.2j
    w, jw = _both("eigs", A, k=3, sigma=sigma, return_eigenvectors=False)
    wt = np.linalg.eigvals(A)
    d = np.minimum(np.abs(wt - sigma), np.abs(wt - np.conj(sigma)))
    expect = wt[np.argsort(d)[:3]]
    _match_up_to_conj(w, expect, 1e-7)
    assert w.shape == jw.shape
    _match_up_to_conj(w, jw, 1e-7)


def test_svds_matches_numpy():
    rng = np.random.default_rng(19)
    A = rng.normal(size=(60, 40))
    (u, s, vh), (_, js, _) = _both("svds", A, k=4)
    st_true = np.linalg.svd(A, compute_uv=False)
    assert np.all(np.diff(s) >= 0)  # scipy's ascending order
    np.testing.assert_allclose(s, np.sort(st_true[:4]), atol=1e-9)
    _close(s, js, 1e-9)
    np.testing.assert_allclose(A @ vh.conj().T, u * s[None, :], atol=1e-8)
    s_only, js_only = _both("svds", sps.csr_matrix(A), k=4, return_singular_vectors=False)
    np.testing.assert_allclose(s_only, s, atol=1e-9)
    _close(s_only, js_only, 1e-9)


def test_svds_operator_passthrough():
    rng = np.random.default_rng(23)
    A = rng.normal(size=(50, 30))
    u, s, vh = stt.svds(stt.DenseGenMatProd.create(A, **CPU), k=3)
    _, js, _ = st.svds(st.DenseGenMatProd.create(A), k=3)
    st_true = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(s, np.sort(st_true[:3]), atol=1e-9)
    _close(s, js, 1e-9)
    np.testing.assert_allclose(A @ vh.conj().T, u * s[None, :], atol=1e-8)

    class NoAdjoint:
        def rows(self):
            return 50

        def cols(self):
            return 30

        def perform_op(self, x):
            return x

    with pytest.raises(TypeError, match="perform_adjoint_op"):
        stt.svds(NoAdjoint(), k=3)


def test_frontends_default_to_the_gpu():
    """``device=None`` means the GPU: without one, a wrapped matrix
    raises, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    A = _sym(30)
    for call in (lambda: stt.eigsh(A, k=2), lambda: stt.eigs(A, k=2),
                 lambda: stt.svds(A, k=2),
                 lambda: stt.eigsh(sps.csr_matrix(A), k=2, sigma=0.1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
