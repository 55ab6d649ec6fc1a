"""The port's mixed-precision mode (``spectra_tpu_torch/solvers/mixed.py``,
``set_precision("mixed")``) against the JAX package's: the 6 cases of
``tests/test_mixed_precision.py``, plus the same solve on a
``format="dia_hilo"`` operator.

Both packages run the same seeded matrices. Each case holds the port to
the reference test's own assertions, its values within 1e-9 max|lambda|
of the JAX package's (where the reference test checks values), and its
``mixed_report`` residuals under the convergence gate. The restart and
operation counts follow f32 rounding (the twin's f32 sums run in another
order than XLA's) and are not held.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt
from spectra_tpu_torch.solvers import mixed

CPU = dict(device="cpu")


def _laplacian_2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _rect(gx, gy):
    lx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(gx, gx))
    ly = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(gy, gy))
    return (sps.kron(sps.eye(gy), lx) + sps.kron(ly, sps.eye(gx))).tocsr()


def _solve(mod, op, nev, ncv, rule, tol, maxit=1000):
    s = mod.SymEigsSolver(op, nev=nev, ncv=ncv)
    s.set_precision("mixed")
    s.init()
    nconv = s.compute(getattr(mod.SortRule, rule), maxit=maxit, tol=tol)
    return s, nconv


def _gate_holds(s, tol):
    rep = s.mixed_report()
    theta, resid = np.asarray(rep["values"]), np.asarray(rep["resid_f64"])
    scale = np.maximum(
        np.abs(theta),
        (np.abs(theta).max() if len(theta) else 1.0)
        * np.finfo(np.float32).eps ** (2.0 / 3.0),
    )
    assert np.all(resid <= tol * scale)
    return rep


def test_mixed_dense_refines_to_f64_grade():
    rng = np.random.default_rng(0)
    n, k = 300, 4
    A = rng.normal(size=(n, n))
    A = A + A.T
    s, nconv = _solve(stt, stt.DenseSymMatProd.create(A, **CPU), k, 20, "LargestMagn", 1e-6)
    j, jconv = _solve(st, st.DenseSymMatProd.create(A), k, 20, "LargestMagn", 1e-6)
    assert nconv == jconv == k
    vals = s.eigenvalues()
    vecs = s.eigenvectors().numpy()
    w = np.linalg.eigvalsh(A)
    want = w[np.argsort(-np.abs(w))][:k]
    scale = np.abs(w).max()
    np.testing.assert_allclose(np.sort(vals), np.sort(want), atol=1e-9 * scale)
    np.testing.assert_allclose(vals, np.asarray(j.eigenvalues()), atol=1e-9 * scale)
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-7 * scale
    rep = _gate_holds(s, 1e-6)
    assert len(rep["resid_f64"]) == k


@pytest.mark.parametrize("fmt", ["auto", "dia_hilo"])
def test_mixed_sparse_dia(fmt):
    """The reference's rectangular-grid case on K1's DIA store, and on
    hi/lo planes (the twin then runs the planes' f64 sum cast to f32)."""
    gx, gy, k = 60, 47, 5
    A = _rect(gx, gy)
    op = stt.SparseSymMatProd.from_full(A, format=fmt, **CPU)
    assert type(op.ell).__name__ == ("DiaMatrix" if fmt == "auto" else "DiaHiLoMatrix")
    s, nconv = _solve(stt, op, k, 25, "LargestAlge", 1e-4)
    j, jconv = _solve(st, st.SparseSymMatProd.from_full(A, format=fmt), k, 25,
                      "LargestAlge", 1e-4)
    assert nconv == jconv == k
    vals = np.sort(s.eigenvalues())[::-1]
    mux = 4 * np.sin(np.pi * np.arange(1, gx + 1) / (2 * (gx + 1))) ** 2
    muy = 4 * np.sin(np.pi * np.arange(1, gy + 1) / (2 * (gy + 1))) ** 2
    lam = np.sort((mux[:, None] + muy[None, :]).ravel())[::-1][:k]
    np.testing.assert_allclose(vals, lam, atol=1e-5)
    np.testing.assert_allclose(
        s.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-9 * lam.max()
    )
    _gate_holds(s, 1e-4)
    assert s.eigenvectors().dtype == torch.float64


def test_mixed_gate_rejects_unresolvable_cluster():
    n, k = 4000, 3
    d = np.ones(n)
    d[-k:] = 2.0 + 1e-8 * np.arange(k)
    A = sps.diags(d).tocsr()
    solvers = []
    for mod, dev in ((stt, CPU), (st, {})):
        s, nconv = _solve(mod, mod.SparseSymMatProd.from_full(A, **dev), k, 12,
                          "LargestAlge", 1e-6, maxit=40)
        if nconv < k:
            assert s.info() == mod.CompInfo.NotConverging
        solvers.append(s)
    _gate_holds(solvers[0], 1e-6)


def test_mixed_rejects_tight_tol():
    A = np.diag(np.arange(1.0, 40.0))
    for mod, dev in ((stt, CPU), (st, {})):
        s = mod.SymEigsSolver(mod.DenseSymMatProd.create(A, **dev), nev=3, ncv=12)
        s.set_precision("mixed")
        s.init()
        with pytest.raises(ValueError, match="mixed precision accepts"):
            s.compute(mod.SortRule.LargestMagn, tol=1e-10)


def test_mixed_rejected_on_generalized():
    A = _laplacian_2d(12)
    B = sps.eye(144).tocsr()
    eigs = stt.SymGEigsShiftSolver(
        stt.SymShiftInvert(A, B, **CPU), stt.SparseSymMatProd.from_full(B, **CPU),
        2, 8, 0.0,
    )
    with pytest.raises(ValueError, match="plain symmetric"):
        eigs.set_precision("mixed")
    jeigs = st.SymGEigsShiftSolver(
        st.SymShiftInvert(A, B), st.SparseSymMatProd.from_full(B), 2, 8, 0.0
    )
    with pytest.raises(ValueError, match="plain symmetric"):
        jeigs.set_precision("mixed")
    shift = stt.SymEigsShiftSolver(stt.SparseSymShiftSolve.create(A, **CPU), 2, 8, 0.0)
    with pytest.raises(ValueError, match="plain symmetric"):
        shift.set_precision("mixed")


def test_double_after_mixed_resets():
    rng = np.random.default_rng(1)
    n, k = 120, 3
    A = rng.normal(size=(n, n))
    A = A + A.T
    out = []
    for mod, dev in ((stt, CPU), (st, {})):
        s, _ = _solve(mod, mod.DenseSymMatProd.create(A, **dev), k, 15, "LargestMagn", 1e-6)
        s.set_precision("double")
        s.init()
        assert s.compute(mod.SortRule.LargestMagn, tol=1e-10) == k
        out.append(s)
    s, j = out
    vals = s.eigenvalues()
    vecs = s.eigenvectors().numpy()
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9 * np.abs(vals).max()
    np.testing.assert_allclose(vals, np.asarray(j.eigenvalues()), atol=1e-9 * np.abs(vals).max())
    assert s.mixed_report()["resid_f64"].shape == (0,)


def test_cast_op_f32_and_matmul_settings():
    """``cast_op_f32`` casts each store the JAX package casts, and the
    twin's compute runs at full f32 matmul precision with the caller's
    settings restored afterwards."""
    A = _rect(9, 7)
    for fmt, field in (("auto", "data"), ("ell", "vals"), ("dia_hilo", "data")):
        op = stt.SparseSymMatProd.from_full(A, format=fmt, **CPU)
        twin = mixed.cast_op_f32(op)
        assert getattr(twin.ell, field).dtype == torch.float32
        x = torch.from_numpy(np.random.default_rng(2).normal(size=A.shape[0]))
        np.testing.assert_allclose(
            twin.perform_op(x.float()).double().numpy(), A @ x.numpy(), rtol=0, atol=1e-5)
    dense = mixed.cast_op_f32(stt.DenseSymMatProd.create(A.toarray(), **CPU))
    assert dense.mat.dtype == torch.float32
    assert mixed.cast_op_f32(stt.DenseGenMatProd.create(A.toarray(), **CPU)) is None
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("high")
    try:
        with mixed.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]


def _digest(a):
    """SHA-256 (first 16 hex digits) of an array's bytes."""
    import hashlib

    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.fixture
def one_thread():
    """Torch's CPU BLAS on one thread for the test: the digests below
    depend on the BLAS build and on how it splits its sums."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fmt, want", [
    ("dia", [4, 10, 122, "df2200bce1848189", "dc3d8d6b953ef405", "20366d800bdeee98"]),
    ("ell", [4, 9, 115, "ef12cc66d2258333", "941dfdeb92a46527", "ab6dcad954badbd7"]),
])
def test_mixed_without_mesh_bitwise_unchanged(one_thread, fmt, want):
    """Without a mesh the mixed mode gives, bit for bit, what it gave
    before the row mesh reached ``solvers/mixed.py``: counts and SHA-256
    digests of the values, vectors and f64 residuals recorded from that
    tree on the CPU on one thread (PyTorch 2.13's CPU build with MKL;
    another BLAS build may round otherwise), g=16 Laplacian,
    LargestAlge, tol 1e-6."""
    s = stt.SymEigsSolver(stt.SparseSymMatProd.from_full(_laplacian_2d(16), format=fmt, **CPU),
                          4, 16)
    s.set_precision("mixed")
    s.init()
    nconv = s.compute(stt.SortRule.LargestAlge, tol=1e-6)
    assert [nconv, s.num_iterations(), s.num_operations(), _digest(s.eigenvalues()),
            _digest(s.eigenvectors()), _digest(s.mixed_report()["resid_f64"])] == want
