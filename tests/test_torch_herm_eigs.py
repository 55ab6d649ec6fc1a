"""The port's Hermitian solvers against the JAX package, on the CPU.

Every case of ``tests/test_herm_eigs.py`` (dense and sparse Hermitian
operators, the Hermitian shift-solve, the J-structured real embedding,
its multiplicity and factorization invariants), the Hermitian case of
``tests/test_selective_reorth.py:213-230`` and the ``SparseHermMatProd``
and complex ``rmatvec`` cases of ``tests/test_sparse.py``. Each runs
both packages on the same seeded matrix from the same ``SimpleRandom``
start: ``nconv``, ``CompInfo``, the restart and operation counts agree,
the eigenvalues agree within the reference test's 1e-9, and the
eigenvectors agree up to a unit complex factor (a sign on the real
embedding).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

import spectra_tpu as st
from spectra_tpu.linalg import krylov as jkry
from spectra_tpu.matop.arnoldi_op import ArnoldiOp as JArnoldiOp
from spectra_tpu.matop.herm_embed import RealEmbeddedHermMatProd as JEmbed
from spectra_tpu.matop.shift_solve import DenseHermShiftSolve as JHermShift
from spectra_tpu.sparse import ell_from_scipy as jell_from_scipy
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import krylov as pkry
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp as PArnoldiOp
from spectra_tpu_torch.matop.arnoldi_op import JStructuredArnoldiOp
from spectra_tpu_torch.sparse.formats import ell_from_scipy
from spectra_tpu_torch.util.rng import SimpleRandom

torch.set_num_threads(1)

CPU = "cpu"


def _rand_herm(n, seed=123):
    rng = np.random.RandomState(seed)
    A = (rng.uniform(size=(n, n)) - 0.5) + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A + A.conj().T


def _same_up_to_phase(U, W, atol):
    """Columns of U and W equal up to a unit complex factor each."""
    for j in range(U.shape[1]):
        k = np.argmax(np.abs(W[:, j]))
        phase = U[k, j] / W[k, j]
        assert abs(abs(phase) - 1.0) < atol
        np.testing.assert_allclose(U[:, j], W[:, j] * phase, atol=atol)


def _both(jsolver, psolver, rule, atol=1e-9, vec_atol=1e-7, maxit=1000, tol=1e-10,
          vectors=True):
    """Run both solvers from the default start; check the counts, the
    values and (with ``vectors``) the vectors. Returns (values, port
    vectors as numpy)."""
    sel = rule
    jsolver.init()
    psolver.init()
    jn = jsolver.compute(getattr(st.SortRule, sel), maxit, tol)
    pn = psolver.compute(getattr(stt.SortRule, sel), maxit, tol)
    assert pn == jn
    assert psolver.info().name == jsolver.info().name == "Successful"
    assert psolver.num_iterations() == jsolver.num_iterations()
    assert psolver.num_operations() == jsolver.num_operations()
    jv = np.asarray(jsolver.eigenvalues())
    pv = psolver.eigenvalues()
    assert pv.dtype.kind == "f"
    np.testing.assert_allclose(pv, jv, atol=atol)
    pvec = psolver.eigenvectors().numpy()
    if vectors:
        _same_up_to_phase(pvec, np.asarray(jsolver.eigenvectors()), vec_atol)
    return pv, pvec


@pytest.mark.parametrize("n,k,m", [(10, 3, 6), (100, 10, 20)])
@pytest.mark.parametrize("selection", ["LargestMagn", "LargestAlge", "SmallestMagn"])
def test_dense_herm_matches_jax(n, k, m, selection):
    A = _rand_herm(n)
    j = st.HermEigsSolver(st.DenseHermMatProd.create(A), nev=k, ncv=m)
    p = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=CPU), nev=k, ncv=m)
    vals, vecs = _both(j, p, selection)
    assert vecs.dtype == np.complex128
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9
    w = np.linalg.eigvalsh(A)
    if selection == "LargestAlge":
        want = w[-k:]
    elif selection == "LargestMagn":
        want = w[np.argsort(-np.abs(w))[:k]]
    else:
        want = w[np.argsort(np.abs(w))[:k]]
    np.testing.assert_allclose(np.sort(vals), np.sort(want), atol=1e-9)


def test_dense_herm_operator():
    A = _rand_herm(12, seed=3)
    low = np.tril(A)
    p = stt.DenseHermMatProd.create(low, uplo="L", device=CPU)
    j = st.DenseHermMatProd.create(low, uplo="L")
    np.testing.assert_array_equal(p.mat.numpy(), np.asarray(j.mat))
    np.testing.assert_array_equal(p.diagonal().numpy(), np.asarray(j.diagonal()))
    assert p.diagonal().is_complex()
    real = stt.DenseHermMatProd.create(np.triu(A.real), uplo="U", device=CPU)
    assert real.dtype == torch.complex128
    np.testing.assert_array_equal(
        real.mat.numpy(), np.asarray(st.DenseHermMatProd.create(np.triu(A.real), "U").mat)
    )


def _sparse_herm(n=80):
    rng = np.random.RandomState(7)
    A = sps.random(n, n, density=0.1, random_state=rng, format="csr")
    A = A + 1j * sps.random(n, n, density=0.1, random_state=np.random.RandomState(8))
    return (A + A.conj().T).tocsr()


def test_sparse_herm_matches_jax():
    A = _sparse_herm()
    low = sps.tril(A, format="csr")
    j = st.HermEigsSolver(st.SparseHermMatProd.create(low, uplo="L"), nev=5, ncv=16)
    pop = stt.SparseHermMatProd.create(low, uplo="L", device=CPU)
    assert type(pop.ell).__name__ == "EllMatrix"
    p = stt.HermEigsSolver(pop, nev=5, ncv=16)
    vals, vecs = _both(j, p, "LargestMagn")
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9


def _random_sparse(n, m, density, seed):
    mat = sps.random(n, m, density=density, random_state=np.random.RandomState(seed),
                     format="csr")
    mat = mat + 1j * sps.random(n, m, density=density,
                                random_state=np.random.RandomState(seed + 1))
    return mat.tocsr()


def test_sparse_herm_prod_and_complex_rmatvec():
    """``tests/test_sparse.py``'s ``test_herm_prod`` and
    ``test_rmatvec_complex_adjoint``, against the JAX operators."""
    A = _random_sparse(30, 30, 0.2, 14)
    A = A + A.conj().T
    x = np.random.default_rng(15).normal(size=30) + 0.5j
    p = stt.SparseHermMatProd.create(A, uplo="L", device=CPU)
    j = st.SparseHermMatProd.create(A, uplo="L")
    y = p.perform_op(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, atol=1e-12)
    np.testing.assert_allclose(y, np.asarray(j.perform_op(x)), atol=1e-14)
    B = _random_sparse(20, 25, 0.3, 6)
    xb = np.random.default_rng(7).normal(size=20) + 1j
    yb = ell_from_scipy(B, device=CPU).rmatvec(torch.from_numpy(xb)).numpy()
    np.testing.assert_allclose(yb, B.conj().T @ xb, atol=1e-13)
    np.testing.assert_allclose(yb, np.asarray(jell_from_scipy(B).rmatvec(xb)), atol=1e-14)


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_sparse_gen_trans_and_adjoint_ops(fmt):
    """``SparseGenMatProd.perform_trans_op`` and ``perform_adjoint_op``
    against the JAX package (ELL complex; DIA real, the plain
    ``rmatvec``). The JAX package's ``perform_trans_op`` raises on DIA
    (it reads ``ell.vals``), so there the transpose is held to scipy
    alone."""
    if fmt == "ell":
        A = _random_sparse(40, 40, 0.2, 3)
        x = np.random.default_rng(4).normal(size=40) + 0.25j
    else:
        A = sps.diags([np.arange(1.0, 40), np.ones(40), -np.ones(38)], [-1, 0, 2]).tocsr()
        x = np.random.default_rng(4).normal(size=40)
    p = stt.SparseGenMatProd.create(A, format=fmt, device=CPU)
    j = st.SparseGenMatProd.create(A, format=fmt)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(p.perform_trans_op(xt).numpy(), A.T @ x, atol=1e-12)
    np.testing.assert_allclose(p.perform_adjoint_op(xt).numpy(), A.conj().T @ x, atol=1e-12)
    np.testing.assert_allclose(
        p.perform_adjoint_op(xt).numpy(), np.asarray(j.perform_adjoint_op(x)), atol=1e-14
    )
    if fmt == "ell":
        np.testing.assert_allclose(
            p.perform_trans_op(xt).numpy(), np.asarray(j.perform_trans_op(x)), atol=1e-14
        )


def test_herm_shift_solve_matches_jax():
    n, k, m = 60, 4, 12
    A = _rand_herm(n, seed=11)
    j = st.SymEigsShiftSolver(JHermShift.create(A), nev=k, ncv=m, sigma=0.2)
    p = stt.SymEigsShiftSolver(
        stt.DenseHermShiftSolve.create(A, device=CPU), nev=k, ncv=m, sigma=0.2
    )
    vals, vecs = _both(j, p, "LargestMagn")
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9
    w = np.linalg.eigvalsh(A)
    closest = w[np.argsort(np.abs(w - 0.2))[:k]]
    np.testing.assert_allclose(np.sort(vals), np.sort(closest), atol=1e-9)


def test_herm_shift_solve_factors_and_singular_shift():
    A = _rand_herm(20, seed=4)
    p = stt.DenseHermShiftSolve.create(A, device=CPU).set_shift(0.3)
    j = JHermShift.create(A).set_shift(0.3)
    np.testing.assert_array_equal(p.factors.perm.numpy(), np.asarray(j.factors.perm))
    x = np.random.default_rng(1).normal(size=20) + 1j
    y = p.perform_op(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose((A - 0.3 * np.eye(20)) @ y, x, atol=1e-11)
    np.testing.assert_allclose(y, np.asarray(j.perform_op(x)), atol=1e-12)
    D = np.diag([1.0, 2.0, 3.0]).astype(complex)
    with pytest.raises(stt.matop.shift_solve.ShiftFactorizationError):
        stt.DenseHermShiftSolve.create(D, device=CPU).set_shift(2.0)


def test_complex_dense_cholesky_matches_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(15, 15)) + 1j * rng.normal(size=(15, 15))
    B = M @ M.conj().T + 15 * np.eye(15)
    p = stt.DenseCholesky.create(np.tril(B), uplo="L", device=CPU)
    from spectra_tpu.matop.cholesky import DenseCholesky as JChol

    j = JChol.create(np.tril(B), uplo="L")
    assert p.info().name == j.info().name == "Successful"
    np.testing.assert_allclose(p.L.numpy(), np.asarray(j.L), atol=1e-12)
    x = rng.normal(size=15) + 1j * rng.normal(size=15)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        p.upper_triangular_solve(p.lower_triangular_solve(xt)).numpy(),
        np.linalg.solve(B, x), atol=1e-12,
    )
    bad = stt.DenseCholesky.create(-B, device=CPU)
    assert bad.info().name == "NumericalIssue"


@pytest.mark.parametrize("case", ["embedded", "multiplicity"])
def test_real_embedded_matches_jax(case):
    """``test_real_embedded_herm`` and
    ``test_real_embedded_resolves_multiplicity``: the J-structured
    Lanczos on the card's dtype, both copies of a double eigenvalue
    with orthogonal complex eigenvectors."""
    if case == "embedded":
        n, k, ncv = 60, 4, 16
        A = _rand_herm(n, seed=21)
    else:
        rng = np.random.default_rng(7)
        n, k, ncv = 60, 4, 16
        M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        U, _ = np.linalg.qr(M)
        w = np.linspace(0.1, 5.0, n)
        w[-1] = w[-2] = 6.0
        A = (U * w) @ U.conj().T
        A = 0.5 * (A + A.conj().T)
    jop = JEmbed.create(A)
    pop = stt.RealEmbeddedHermMatProd.create(A, device=CPU)
    assert isinstance(PArnoldiOp.create(pop), JStructuredArnoldiOp)
    j = st.SymEigsSolver(jop, nev=k, ncv=ncv)
    p = stt.SymEigsSolver(pop, nev=k, ncv=ncv)
    vals, emb = _both(j, p, "LargestAlge", vectors=case == "embedded")
    vecs = pop.recover_eigenvectors(torch.from_numpy(emb)).numpy()
    jvecs = jop.recover_eigenvectors(np.asarray(j.eigenvectors()))
    if case == "embedded":
        _same_up_to_phase(vecs, jvecs, 1e-7)
    else:
        # The copies of 6.0 span one eigenplane; any basis of it is right.
        top = np.argsort(-vals)[:2]
        proj = vecs[:, top] @ vecs[:, top].conj().T
        jproj = jvecs[:, top] @ jvecs[:, top].conj().T
        np.testing.assert_allclose(proj, jproj, atol=1e-8)
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-8
    w_all = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.sort(vals)[::-1], w_all[::-1][:k], atol=1e-9)
    if case == "multiplicity":
        np.testing.assert_allclose(np.sort(vals)[::-1][:2], [6.0, 6.0], atol=1e-9)
        G = vecs.conj().T @ vecs
        assert np.abs(G - np.diag(np.diag(G))).max() < 1e-8


def test_j_structured_factorization_invariants():
    """V^T V = I, V^T J V = 0 and the Krylov relation of the embedded
    Lanczos basis, and H within 1e-12 of the JAX package's."""
    n, m = 40, 12
    A = _rand_herm(n, seed=5)
    pop = stt.RealEmbeddedHermMatProd.create(A, device=CPU)
    arnop = PArnoldiOp.create(pop)
    v0 = SimpleRandom(0).random_vec(2 * n)
    state = pkry.init(arnop, torch.from_numpy(v0), m, 0, hermitian=True)
    state = pkry.factorize_from(arnop, state, 1, "lanczos")
    V = state.V.numpy().T
    H = state.H.numpy()
    f = state.f.numpy()
    JV = pop.j_map(state.V).numpy().T
    assert np.abs(V.T @ V - np.eye(m)).max() < 1e-12
    assert np.abs(V.T @ JV).max() < 1e-12
    E = np.block([[np.real(A), -np.imag(A)], [np.imag(A), np.real(A)]])
    assert np.abs(E @ V - (V @ H + np.outer(f, np.eye(m)[-1]))).max() < 1e-11
    jarnop = JArnoldiOp.create(JEmbed.create(A))
    js = jkry.factorize_from(jarnop, jkry.init(jarnop, v0, m, jax.random.key(0)), 1, "lanczos")
    np.testing.assert_allclose(H, np.asarray(js.H), atol=1e-12)
    np.testing.assert_allclose(np.abs(V), np.abs(np.asarray(js.V).T), atol=1e-10)


def test_complex_lanczos_h_is_real():
    """The complex Lanczos keeps H real f64 on the host; its tridiagonal
    equals the real part of the JAX package's complex H."""
    n, m = 30, 10
    A = _rand_herm(n, seed=9)
    arnop = PArnoldiOp.create(stt.DenseHermMatProd.create(A, device=CPU))
    v0 = SimpleRandom(0).random_vec(n, np.complex128)
    state = pkry.factorize_from(
        arnop, pkry.init(arnop, torch.from_numpy(v0), m, 0, hermitian=True), 1, "lanczos"
    )
    assert state.H.dtype == torch.float64 and state.V.dtype == torch.complex128
    jarnop = JArnoldiOp.create(st.DenseHermMatProd.create(A))
    js = jkry.factorize_from(jarnop, jkry.init(jarnop, v0, m, jax.random.key(0)), 1, "lanczos")
    np.testing.assert_allclose(state.H.numpy(), np.real(np.asarray(js.H)), atol=1e-12)
    V = state.V.numpy()
    assert np.abs(V.conj() @ V.T - np.eye(m)).max() < 1e-12


@pytest.mark.parametrize("reorth", ["selective", "full"])
@pytest.mark.parametrize("restart", ["implicit", "thick"])
def test_herm_reorth_and_restart_modes(reorth, restart):
    """``tests/test_selective_reorth.py::test_structured_op_falls_back_to_full``
    (its Hermitian matrix, selective re-orthogonalization), with full
    re-orthogonalization and thick restarts beside it."""
    rng = np.random.default_rng(5)
    n = 60
    H = rng.uniform(size=(n, n)) + 1j * rng.uniform(size=(n, n))
    H = H + H.conj().T
    j = st.HermEigsSolver(st.DenseHermMatProd.create(H), 4, 14)
    p = stt.HermEigsSolver(stt.DenseHermMatProd.create(H, device=CPU), 4, 14)
    for s in (j, p):
        s.set_reorth(reorth)
        s.set_restart_method(restart)
    vals, _ = _both(j, p, "LargestMagn")
    w = np.linalg.eigvalsh(H)
    want = np.sort(w[np.argsort(-np.abs(w))[:4]])
    assert np.abs(np.sort(vals) - want).max() <= 1e-9


def test_structured_selective_runs_full():
    """On the J-structured embedding, selective re-orthogonalization
    runs as full: the counts equal the full run's."""
    A = _rand_herm(40, seed=13)
    runs = {}
    for reorth in ("full", "selective"):
        p = stt.SymEigsSolver(stt.RealEmbeddedHermMatProd.create(A, device=CPU), 4, 16)
        p.set_reorth(reorth)
        p.init()
        p.compute(stt.SortRule.LargestAlge)
        runs[reorth] = (p.num_iterations(), p.num_operations(), p.eigenvalues())
    assert runs["full"][:2] == runs["selective"][:2]
    np.testing.assert_array_equal(runs["full"][2], runs["selective"][2])


def test_herm_compute_locked_and_checkpoint(tmp_path):
    """``compute_locked`` on a Hermitian matrix with a double top
    eigenvalue finds both copies; a checkpoint round trip of a chunked
    run gives the single-shot result."""
    rng = np.random.default_rng(3)
    n = 50
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    U, _ = np.linalg.qr(M)
    w = np.linspace(0.1, 5.0, n)
    w[-1] = w[-2] = 6.0
    A = (U * w) @ U.conj().T
    A = 0.5 * (A + A.conj().T)
    p = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=CPU), 3, 12)
    p.init()
    assert p.compute_locked(stt.SortRule.LargestAlge, tol=1e-10) == 3
    np.testing.assert_allclose(np.sort(p.eigenvalues())[::-1], np.sort(w)[::-1][:3], atol=1e-9)
    assert p.eigenvectors().is_complex()

    one = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=CPU), 3, 12)
    one.init()
    one.compute(stt.SortRule.LargestAlge)
    part = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=CPU), 3, 12)
    part.set_restart_chunk(2)
    part.init()
    part.compute(stt.SortRule.LargestAlge, maxit=2)
    part.save_checkpoint(str(tmp_path / "herm.npz"))
    rest = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=CPU), 3, 12)
    rest.set_restart_chunk(2)
    rest.init()
    rest.load_checkpoint(str(tmp_path / "herm.npz"))
    rest.compute(stt.SortRule.LargestAlge)
    np.testing.assert_array_equal(rest.eigenvalues(), one.eigenvalues())


def test_result_leaves_stay_on_device(monkeypatch):
    """``test_large_result_leaves_stay_on_device``: the JAX package keeps
    a result leaf above ``_FETCH_LIMIT_BYTES`` on its device; the port
    keeps the basis on the operator's device always. The accessors work
    from it, with the JAX package's counts on the IRLM."""
    rng = np.random.default_rng(0)
    A = rng.uniform(size=(60, 60)) - 0.5
    A = A + A.T
    from spectra_tpu.solvers import base as jbase

    monkeypatch.setattr(jbase, "_FETCH_LIMIT_BYTES", 1024)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "jax")
    j = st.SymEigsSolver(st.DenseSymMatProd.create(A), nev=4, ncv=16)
    j.init()
    assert j.compute(st.SortRule.LargestMagn, tol=1e-10) == 4
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    p = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=4, ncv=16)
    p.init()
    assert p.compute(stt.SortRule.LargestMagn, tol=1e-10) == 4
    assert torch.is_tensor(p._result.V) and p._result.V.device == p._op.device
    assert (p.num_iterations(), p.num_operations()) == (j.num_iterations(),
                                                         j.num_operations())
    vals, X = p.eigenvalues(), p.eigenvectors().numpy()
    np.testing.assert_allclose(vals, np.asarray(j.eigenvalues()), atol=1e-12)
    assert np.abs(A @ X - X * vals[None, :]).max() <= 1e-9
