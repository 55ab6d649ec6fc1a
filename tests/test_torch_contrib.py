"""The port's ``contrib`` (partial SVD, LOBPCG) against the JAX package,
on the CPU.

Every case of ``tests/test_contrib.py``: ``PartialSVDSolver`` on dense
tall, wide and square matrices, on a sparse matrix and on a banded one
(DIA: the forward products run K1's plain version, the adjoint the
plain ``rmatvec``), and the operator that lacks an adjoint;
``LOBPCGSolver`` for the smallest eigenpairs, generalized with a
preconditioner, with deflation constraints, with and without soft
locking (the block-column count of the products), and from a
rank-deficient guess. Both packages run the same seeded input: nconv,
``CompInfo`` and the iteration counts agree, singular values and
eigenvalues agree within the reference tests' tolerances, and the
vectors agree up to sign (the SVD) or span the same eigenspaces (the
Laplacian's double eigenvalues).
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sps
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt

torch.set_num_threads(1)

CPU = "cpu"


def _same_up_to_sign(U, W, atol):
    for j in range(U.shape[1]):
        k = np.argmax(np.abs(U[:, j]))
        np.testing.assert_allclose(U[:, j], np.sign(U[k, j] * W[k, j]) * W[:, j], atol=atol)


def _same_eigenspaces(vals, U, W, atol):
    """The columns of U and W span the same eigenspace for each cluster
    of equal values (the Laplacian's eigenvalues are double, and any
    basis of a double eigenspace is right)."""
    order = np.argsort(vals)
    groups, cur = [], [order[0]]
    for a, b in zip(order[:-1], order[1:]):
        if vals[b] - vals[a] < 1e-6:
            cur.append(b)
        else:
            groups.append(cur)
            cur = [b]
    groups.append(cur)
    for g in groups:
        np.testing.assert_allclose(U[:, g] @ U[:, g].T, W[:, g] @ W[:, g].T, atol=atol)


def _svd_pair(A, k, ncv):
    j = st.PartialSVDSolver(A, ncomp=k, ncv=ncv)
    p = stt.PartialSVDSolver(A, ncomp=k, ncv=ncv, device=CPU)
    jn, pn = j.compute(), p.compute()
    assert pn == jn == k
    assert p.info().name == j.info().name == "Successful"
    assert p.num_iterations() == j.num_iterations()
    s = p.singular_values()
    np.testing.assert_allclose(s, np.asarray(j.singular_values()), atol=1e-10)
    U, V = p.matrix_U(k).numpy(), p.matrix_V(k).numpy()
    _same_up_to_sign(U, np.asarray(j.matrix_U(k)), 1e-7)
    _same_up_to_sign(V, np.asarray(j.matrix_V(k)), 1e-7)
    return s, U, V


@pytest.mark.parametrize("shape", [(100, 60), (60, 100), (80, 80)])
def test_partial_svd_dense_matches_jax(shape):
    m, n = shape
    A = np.random.default_rng(m * 1000 + n).normal(size=(m, n))
    k = 5
    s, U, V = _svd_pair(A, k, 15)
    np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:k], atol=1e-8)
    np.testing.assert_allclose(A @ V, U * s[None, :], atol=1e-7)
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-7)
    np.testing.assert_allclose(V.T @ V, np.eye(k), atol=1e-7)


@pytest.mark.parametrize("case", ["ell", "dia"])
def test_partial_svd_sparse_matches_jax(case):
    """``TestPartialSVD.test_sparse`` (ELL), and a banded square matrix,
    config #4's convection operator at g=12 (DIA)."""
    if case == "ell":
        A = sps.random(150, 80, density=0.2, random_state=np.random.RandomState(3),
                       format="csr")
        k, ncv = 4, 12
    else:
        g = 12
        lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
        upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
        A = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))
             + 0.3 * sps.kron(sps.eye(g), upw1)).tocsr()
        k, ncv = 5, 20
    s, U, V = _svd_pair(A, k, ncv)
    np.testing.assert_allclose(s, np.linalg.svd(A.toarray(), compute_uv=False)[:k], atol=1e-8)
    np.testing.assert_allclose(A @ V, U * s[None, :], atol=1e-7)


def test_partial_svd_operator_input():
    """An operator with both products passes through; one without
    ``perform_adjoint_op`` raises ``TypeError``, as in the JAX package."""
    A = np.random.default_rng(0).normal(size=(30, 20))
    op = stt.DenseGenMatProd.create(A, device=CPU)
    p = stt.PartialSVDSolver(op, ncomp=3, ncv=10)
    assert p.compute() == 3
    np.testing.assert_allclose(p.singular_values(), np.linalg.svd(A, compute_uv=False)[:3],
                               atol=1e-8)
    with pytest.raises(TypeError, match="perform_adjoint_op"):
        stt.PartialSVDSolver(stt.DenseSymMatProd.create(A.T @ A, device=CPU), 3, 10)


def _laplacian(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _lobpcg_pair(A, X0, maxit, setup=None, soft_locking=True):
    out = []
    for pkg, kw in ((st, {}), (stt, dict(device=CPU))):
        s = pkg.LOBPCGSolver(A, X0, **kw)
        if setup:
            setup(s)
        out.append((s, s.compute(maxit=maxit, tol_div_n=1e-10, soft_locking=soft_locking)))
    (j, jn), (p, pn) = out
    assert pn == jn
    assert p.info().name == j.info().name == "Successful"
    assert p.num_iterations() == j.num_iterations()
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-9)
    _same_eigenspaces(p.eigenvalues(), p.eigenvectors().numpy(),
                      np.asarray(j.eigenvectors()), 1e-6)
    return p


def test_lobpcg_smallest_matches_jax():
    g, k = 10, 4
    A = _laplacian(g)
    X0 = np.random.default_rng(0).normal(size=(g * g, k))
    p = _lobpcg_pair(A, X0, 200)
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    np.testing.assert_allclose(np.sort(vals), np.sort(np.linalg.eigvalsh(A.toarray()))[:k],
                               atol=1e-6)
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-5
    assert p.residuals().max() < 1e-10 * g * g


def test_lobpcg_generalized_with_preconditioner_matches_jax():
    g, k = 8, 3
    A = _laplacian(g)
    n = g * g
    B = sps.diags(1.0 + 0.5 * np.sin(np.arange(n))).tocsr()
    T = sps.diags(1.0 / A.diagonal()).tocsr()

    def setup(s):
        s.set_B(B)
        s.set_preconditioner(T)

    p = _lobpcg_pair(A, np.random.default_rng(1).normal(size=(n, k)), 300, setup)
    w = np.sort(scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True))[:k]
    np.testing.assert_allclose(np.sort(p.eigenvalues()), w, atol=1e-6)


def test_lobpcg_constraints_deflation_matches_jax():
    g = 8
    A = _laplacian(g)
    w, V = np.linalg.eigh(A.toarray())
    p = _lobpcg_pair(A, np.random.default_rng(3).normal(size=(g * g, 2)), 300,
                     lambda s: s.set_constraints(V[:, :2]))
    np.testing.assert_allclose(np.sort(p.eigenvalues()), w[2:4], atol=1e-6)


@pytest.mark.parametrize("lock", [True, False])
def test_lobpcg_soft_locking_matches_jax(lock):
    """``test_lobpcg_soft_locking_saves_matvecs``: a counting callable
    sees the JAX package's calls, each with its number of columns, and
    locking costs no more than the unlocked run. With locking, a pair
    whose residual meets the bar within rounding locks one iteration
    later in one package than in the other (call 39 of 45 here: 3
    columns against 2), so at most two calls may differ in width."""
    import jax.numpy as jnp

    g, k = 10, 6
    A = _laplacian(g)
    X0 = np.random.default_rng(7).normal(size=(g * g, k))
    cols = {"jax": [], "port": []}

    def jax_a(X):
        cols["jax"].append(X.shape[1])
        return jnp.asarray(A @ np.asarray(X))

    def port_a(X):
        cols["port"].append(X.shape[1])
        return torch.from_numpy(A @ X.numpy())

    j = st.LOBPCGSolver(jax_a, X0)
    p = stt.LOBPCGSolver(port_a, X0, device=CPU)
    jn = j.compute(maxit=300, tol_div_n=1e-10, soft_locking=lock)
    pn = p.compute(maxit=300, tol_div_n=1e-10, soft_locking=lock)
    assert pn == jn == k
    assert p.info() == stt.CompInfo.Successful
    assert p.num_iterations() == j.num_iterations()
    assert len(cols["port"]) == len(cols["jax"])
    assert sum(a != b for a, b in zip(cols["port"], cols["jax"])) <= (2 if lock else 0)
    np.testing.assert_allclose(np.sort(p.eigenvalues()),
                               np.sort(np.linalg.eigvalsh(A.toarray()))[:k], atol=1e-6)
    if lock:
        unlocked = stt.LOBPCGSolver(lambda X: torch.from_numpy(A @ X.numpy()), X0, device=CPU)
        seen = []
        unlocked._A = lambda X: (seen.append(X.shape[1]), torch.from_numpy(A @ X.numpy()))[1]
        unlocked.compute(maxit=300, tol_div_n=1e-10, soft_locking=False)
        assert sum(cols["port"]) <= sum(seen)


def test_lobpcg_rank_deficient_guess_matches_jax():
    g = 12
    A = _laplacian(g)
    X0 = np.random.default_rng(3).standard_normal((g * g, 4))
    X0[:, 1] = X0[:, 0]
    X0[:, 3] = 2.0 * X0[:, 2]
    p = _lobpcg_pair(A, X0, 200)
    np.testing.assert_allclose(np.sort(p.eigenvalues()),
                               np.sort(np.linalg.eigvalsh(A.toarray()))[:4], atol=1e-6)


def test_lobpcg_dia_operator_runs_k1_plain():
    """A banded scipy matrix goes through ``SparseGenMatProd.create``:
    DIA, whose block products are K1's plain version on the CPU."""
    from spectra_tpu_torch.contrib.lobpcg import _as_matvec

    A = _laplacian(6)
    mv = _as_matvec(A, torch.device(CPU))
    assert type(mv.__self__.ell).__name__ == "DiaMatrix"
    X = np.random.default_rng(0).normal(size=(36, 3))
    np.testing.assert_allclose(mv(torch.from_numpy(X)).numpy(), A @ X, atol=1e-13)


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


def _lobpcg_case(name):
    if name == "constraints":
        _, V = np.linalg.eigh(_laplacian(8).toarray())
        s = stt.LOBPCGSolver(_laplacian(8), np.random.default_rng(3).normal(size=(64, 2)),
                             device=CPU)
        s.set_constraints(V[:, :2])
        return s, s.compute(maxit=300, tol_div_n=1e-10)
    X0 = np.random.default_rng(0 if name == "smallest" else 1).normal(size=(100, 4))
    if name == "rank_deficient":
        X0[:, 3] = X0[:, 2]
    s = stt.LOBPCGSolver(_laplacian(10), X0, device=CPU)
    return s, s.compute(maxit=200, tol_div_n=1e-10)


@pytest.mark.parametrize("name, want", [
    ("smallest", [4, 61, "0931d951461299b4", "ddaedbb3ab90bb6e"]),
    ("constraints", [2, 69, "dcb79ea79f413673", "4668a596b00a0340"]),
    ("rank_deficient", [4, 62, "0078ff3ffd9ff442", "c5dc555d90fd0a4e"]),
])
def test_lobpcg_without_mesh_bitwise_unchanged(one_thread, name, want):
    """Without a mesh LOBPCG gives, bit for bit, what it gave before the
    row mesh reached ``contrib/lobpcg.py``: the counts and SHA-256
    digests of the values and vectors recorded from that tree on the
    CPU on one thread (PyTorch 2.13's CPU build with MKL; another BLAS
    build may round otherwise), soft locking's guards, the constraints
    and the rank-deficient recovery's guards on the way."""
    s, nconv = _lobpcg_case(name)
    assert [nconv, s.num_iterations(), _digest(s.eigenvalues()),
            _digest(s.eigenvectors())] == want


@pytest.mark.parametrize("name, want", [
    ("dense_tall", [3, 4, 37, "c877b02fb14a046d", "121b5b7bf5e65e25", "0242b77c0f27632f"]),
    ("dense_wide", [3, 5, 46, "51f37b58c91fd94c", "291d1714433ec575", "cc112e7105695a57"]),
    ("sparse_tall", [3, 5, 44, "371d8157deab7a35", "d1a5c936ad9529c2", "3cede29a0ed2f43c"]),
])
def test_partial_svd_without_mesh_bitwise_unchanged(one_thread, name, want):
    """Without a mesh the partial SVD gives, bit for bit, what it gave
    before the row mesh reached ``contrib/partial_svd.py`` (counts and
    SHA-256 digests of s, U and V recorded from that tree on the CPU on
    one thread: PyTorch 2.13's CPU build with MKL; another BLAS build may
    round otherwise)."""
    M = {"dense_tall": lambda: np.random.default_rng(2).normal(size=(60, 40)),
         "dense_wide": lambda: np.random.default_rng(3).normal(size=(40, 60)),
         "sparse_tall": lambda: sps.random(90, 50, density=0.2, format="csr",
                                           random_state=np.random.RandomState(3))}[name]()
    p = stt.PartialSVDSolver(M, 3, 12, device=CPU)
    nconv = p.compute()
    assert p._eigs._op.mesh is None
    assert [nconv, p.num_iterations(), p.num_operations(), _digest(p.singular_values()),
            _digest(p.matrix_U(3)), _digest(p.matrix_V(3))] == want


def test_partial_svd_wide_sparse_block_adjoint():
    """A wide sparse matrix's ``matrix_V`` applies the adjoint to a block
    (one column at a time); the JAX package's ELL ``rmatvec`` takes
    vectors only (ROADMAP.md section 3)."""
    M = sps.random(64, 128, density=0.1, random_state=np.random.RandomState(0), format="csr")
    p = stt.PartialSVDSolver(M, 3, 12, device=CPU)
    assert p.compute() == 3
    U0, s0, Vt0 = np.linalg.svd(M.toarray())
    np.testing.assert_allclose(p.singular_values(), s0[:3], atol=1e-12)
    V = p.matrix_V(3).numpy()
    np.testing.assert_allclose(V * np.sign(np.sum(V * Vt0[:3].T, axis=0)), Vt0[:3].T,
                               atol=1e-9)
    with pytest.raises(ValueError, match="broadcasting"):
        st.SparseGenMatProd.create(M).perform_adjoint_op(np.ones((64, 3)))
