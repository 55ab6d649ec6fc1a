"""The port's dense operators and its two dense drivers against the JAX
package, on the CPU.

Small dense f64 problems go to the native Krylov-Schur driver (the
port's copy of ``native/dense_eigs.cpp``, built by ``g++``), as in the
JAX package; ``SPECTRA_TPU_DENSE_DRIVER=torch`` keeps them on the
IRLM (the JAX package's ``jax``). On the native driver the port runs
the same C++ source on the same BLAS as the JAX package, so ``nconv``,
``CompInfo``, restarts and operations are equal. On the IRLM the
eigenvalues agree within 1e-10 and, from the ``SimpleRandom`` start on
the simple spectra used here, the counts are equal too. Where the
Lanczos process breaks down (Example 159) or starts elsewhere (the
null-space start), the IRLM's counts follow its restart vectors, which
come from ``jax.random`` in the JAX package and from a
``torch.Generator`` in the port (ROADMAP.md section 3), and only the
eigenpairs are compared.

Cases: the operators (``tests/test_sym_eigs.py:120-135``), Examples 144
and 159 and the null-space start of ``tests/test_regression_examples.py``,
the symmetric cases of ``tests/test_robustness.py``, the native leg of
``tests/test_nev_adjust_conformance.py``, ``compute_locked`` (round 0
on the native driver, the deflated rounds on the IRLM), and a failing
native build.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectra_tpu as st
from spectra_tpu.solvers import _herm_core as jcore
import spectra_tpu_torch as stt
from spectra_tpu_torch import convert
from spectra_tpu_torch.native import dense_eigs as nd
from spectra_tpu_torch.ops import _build
from spectra_tpu_torch.solvers import _herm_core as tcore
from spectra_tpu_torch.solvers import _native_dense

torch.set_num_threads(1)

CPU = "cpu"
#: (the port's driver, the JAX package's name for it)
DRIVERS = {"native": ("auto", "auto"), "torch": ("torch", "jax")}


def _rand_sym(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    return A + A.T


def _solve(monkeypatch, driver, A, nev, ncv, rule=None, v0=None, maxit=1000,
           tol=1e-10, sorting=None, counts=True):
    """Run the JAX package and the port on ``A`` under ``driver``;
    returns ``(jax solver, port solver)``, their runs checked to agree
    (and their counts unless ``counts`` is False)."""
    rule = rule or st.SortRule.LargestMagn
    sorting = sorting or st.SortRule.LargestAlge
    ours, theirs = DRIVERS[driver]
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", theirs)
    j = st.SymEigsSolver(st.DenseSymMatProd.create(A), nev=nev, ncv=ncv)
    j.init(v0)
    jn = j.compute(rule, maxit, tol, sorting)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", ours)
    fallbacks = _native_dense.FALLBACKS
    p = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=nev, ncv=ncv)
    p.init(v0)
    pn = p.compute(getattr(stt.SortRule, rule.name), maxit, tol,
                   getattr(stt.SortRule, sorting.name))
    assert _native_dense.FALLBACKS == fallbacks
    assert pn == jn and p.info().name == j.info().name
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()),
                               rtol=0, atol=1e-10)
    if counts:
        assert (p.num_iterations(), p.num_operations()) == (
            j.num_iterations(), j.num_operations()
        )
    return j, p


def _resid(A, p):
    vals, vecs = p.eigenvalues(), p.eigenvectors().numpy()
    return np.abs(A @ vecs - vecs * vals[None, :]).max()


def test_uplo_triangle_input():
    """``tests/test_sym_eigs.py::test_uplo_triangle_input``."""
    A = _rand_sym(30, 0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=30))
    full = convert.dense_from_numpy(A, device=CPU)
    lower = stt.DenseSymMatProd.create(np.tril(A), uplo="L", device=CPU)
    upper = stt.DenseSymMatProd.create(np.triu(A), uplo="U", device=CPU)
    want = np.asarray(st.DenseSymMatProd.create(A).perform_op(x.numpy()))
    for op in (full, lower, upper):
        np.testing.assert_allclose(op.perform_op(x).numpy(), want, rtol=0, atol=1e-13)
    assert (full.rows(), full.cols(), full.dtype) == (30, 30, torch.float64)
    np.testing.assert_array_equal(full.diagonal().numpy(), np.diag(A))


def test_dense_gen_mat_prod():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(20, 20)) + 1j * rng.normal(size=(20, 20))
    x = rng.normal(size=(20, 3)) + 1j * rng.normal(size=(20, 3))
    jop, op = st.DenseGenMatProd.create(A), stt.DenseGenMatProd.create(A, device=CPU)
    for name in ("perform_op", "perform_trans_op", "perform_adjoint_op"):
        got = getattr(op, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jop, name)(x)), atol=1e-13)
    assert op.element(2, 3) == A[2, 3]


@pytest.mark.parametrize("driver", ["native", "torch"])
@pytest.mark.parametrize("rule", ["LargestMagn", "LargestAlge", "SmallestAlge", "BothEnds"])
def test_sym_eigs_dense_both_drivers(monkeypatch, driver, rule):
    A = _rand_sym(100, 7)
    _, p = _solve(monkeypatch, driver, A, 4, 16, getattr(st.SortRule, rule))
    assert p.info() == stt.CompInfo.Successful and _resid(A, p) < 1e-9


@pytest.mark.parametrize("driver", ["native", "torch"])
def test_config1_shape(monkeypatch, driver):
    """Config #1's calls (``bench.py:189-227``) at n=300."""
    n = 300
    rng = np.random.default_rng(123)
    A = rng.uniform(size=(n, n)) - 0.5
    A = A + A.T
    v0 = st.util.rng.SimpleRandom(0).random_vec(n)
    _, p = _solve(monkeypatch, driver, A, 3, 6, v0=v0)
    assert p.info() == stt.CompInfo.Successful and _resid(A, p) < 1e-9
    np.testing.assert_allclose(
        np.sort(p.eigenvalues()),
        np.sort(np.linalg.eigvalsh(A)[np.argsort(-np.abs(np.linalg.eigvalsh(A)))[:3]]),
        atol=1e-9,
    )


def _cycle_laplacian(n):
    """reference: test/Example1.cpp construct_cycle_laplacian."""
    L = np.zeros((n, n))
    for i in range(n):
        L[i, i] = 1.0
        L[i, (i + n - 1) % n] = -0.5
        L[i, (i + 1) % n] = -0.5
    return L


@pytest.mark.parametrize("n,k,m", [(20, 3, 6), (20, 5, 12), (20, 6, 12)])
def test_example144_largest_and_shifted_smallest(monkeypatch, n, k, m):
    """Cycle Laplacian, eigenvalues of multiplicity two, at tol=1e-15
    (``TestExample144``), on the native driver and, shift-invert, on
    the IRLM over the dense BKLDLT solve."""
    M = _cycle_laplacian(n)
    true_evals = np.linalg.eigvalsh(M)
    _, p = _solve(monkeypatch, "native", M, k, m, tol=1e-15,
                  sorting=st.SortRule.SmallestAlge)
    assert p.info() == stt.CompInfo.Successful and _resid(M, p) < 1e-9
    np.testing.assert_allclose(p.eigenvalues(), true_evals[-k:], atol=1e-9)

    j2 = st.SymEigsShiftSolver(st.DenseSymShiftSolve.create(M), nev=k, ncv=m, sigma=-1e-6)
    j2.init()
    j2.compute(st.SortRule.LargestMagn, 1000, 1e-15, st.SortRule.SmallestAlge)
    p2 = stt.SymEigsShiftSolver(
        stt.DenseSymShiftSolve.create(M, device=CPU), nev=k, ncv=m, sigma=-1e-6
    )
    p2.init()
    p2.compute(stt.SortRule.LargestMagn, 1000, 1e-15, stt.SortRule.SmallestAlge)
    assert p2.info() == stt.CompInfo.Successful and j2.info() == st.CompInfo.Successful
    assert _resid(M, p2) < 1e-9
    np.testing.assert_allclose(p2.eigenvalues(), true_evals[:k], atol=1e-9)
    np.testing.assert_allclose(p2.eigenvalues(), np.asarray(j2.eigenvalues()), atol=1e-10)


_M159 = [
    np.array([
        [15.035447086947079479, 3.932587856183598677, -4.848070276813470542, -8.027254936523050904, -2.865327349780228231],
        [3.932587856183598677, 1.028585791773944732, -1.268034278346991263, -2.099564123322002035, -0.749439073848281425],
        [-4.848070276813470542, -1.268034278346991263, 1.563224909309606855, 2.588329820664053864, 0.923903910371237535],
        [-8.027254936523050904, -2.099564123322002035, 2.588329820664053864, 4.285660509016328222, 1.529765824738644411],
        [-2.865327349780228231, -0.749439073848281425, 0.923903910371237535, 1.529765824738644411, 0.546049663433429209],
    ]),
    np.array([
        [0.6118330552, -3.058379358, 1.329013596, 2.601267208, 1.072783220],
        [-3.058379358, 15.28796821, -6.643360824, -13.00299463, -5.362538075],
        [1.329013596, -6.643360824, 2.886861251, 5.650429406, 2.330281884],
        [2.601267208, -13.00299463, 5.650429406, 11.05953826, 4.561041261],
        [1.072783220, -5.362538075, 2.330281884, 4.561041261, 1.881009576],
    ]),
    np.array([
        [17.7699571312182, 10.7033479738827, -19.1658731825582, -4.20053658859459, -11.1426294187651],
        [10.7033479738827, 6.44692933157151, -11.5441477084849, -2.53010203979439, -6.71152097511499],
        [-19.1658731825582, -11.5441477084849, 20.6714451890590, 4.53050904744533, 12.0179368348118],
        [-4.20053658859459, -2.53010203979439, 4.53050904744533, 0.992940360059961, 2.63394122006329],
        [-11.1426294187651, -6.71152097511499, 12.0179368348118, 2.63394122006329, 6.98697185632535],
    ]),
]


@pytest.mark.parametrize("driver", ["native", "torch"])
@pytest.mark.parametrize("case", range(3), ids=["c1", "c2", "c3"])
def test_example159_near_breakdown_restart(monkeypatch, driver, case):
    """The three 5x5 matrices of issue #159 (``TestExample159``)."""
    M = _M159[case]
    _, p = _solve(monkeypatch, driver, M, 1, 3, counts=driver == "native")
    assert p.info() == stt.CompInfo.Successful and _resid(M, p) < 1e-8
    assert abs(p.eigenvalues()[0] - np.linalg.eigvalsh(M)[-1]) < 1e-8


@pytest.mark.parametrize("driver", ["native", "torch"])
@pytest.mark.parametrize("case", ["zero_matrix", "null_space_start"])
def test_init_in_null_space(monkeypatch, driver, case):
    """``TestExampleInitNull`` (reference: Example4.cpp): A v0 = 0."""
    n = 100
    rng = np.random.RandomState(123)
    if case == "zero_matrix":
        A = np.zeros((n, n))
        v0 = rng.uniform(-1, 1, n)
    else:
        U = rng.uniform(-1, 1, (n, n))
        evals, evecs = np.linalg.eigh(U + U.T)
        evals[-1] = 0.0
        A = (evecs * evals[None, :]) @ evecs.T
        v0 = evecs[:, -1]
    _, p = _solve(monkeypatch, driver, A, 3, 6, st.SortRule.LargestAlge, v0=v0,
                  sorting=st.SortRule.SmallestAlge, counts=driver == "native")
    assert p.info() == stt.CompInfo.Successful and _resid(A, p) < 1e-8
    np.testing.assert_allclose(p.eigenvalues(), np.linalg.eigvalsh(A)[-3:], atol=1e-8)


@pytest.mark.parametrize("driver", ["native", "torch"])
@pytest.mark.parametrize("seed", range(4))
def test_robustness_seed_sweep(monkeypatch, driver, seed):
    """``tests/test_robustness.py::TestSeedSweep``, on a few seeds."""
    A = _rand_sym(80, seed)
    _, p = _solve(monkeypatch, driver, A, 4, 16)
    assert p.info() == stt.CompInfo.Successful and _resid(A, p) < 1e-9


def test_robustness_bitwise_repeatable(monkeypatch):
    """``TestDeterminism::test_bitwise_repeatable`` on the IRLM."""
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    op = stt.DenseSymMatProd.create(_rand_sym(150, 42), device=CPU)
    outs = []
    for _ in range(2):
        s = stt.SymEigsSolver(op, nev=5, ncv=20)
        s.init()
        s.compute(stt.SortRule.LargestMagn)
        outs.append((s.eigenvalues(), s.eigenvectors().numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_robustness_n1000_k20_m50(monkeypatch):
    """``TestReferenceSizeGrid::test_n1000_k20_m50`` (test/SymEigs.cpp):
    native against the JAX package, and the IRLM's eigenvalues."""
    n = 1000
    rng = np.random.default_rng(123)
    A = rng.uniform(size=(n, n)) - 0.5
    A = A + A.T
    _, p = _solve(monkeypatch, "native", A, 20, 50)
    assert p.info() == stt.CompInfo.Successful and _resid(A, p) < 1e-9
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    s = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=20, ncv=50)
    s.init()
    assert s.compute(stt.SortRule.LargestMagn) == 20
    assert s.info() == stt.CompInfo.Successful and _resid(A, s) < 1e-9
    np.testing.assert_allclose(s.eigenvalues(), p.eigenvalues(), rtol=0, atol=1e-10)


NEAR0 = 2.2250738585072014e-307


def test_nev_adjust_native_matches_python():
    """The native leg of ``tests/test_nev_adjust_conformance.py``: the
    port's ``_herm_core._nev_adjusted``, the port's native driver and
    the JAX package's rule agree over the reference test's grid."""
    rng = np.random.default_rng(0)
    for ncv in [3, 4, 5, 6, 7, 8, 12, 20]:
        for nev in range(1, ncv):
            base = rng.uniform(0.1, 1.0, size=ncv)
            zero_tail = base.copy()
            zero_tail[max(nev, ncv - 2):] = 0.0
            for est in (base, zero_tail, np.full(ncv, NEAR0 / 100)):
                wr = np.sort(rng.uniform(-1, 1, size=ncv))[::-1].copy()
                for nconv in range(0, nev + 1):
                    native = nd.nev_adjusted(wr, np.zeros(ncv), est, nconv, nev, ncv, True)
                    port = tcore._nev_adjusted(
                        nconv, torch.from_numpy(est), nev, ncv, torch.float64
                    )
                    ref = int(jcore._nev_adjusted(
                        jnp.asarray(nconv, jnp.int32), jnp.asarray(est), nev, ncv
                    ))
                    assert native == port == ref, (ncv, nev, nconv, est)


def test_compute_locked_round0_native_then_irlm(monkeypatch):
    """``compute_locked`` on a small dense f64 operator: round 0 on the
    native driver, every deflated round on the IRLM (the native driver
    has no deflation), with the JAX package's eigenvalues and counts."""
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "auto")
    M = _cycle_laplacian(20)
    args = (4, 1000, 1e-12)
    j = st.SymEigsSolver(st.DenseSymMatProd.create(M), nev=6, ncv=12)
    j.init()
    jn = j.compute_locked(st.SortRule.LargestAlge, *args[1:], st.SortRule.LargestAlge,
                          max_rounds=args[0])
    rounds = []
    native_compute = _native_dense.compute

    def spy(solver, *a):
        rounds.append(solver._locking_round)
        return native_compute(solver, *a)

    monkeypatch.setattr(_native_dense, "compute", spy)
    p = stt.SymEigsSolver(stt.DenseSymMatProd.create(M, device=CPU), nev=6, ncv=12)
    p.init()
    pn = p.compute_locked(stt.SortRule.LargestAlge, *args[1:], stt.SortRule.LargestAlge,
                          max_rounds=args[0])
    assert rounds == [False]
    assert len(p.locking_rounds()) >= 2
    assert pn == jn == 6 and p.certified() == j.certified() is True
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()), atol=1e-10)
    np.testing.assert_allclose(p.eigenvalues(), np.linalg.eigvalsh(M)[::-1][:6], atol=1e-10)
    assert (p.num_iterations(), p.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )
    assert not p._locking_round
    # After the locked run, a plain compute routes native again, from
    # the solver's own start vector.
    p.compute(stt.SortRule.LargestAlge, 1000, 1e-12)
    assert rounds == [False, False]


def test_routing_rules(monkeypatch):
    A = _rand_sym(40, 3)
    s = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=3, ncv=10)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "auto")
    assert _native_dense.eligible(s)
    s.set_restart_chunk(5)
    assert not _native_dense.eligible(s)
    s.set_restart_chunk(None)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    assert not _native_dense.eligible(s)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "jax")
    with pytest.raises(ValueError, match="SPECTRA_TPU_DENSE_DRIVER"):
        _native_dense.eligible(s)
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "auto")
    f32 = stt.SymEigsSolver(
        stt.DenseSymMatProd.create(A.astype(np.float32), device=CPU), nev=3, ncv=10
    )
    assert not _native_dense.eligible(f32)
    shift = stt.SymEigsShiftSolver(stt.DenseSymShiftSolve.create(A, device=CPU), 3, 10, 0.1)
    assert not _native_dense.eligible(shift)


def test_native_numerical_failure_is_counted_and_reruns(monkeypatch, capsys):
    """A numerical failure of the native driver (return codes -1 to -5)
    prints one stderr line, counts one fallback, and the solve runs
    again on the IRLM."""
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "auto")
    monkeypatch.setattr(nd, "dense_eigs", lambda *a: (-3, None))
    monkeypatch.setattr(_native_dense, "FALLBACKS", 0)
    A = _rand_sym(60, 5)
    s = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=3, ncv=12)
    s.init()
    assert s.compute() == 3
    assert _native_dense.FALLBACKS == 1
    assert "return code -3" in capsys.readouterr().err
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "torch")
    t = stt.SymEigsSolver(stt.DenseSymMatProd.create(A, device=CPU), nev=3, ncv=12)
    t.init()
    t.compute()
    np.testing.assert_array_equal(s.eigenvalues(), t.eigenvalues())


def test_failing_native_build_raises(monkeypatch):
    """A host library that does not build raises with the compiler's
    output; nothing falls back."""
    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", "auto")
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(nd, "_lib", None)
    s = stt.SymEigsSolver(stt.DenseSymMatProd.create(_rand_sym(30, 1), device=CPU), 2, 8)
    s.init()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on dense_eigs.cpp"):
        s.compute()
    assert s.info() == stt.CompInfo.NotComputed


def test_every_native_return_code_is_covered():
    """The C++ source returns 0, ``NOT_INITIALIZED`` or one of the
    numerical failures -1 to -5, which ``compute`` counts and re-runs."""
    src = (_build.CSRC / "dense_eigs.cpp").read_text()
    codes = {int(c) for c in re.findall(r"return (-\d+);", src)}
    assert codes == {-1, -2, -3, -4, -5, nd.NOT_INITIALIZED}
