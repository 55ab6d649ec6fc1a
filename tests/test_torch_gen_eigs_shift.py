"""The port's general shift-and-invert solvers, BiCGStab and the native
driver's general leg against the JAX package, on the CPU.

Cases of ``tests/test_gen_eigs_shift.py`` (dense and sparse, real and
complex shift), each through both packages: ``nconv``, ``CompInfo``,
eigenvalues within 1e-10 and equal restart and operation counts (the
``SimpleRandom`` start), and the reference test's residual bar. The
dense shift-solves factor by LU on the matrix's device (the CPU here);
the sparse ones by host SuperLU or by BiCGStab (config #4's operator at
g=16, the DIA kernel's plain version for the real shift, ELL for the
complex one).

BiCGStab is the port's own torch function; it must follow
``jax.scipy.sparse.linalg.bicgstab``'s iterates (within 1e-12 after the
same number of steps) and, on a system it cannot solve, NaN-poison the
shift-solve's result as the JAX package does. Also the general leg of
``tests/test_nev_adjust_conformance.py``: the port's
``_gen_core._nev_adjusted``, the native driver's rule and the JAX
package's agree on the reference test's grid.
"""

import itertools

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import spectra_tpu as st
from spectra_tpu.solvers import _gen_core as jgen
from spectra_tpu.util.rng import SimpleRandom
import spectra_tpu_torch as stt
from spectra_tpu_torch.matop import shift_solve as pss
from spectra_tpu_torch.native import dense_eigs as nd
from spectra_tpu_torch.solvers import _gen_core as pgen
from spectra_tpu_torch.solvers import _herm_core as pherm

torch.set_num_threads(1)

CPU = "cpu"
NEAR0 = 2.2250738585072014e-307


def _rand_mat(n, seed=123):
    return np.random.RandomState(seed).uniform(size=(n, n)) - 0.5


def _config4(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))
            + 0.3 * sps.kron(sps.eye(g), upw1)).tocsr()


def _check(j, p, A, bar):
    """Both packages' runs agree; the port's residual is below ``bar``
    and every value is a true eigenvalue of A."""
    assert p.info() == stt.CompInfo.Successful and p.info().name == j.info().name
    pv, jv = p.eigenvalues(), np.asarray(j.eigenvalues())
    assert len(pv) == len(jv) == p._nev
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-10)
    assert (p.num_iterations(), p.num_operations()) == (j.num_iterations(), j.num_operations())
    vecs = p.eigenvectors().numpy()
    Ad = A.toarray() if sps.issparse(A) else A
    assert np.abs(Ad @ vecs - vecs * pv[None, :]).max() < bar
    w = np.linalg.eigvals(Ad)
    for v in pv:
        assert np.min(np.abs(w - v)) < 1e-7


@pytest.mark.parametrize("n,k,m,sigma", [(50, 4, 16, 0.5), (100, 6, 24, 1.0)])
def test_real_shift_dense(n, k, m, sigma):
    A = _rand_mat(n)
    j = st.GenEigsRealShiftSolver(st.DenseGenRealShiftSolve.create(A), k, m, sigma)
    j.init()
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsRealShiftSolver(stt.DenseGenRealShiftSolve.create(A, device=CPU), k, m,
                                   sigma)
    p.init()
    p.compute(stt.SortRule.LargestMagn)
    _check(j, p, A, 1e-9)


@pytest.mark.parametrize("sigma", [(0.5, 0.5), (0.0, 1.0)])
def test_complex_shift_dense(sigma):
    A = _rand_mat(60, seed=31)
    j = st.GenEigsComplexShiftSolver(st.DenseGenComplexShiftSolve.create(A), 4, 18, *sigma)
    j.init()
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsComplexShiftSolver(stt.DenseGenComplexShiftSolve.create(A, device=CPU),
                                      4, 18, *sigma)
    p.init()
    p.compute(stt.SortRule.LargestMagn)
    _check(j, p, A, 1e-8)


def test_real_shift_sparse_splu():
    rng = np.random.RandomState(9)
    A = (sps.random(100, 100, density=0.1, random_state=rng, format="csr")
         + sps.eye(100) * 0.1).tocsr()
    j = st.GenEigsRealShiftSolver(st.SparseGenRealShiftSolve.create(A), 4, 20, 0.0)
    j.init()
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsRealShiftSolver(stt.SparseGenRealShiftSolve.create(A, device=CPU), 4, 20,
                                   0.0)
    p.init()
    p.compute(stt.SortRule.LargestMagn)
    assert p._op.method == "splu"
    _check(j, p, A, 1e-9)


def test_complex_shift_sparse_splu():
    rng = np.random.RandomState(13)
    A = sps.random(80, 80, density=0.15, random_state=rng, format="csr")
    j = st.GenEigsComplexShiftSolver(st.SparseGenComplexShiftSolve.create(A), 3, 16, 0.2, 0.3)
    j.init()
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsComplexShiftSolver(stt.SparseGenComplexShiftSolve.create(A, device=CPU),
                                      3, 16, 0.2, 0.3)
    p.init()
    p.compute(stt.SortRule.LargestMagn)
    assert p._op.method == "splu" and p._op.out_real and p._op.dtype == torch.float64
    _check(j, p, A, 1e-7)


@pytest.mark.parametrize("method", ["splu", "bicgstab"])
def test_config4_g16_shift_modes(method):
    """Config #4's operator at g=16, the real shift at 0 and the complex
    shift at (0.2, 0.3), by SuperLU and by BiCGStab."""
    A = _config4(16)
    v0 = SimpleRandom(0).random_vec(256)
    j = st.GenEigsRealShiftSolver(st.SparseGenRealShiftSolve.create(A, method=method), 6,
                                  20, 0.0)
    j.init(v0)
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsRealShiftSolver(
        stt.SparseGenRealShiftSolve.create(A, method=method, device=CPU), 6, 20, 0.0
    )
    p.init(v0)
    p.compute(stt.SortRule.LargestMagn)
    assert p._op.method == method
    if method == "bicgstab":
        assert type(p._op.shifted).__name__ == "DiaMatrix"
    _check(j, p, A, 1e-9)
    j = st.GenEigsComplexShiftSolver(st.SparseGenComplexShiftSolve.create(A, method=method),
                                     6, 20, 0.2, 0.3)
    j.init(v0)
    j.compute(st.SortRule.LargestMagn)
    p = stt.GenEigsComplexShiftSolver(
        stt.SparseGenComplexShiftSolve.create(A, method=method, device=CPU), 6, 20, 0.2, 0.3
    )
    p.init(v0)
    p.compute(stt.SortRule.LargestMagn)
    if method == "bicgstab":
        assert type(p._op.shifted).__name__ == "EllMatrix"
        assert p._op.shifted.dtype == torch.complex128
    _check(j, p, A, 1e-8)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("steps", [1, 2, 5, 20, None])
def test_bicgstab_iterates_match_jax(complex_, steps):
    """The same well-conditioned non-symmetric system, the same number of
    steps: the iterates agree within 1e-12 (``steps=None``: run to the
    tolerance)."""
    A = _config4(8).toarray() + np.eye(64)
    b = np.random.default_rng(3).normal(size=64)
    if complex_:
        A = A - 0.3j * np.eye(64)
        b = b + 1j * np.random.default_rng(4).normal(size=64)
    tol, maxiter = (1e-14, steps) if steps else (1e-12, None)
    want, _ = jax.scipy.sparse.linalg.bicgstab(
        lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=tol, maxiter=maxiter
    )
    At = torch.from_numpy(A)
    got = pss.bicgstab(lambda x: At @ x, torch.from_numpy(b), tol=tol, maxiter=maxiter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    if steps is None:
        assert np.linalg.norm(A @ got.numpy() - b) <= 1e-12 * np.linalg.norm(b) * 1.01


def test_bicgstab_breakdown_and_poisoning_match_jax():
    """A system BiCGStab cannot solve within the shift-solve's backward
    error: both packages' operators return NaN (the loud failure the
    driver reports as NumericalIssue)."""
    rng = np.random.RandomState(9)
    A = (sps.random(100, 100, density=0.1, random_state=rng, format="csr")
         + sps.eye(100) * 0.1).tocsr()
    x = np.random.default_rng(0).normal(size=100)
    jop = st.SparseGenRealShiftSolve.create(A, method="bicgstab").set_shift(0.0)
    pop = stt.SparseGenRealShiftSolve.create(A, method="bicgstab", device=CPU).set_shift(0.0)
    assert np.isnan(np.asarray(jop.perform_op(jnp.asarray(x)))).all()
    assert torch.isnan(pop.perform_op(torch.from_numpy(x))).all()
    # an exact zero residual at the start ends the loop at once
    zero = pss.bicgstab(lambda v: v, torch.zeros(5, dtype=torch.float64))
    assert torch.equal(zero, torch.zeros(5, dtype=torch.float64))


def test_solver_reports_numerical_issue_on_poisoned_solve():
    """A NaN-poisoned inner solve ends the IRAM with NaN values and
    ``CompInfo.NumericalIssue``, not a LAPACK error."""
    rng = np.random.RandomState(9)
    A = (sps.random(100, 100, density=0.1, random_state=rng, format="csr")
         + sps.eye(100) * 0.1).tocsr()
    p = stt.GenEigsRealShiftSolver(
        stt.SparseGenRealShiftSolve.create(A, method="bicgstab", device=CPU), 4, 20, 0.0
    )
    p.init()
    assert p.compute(stt.SortRule.LargestMagn) == 0
    assert p.info() == stt.CompInfo.NumericalIssue and p.num_iterations() == 1


@pytest.mark.parametrize("complex_", [False, True])
def test_dense_shift_operators_match_jax(complex_):
    A = _rand_mat(40, seed=2)
    x = np.random.default_rng(1).normal(size=40)
    X = np.random.default_rng(2).normal(size=(40, 3))
    if complex_:
        jop = st.DenseGenComplexShiftSolve.create(A).set_shift(0.4, 0.7)
        pop = stt.DenseGenComplexShiftSolve.create(A, device=CPU).set_shift(0.4, 0.7)
    else:
        jop = st.DenseGenRealShiftSolve.create(A).set_shift(0.4)
        pop = stt.DenseGenRealShiftSolve.create(A, device=CPU).set_shift(0.4)
    got = pop.perform_op(torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(jop.perform_op(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    if not complex_:
        np.testing.assert_allclose(pop.perform_op(torch.from_numpy(X)).numpy(),
                                   np.linalg.solve(A - 0.4 * np.eye(40), X), atol=1e-11)
    assert (pop.rows(), pop.cols(), pop.dtype) == (40, 40, torch.float64)


def test_singular_shifts_raise():
    A = np.diag([1.0, 2.0, 3.0, 4.0])
    with pytest.raises(pss.ShiftFactorizationError):
        stt.DenseGenRealShiftSolve.create(A, device=CPU).set_shift(2.0)
    with pytest.raises(pss.ShiftFactorizationError):
        stt.DenseGenComplexShiftSolve.create(A, device=CPU).set_shift(3.0, 0.0)
    with pytest.raises(pss.ShiftFactorizationError):
        stt.SparseGenRealShiftSolve.create(sps.csr_matrix(A), device=CPU).set_shift(2.0)


def test_sparse_general_methods():
    """``"auto"`` is SuperLU; a general shifted matrix takes "splu" and
    "bicgstab" only; the complex-shift operator's result is real."""
    A = _config4(6)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=36))
    assert stt.SparseGenRealShiftSolve.create(A, device=CPU).set_shift(0.1).method == "splu"
    for bad in ("minres", "cg", "cheb", "mg", "bogus"):
        with pytest.raises(ValueError, match="bicgstab"):
            stt.SparseGenRealShiftSolve.create(A, method=bad, device=CPU).set_shift(0.1)
    for method in ("splu", "bicgstab"):
        op = stt.SparseGenComplexShiftSolve.create(A, method=method, device=CPU)
        y = op.set_shift(0.1, 0.2).perform_op(x)
        jop = st.SparseGenComplexShiftSolve.create(A, method=method).set_shift(0.1, 0.2)
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), np.asarray(jop.perform_op(jnp.asarray(x.numpy()))),
                                   rtol=0, atol=1e-10)


def _gen_val_patterns(ncv, rng):
    real = rng.uniform(-1, 1, size=ncv) + 0j
    out = [real]
    for p in range(ncv - 1):
        v = real.copy()
        v[p], v[p + 1] = v[p].real + 0.7j, v[p].real - 0.7j
        out.append(v)
    return out


def test_nev_adjust_gen_rules_agree():
    """The general leg of ``tests/test_nev_adjust_conformance.py``: the
    port's rule, the native driver's and the JAX package's agree on every
    grid point, conjugate pairs at every boundary included."""
    rng = np.random.default_rng(1)
    for ncv in [3, 4, 5, 6, 7, 8, 12]:
        for nev in range(1, ncv - 1):
            est = rng.uniform(0.1, 1.0, size=ncv)
            est[ncv - 1] = 0.0
            for vals in _gen_val_patterns(ncv, rng):
                for nconv in range(0, nev + 1):
                    native = nd.nev_adjusted(vals.real, vals.imag, est, nconv, nev, ncv, False)
                    port = pgen._nev_adjusted(nconv, vals, est, nev, ncv, torch.float64)
                    ref = int(jgen._nev_adjusted(
                        jnp.asarray(nconv, jnp.int32), jnp.asarray(vals, jnp.complex128),
                        jnp.asarray(est), nev, ncv,
                    ))
                    assert native == port == ref, (ncv, nev, nconv, vals)


def test_nev_adjust_sym_vs_gen_shared_core():
    rng = np.random.default_rng(2)
    for ncv, nev in itertools.product([6, 8, 12], [2, 3]):
        est = rng.uniform(0.1, 1.0, size=ncv)
        vals = rng.uniform(-1, 1, size=ncv) + 0j
        for nconv in range(0, nev + 1):
            sym = pherm._nev_adjusted(nconv, torch.from_numpy(est), nev, ncv, torch.float64)
            gen = pgen._nev_adjusted(nconv, vals, est, nev, ncv, torch.float64)
            assert gen == min(sym, ncv - 2)


def test_nev_adjust_near_zero_estimates():
    """Estimates below ``near_zero`` of the operator's dtype count as
    converged unwanted pairs (dnaup2.f 660-674): f32 and f64 thresholds."""
    ncv, nev = 12, 3
    vals = np.linspace(1.0, 0.1, ncv) + 0j
    est = np.full(ncv, 0.5)
    est[nev:nev + 2] = NEAR0 / 100
    assert pgen._nev_adjusted(0, vals, est, nev, ncv, torch.float64) == nev + 2
    est[nev:nev + 2] = 1e-40
    assert pgen._nev_adjusted(0, vals, est, nev, ncv, torch.float32) == nev + 2
    assert pgen._nev_adjusted(0, vals, est, nev, ncv, torch.float64) == nev
