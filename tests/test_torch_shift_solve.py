"""The port's sparse shift-solve and ``SymEigsShiftSolver`` against the JAX
package.

Same matrices, right-hand sides and ``SimpleRandom`` start vectors
through ``spectra_tpu`` and ``spectra_tpu_torch`` on the CPU.
Tolerances: each ``perform_op`` meets ``tests/test_shift_solve.py``'s
bar (residual within 1e-9) and agrees with the JAX package's solution
within 1e-9 relative (both solve to the coupled inner tolerance 1e-12;
SuperLU is the same scipy call and agrees bitwise). Eigenvalues agree
within 1e-10. Restart and operation counts are equal on the anisotropic
grid (simple eigenvalues) for every method. On the 3-D north-star shape,
whose spectrum has multiplicities, plain ``compute`` is held only to
what it guarantees (ROADMAP.md section 3), and ``compute_locked`` to
the complete multiset.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import multigrid as pmg
from spectra_tpu_torch.matop.shift_solve import (
    cg,
    couple_inner_tolerance,
    coupled_inner_rtol,
)
from spectra_tpu_torch.sparse.formats import DiaMatrix
from spectra_tpu_torch.util.rng import SimpleRandom

torch.set_num_threads(1)


def lap1d(g):
    return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g)).tocsr()


def lap2d(g):
    return (sps.kron(sps.eye(g), lap1d(g)) + sps.kron(lap1d(g), sps.eye(g))).tocsr()


def lap3d(g):
    e = sps.eye(g)
    return (
        sps.kron(sps.kron(lap1d(g), e), e)
        + sps.kron(sps.kron(e, lap1d(g)), e)
        + sps.kron(sps.kron(e, e), lap1d(g))
    ).tocsr()


def aniso(g):
    """Anisotropic 2-D grid: simple eigenvalues."""
    return (sps.kron(sps.eye(g), lap1d(g)) + 1.37 * sps.kron(lap1d(g), sps.eye(g))).tocsr()


def aniso_eigs(g, k):
    mu = 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None] + 1.37 * mu[None, :]).ravel())[:k]


def rand_sparse_sym(n, density=0.1, seed=123):
    rng = np.random.RandomState(seed)
    A = sps.random(n, n, density=density, random_state=rng, format="csr")
    return (A + A.T).tocsr()


# method -> (matrix, sigma, the method each package resolves it to)
PERFORM = {
    "splu": (lambda: rand_sparse_sym(80), 0.2, "splu"),
    "cg": (lambda: lap2d(12), 0.0, "cg"),
    "minres": (lambda: rand_sparse_sym(80), 0.2, "minres"),
    "minres_jacobi": (lambda: rand_sparse_sym(60, density=0.2, seed=5), -0.4, "minres"),
    "minres_cheb": (lambda: rand_sparse_sym(60, density=0.2, seed=5), -6.0, "minres"),
    "cheb": (lambda: aniso(20), 0.0, "cheb"),
    "mg": (lambda: lap2d(24), 0.0, "mg"),
}


@pytest.mark.parametrize("case", list(PERFORM))
def test_perform_op_matches_jax(case):
    make, sigma, resolved = PERFORM[case]
    A = make()
    n = A.shape[0]
    method = case.split("_")[0]
    opts = {"minres_jacobi": dict(precond="jacobi"),
            "minres_cheb": dict(precond="cheb", cheb_interval=(0.9, 19.0))}.get(case, {})
    jop = st.SparseSymShiftSolve.create(A, method=method, **opts).set_shift(sigma)
    pop = stt.SparseSymShiftSolve.create(
        A, method=method, device="cpu", **opts
    ).set_shift(sigma)
    assert pop.method == jop.method == resolved
    x = np.random.default_rng(4).normal(size=n)
    y_j = np.asarray(jop.perform_op(jnp.asarray(x)))
    y_p = pop.perform_op(torch.from_numpy(x)).numpy()
    shifted = A - sigma * sps.eye(n)
    for y in (y_p, y_j):
        np.testing.assert_allclose(shifted @ y, x, atol=1e-9)
    if method == "splu":
        np.testing.assert_array_equal(y_p, y_j)
    assert np.abs(y_p - y_j).max() <= 1e-9 * np.abs(y_j).max()
    if method == "mg":
        assert len(pop.mg.ops) == len(jop.mg.ops)
        assert pop.mg.ops[0] is pop.shifted
    if method == "cheb":
        np.testing.assert_allclose(pop.cheb_interval, jop.cheb_interval, rtol=1e-9)


def test_cheb_alpha_adapts_like_jax():
    """A 1000x-overestimated lower interval bound self-corrects (as
    ``tests/test_shift_solve.py:191`` holds the JAX package) to the same
    adapted alpha as in the JAX package, and the solve reaches its
    tolerance."""
    import jax

    from spectra_tpu.linalg.cheb_solve import chebyshev_solve_state as jcs
    from spectra_tpu.sparse import formats as jf
    from spectra_tpu_torch.linalg.cheb_solve import chebyshev_solve_state
    from spectra_tpu_torch.sparse.formats import dia_from_scipy

    g = 60
    A = lap2d(g)
    alpha0 = 1000 * 2 * 4 * np.sin(np.pi / (2 * (g + 1))) ** 2
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    jd = jf.dia_from_scipy(A)
    xj, rj, aj = jax.jit(
        lambda m, v: jcs(m.matvec, v, alpha0, 8.0, rtol=1e-10, maxiter=60000)
    )(jd, jnp.asarray(b))
    pd = dia_from_scipy(A, device="cpu")
    xp, rp, ap = chebyshev_solve_state(
        pd.matvec, torch.from_numpy(b), alpha0, 8.0, rtol=1e-10, maxiter=60000
    )
    assert rp <= 1e-10 and float(rj) <= 1e-10
    assert ap < alpha0
    np.testing.assert_allclose(ap, float(aj), rtol=1e-12)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(xj)).max())


def test_cg_stopping_rule_matches_jax():
    """The port's CG stops where ``jax.scipy.sparse.linalg.cg`` stops:
    same iterate after the same number of steps."""
    import jax.scipy.sparse.linalg as jspla

    A = lap2d(10)
    Ad = jnp.asarray(A.toarray())
    b = np.random.default_rng(6).normal(size=100)
    for tol, maxiter in ((1e-6, 1000), (1e-12, 1000), (1e-12, 7)):
        xj, _ = jspla.cg(lambda v: Ad @ v, jnp.asarray(b), tol=tol,
                         maxiter=maxiter)
        xp = cg(lambda v: torch.from_numpy(A @ v.numpy()), torch.from_numpy(b),
                tol=tol, maxiter=maxiter)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-12 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("method", ["splu", "cg", "minres", "cheb", "mg"])
def test_shift_invert_anisotropic_matches_jax(method):
    """k=4 nearest sigma=0 on the anisotropic grid: same nconv, info,
    restarts and operations as the JAX package, eigenvalues within
    1e-10 of it and of the analytic spectrum."""
    g = 30
    A = aniso(g)
    v0 = SimpleRandom(0).random_vec(g * g)
    jop = st.SparseSymShiftSolve.create(A, method=method).set_shift(0.0)
    js = st.SymEigsShiftSolver.from_factored(jop, 4, 12, 0.0)
    js.init(v0)
    jn = js.compute(st.SortRule.LargestMagn, maxit=100, tol=1e-10)
    pop = stt.SparseSymShiftSolve.create(A, method=method, device="cpu").set_shift(0.0)
    ps = stt.SymEigsShiftSolver.from_factored(pop, 4, 12, 0.0)
    ps.init(v0)
    pn = ps.compute(stt.SortRule.LargestMagn, maxit=100, tol=1e-10)
    assert pop.method == jop.method
    assert pn == jn == 4
    assert ps.info().name == js.info().name == "Successful"
    assert ps.num_iterations() == js.num_iterations()
    assert ps.num_operations() == js.num_operations()
    vals = ps.eigenvalues()
    np.testing.assert_allclose(vals, np.asarray(js.eigenvalues()), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.sort(vals), aniso_eigs(g, 4), rtol=0, atol=1e-10)
    vecs = ps.eigenvectors().numpy()
    assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-9


def _lap3d_eigs(g):
    mu = 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None, None] + mu[None, :, None] + mu[None, None, :]).ravel())


def test_north_star_shape_g24_matches_jax():
    """The north star's shape at g=24 (n = 13,824): k=20, ncv=40, sigma=0,
    multigrid, plain ``compute``. Each package is held only to what plain
    ``compute`` guarantees: 20 converged values, ``Successful``, sorted,
    each within 1e-9 of an analytic eigenvalue, and every port value
    within 1e-10 of some JAX value. Not to equal arrays or equal counts:
    this spectrum has multiplicities, and which copies of a repeated
    eigenvalue one Krylov sequence catches is decided by rounding
    (ROADMAP.md section 3), so the two packages may keep different copies
    (on one machine the port kept 5, 3, 1 copies of the 6-fold 0.219051,
    the 3-fold 0.266114 and 0.278928 where the JAX package kept 4, 3, 2).
    ``test_north_star_shape_locked_matches_jax``
    (``tests/test_torch_locking.py``) holds both to the complete multiset."""
    g = 24
    A = lap3d(g)
    v0 = SimpleRandom(0).random_vec(g**3)
    kw = dict(maxit=60, tol=1e-10)
    jop = st.SparseSymShiftSolve.create(A, method="mg").set_shift(0.0)
    js = st.SymEigsShiftSolver.from_factored(jop, 20, 40, 0.0)
    js.init(v0)
    jn = js.compute(st.SortRule.LargestMagn, sorting=st.SortRule.SmallestAlge, **kw)
    pop = stt.SparseSymShiftSolve.create(A, method="mg", device="cpu").set_shift(0.0)
    assert all(isinstance(o, DiaMatrix) for o in pop.mg.ops)
    ps = stt.SymEigsShiftSolver.from_factored(pop, 20, 40, 0.0)
    ps.init(v0)
    pn = ps.compute(stt.SortRule.LargestMagn, sorting=stt.SortRule.SmallestAlge, **kw)
    assert pn == jn == 20
    assert ps.info().name == js.info().name == "Successful"
    lam = _lap3d_eigs(g)
    pv, jv = ps.eigenvalues(), np.asarray(js.eigenvalues())
    for vals in (pv, jv):
        assert np.all(np.diff(vals) >= 0)
        assert max(np.abs(lam - v).min() for v in vals) < 1e-9
    assert max(np.abs(jv - v).min() for v in pv) < 1e-10


def test_locked_rounds_couple_inner_tolerance():
    """A shift-solve inside a ``LockedArnoldiOp`` gets the coupled inner
    tolerance too, so locked rounds do not solve at a stale one."""
    from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, LockedArnoldiOp

    op = stt.SparseSymShiftSolve.create(lap2d(8), method="cg", device="cpu").set_shift(0.0)
    blk = torch.zeros((1, 64), dtype=torch.float64)
    blk[0, 0] = 1.0
    locked = LockedArnoldiOp(ArnoldiOp(op), (blk,))
    coupled = couple_inner_tolerance(locked, 1e-6)
    assert isinstance(coupled, LockedArnoldiOp) and coupled.locked == locked.locked
    assert coupled.inner.op.inner_rtol == coupled_inner_rtol(1e-6, torch.float64)
    assert locked.inner.op.inner_rtol is None
    pinned = LockedArnoldiOp(ArnoldiOp(op.with_inner_rtol(1e-9)), (blk,))
    assert couple_inner_tolerance(pinned, 1e-6) is pinned


def test_sorting_and_shift_of_back_transformed():
    """Returned eigenvalues follow ``sorting`` on lambda, and the
    constructor path (``set_shift`` inside) equals ``from_factored``."""
    A = aniso(16)
    v0 = SimpleRandom(0).random_vec(256)
    sigma = 0.3
    ws = stt.SparseSymShiftSolve.create(A, method="splu", device="cpu")
    s1 = stt.SymEigsShiftSolver(ws, 4, 12, sigma)
    s1.init(v0)
    s1.compute(stt.SortRule.LargestMagn, sorting=stt.SortRule.SmallestAlge)
    s2 = stt.SymEigsShiftSolver.from_factored(ws.set_shift(sigma), 4, 12, sigma)
    s2.init(v0)
    s2.compute(stt.SortRule.LargestMagn, sorting=stt.SortRule.LargestAlge)
    v1, v2 = s1.eigenvalues(), s2.eigenvalues()
    assert np.all(np.diff(v1) >= 0) and np.all(np.diff(v2) <= 0)
    np.testing.assert_allclose(v1, v2[::-1], rtol=0, atol=1e-12)
    w = np.linalg.eigvalsh(A.toarray())
    np.testing.assert_allclose(v1, np.sort(w[np.argsort(np.abs(w - sigma))[:4]]),
                               atol=1e-10)


def test_recompute_tighter_tol_recouples_inner_rtol():
    """A second ``compute`` with a tighter tol tightens the inner solve
    too (``tests/test_shift_solve.py:296``)."""
    g = 12
    A = aniso(g)
    v0 = SimpleRandom(0).random_vec(g * g)
    op = stt.SparseSymShiftSolve.create(A, method="minres", device="cpu")
    eigs = stt.SymEigsShiftSolver(op, nev=4, ncv=16, sigma=0.0)
    eigs.init(v0)
    eigs.compute(stt.SortRule.LargestMagn, tol=1e-2)
    assert eigs._arnop.op.inner_rtol == coupled_inner_rtol(1e-2, torch.float64)
    eigs.init(v0)
    nconv = eigs.compute(stt.SortRule.LargestMagn, tol=1e-10)
    assert eigs._arnop.op.inner_rtol == coupled_inner_rtol(1e-10, torch.float64)
    assert nconv == 4
    np.testing.assert_allclose(np.sort(eigs.eigenvalues()), aniso_eigs(g, 4), atol=1e-9)


def test_user_inner_rtol_survives_coupling():
    """``tests/test_shift_solve.py:326``: a user-set inner_rtol is never
    overridden by the per-compute coupling."""
    A = lap2d(8)
    op = stt.SparseSymShiftSolve.create(
        A, method="minres", inner_rtol=3e-7, device="cpu"
    ).set_shift(0.0)
    assert op.inner_rtol_user
    assert couple_inner_tolerance(op, 1e-10).inner_rtol == 3e-7
    pinned = op.with_inner_rtol(1e-9)
    assert couple_inner_tolerance(pinned, 1e-3).inner_rtol == 1e-9
    free = stt.SparseSymShiftSolve.create(A, method="cg", device="cpu").set_shift(0.0)
    assert free.inner_rtol is None
    assert couple_inner_tolerance(free, 1e-6).inner_rtol == 1e-8


def test_cheb_interval_translates_across_shifts():
    """A sigma sweep reuses the learned interval by exact translation
    (bitwise), as ``tests/test_shift_solve.py:243`` holds the JAX
    package; the translated operator still solves."""
    A = aniso(30)
    w = stt.SparseSymShiftSolve.create(A, method="cheb", device="cpu")
    a1, b1 = w.set_shift(0.0).cheb_interval
    assert a1 > 0
    op2 = w.set_shift(-0.5)
    assert op2.cheb_interval == (a1 + 0.5, b1 + 0.5)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    y = op2.with_inner_rtol(1e-12).perform_op(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose((A + 0.5 * sps.eye(A.shape[0])) @ y, x, atol=1e-9)


def test_method_routing_matches_jax():
    """``minres`` upgrades to multigrid on a grid; ``mg`` falls back to
    MINRES with a warning on a non-grid matrix and on a deep indefinite
    shift; an unpreconditioned inner solve that fails is NaN-poisoned."""
    assert stt.SparseSymShiftSolve.create(
        lap2d(24), method="minres", device="cpu"
    ).set_shift(0.0).method == "mg"
    R = sps.random(150, 150, density=0.03, random_state=5)
    S = (R + R.T + 10 * sps.eye(150)).tocsr()
    for A, sigma in ((S, 0.0), (lap2d(32), 4.0)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            op = stt.SparseSymShiftSolve.create(A, method="mg", device="cpu").set_shift(sigma)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jop = st.SparseSymShiftSolve.create(A, method="mg").set_shift(sigma)
        assert op.method == jop.method == "minres"
        assert any("mg" in str(c.message) for c in caught)


def test_poisoning_matches_jax():
    """An inner solution whose backward error exceeds the bar becomes
    NaN, as in the JAX package; a good one passes unchanged."""
    from spectra_tpu.matop.shift_solve import _poison_if_unconverged as jpoison
    from spectra_tpu_torch.matop.shift_solve import _poison_if_unconverged

    A = lap2d(16)
    b = np.random.default_rng(8).normal(size=256)
    y = np.linalg.solve(A.toarray(), b)
    for dy in (0.0, 1e-12, 1e-6):
        y2 = y + dy
        want = np.asarray(jpoison(lambda v: jnp.asarray(A @ np.asarray(v)),
                                  jnp.asarray(y2), jnp.asarray(b), 8.0))
        got = _poison_if_unconverged(
            lambda v: torch.from_numpy(A @ v.numpy()), torch.from_numpy(y2),
            torch.from_numpy(b), 8.0,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isnan(got).all() == (dy == 1e-6)


def test_mg_counters_and_singular_shift():
    before = (pmg.CYCLES, pmg.SOLVES)
    op = stt.SparseSymShiftSolve.create(lap2d(16), method="mg", device="cpu").set_shift(0.0)
    assert pmg.SOLVES == before[1] + 1  # the build-time trial solve
    op.perform_op(torch.ones(256, dtype=torch.float64))
    assert pmg.SOLVES == before[1] + 2 and pmg.CYCLES > before[0]
    with pytest.raises(stt.matop.shift_solve.ShiftFactorizationError):
        stt.SparseSymShiftSolve.create(
            sps.diags([1.0, 2.0, 3.0]).tocsr(), method="splu", device="cpu"
        ).set_shift(2.0)
