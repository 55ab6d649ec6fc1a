"""The port's ``compute_locked`` (locking / deflated continuation) against
the JAX package: the cases of ``tests/test_locking.py`` with sparse
operators (its dense cases take a diagonal matrix of the same spectrum;
the B-metric case waits for ROADMAP.md item 13).

Both packages run the same matrices from the same start vectors. Each
must be ``certified()``, return the wanted set with its full
multiplicity, and the two multisets agree within 1e-10. The port's
eigenvectors are eigenpairs and orthonormal across rounds. The north
star's shape (3-D Laplacian, k=20, multigrid shift-invert) runs here at
g=16; ``tests/test_torch_shift_solve.py`` holds its plain ``compute`` at
g=24.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.solvers.cheb_sym_eigs import ChebSymEigsSolver as JCheb
import spectra_tpu_torch as stt
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, LockedArnoldiOp
from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.util.rng import SimpleRandom

torch.set_num_threads(1)


def _laplacian_2d(g):
    l1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    e = sps.eye(g)
    return (sps.kron(l1, e) + sps.kron(e, l1)).tocsr()


def _lap2d_spectrum(g):
    i = np.arange(1, g + 1)
    mu = 4 * np.sin(np.pi * i / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None] + mu[None, :]).ravel())


def _laplacian_3d(g):
    l1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    e = sps.eye(g)
    return (
        sps.kron(sps.kron(l1, e), e) + sps.kron(sps.kron(e, l1), e)
        + sps.kron(sps.kron(e, e), l1)
    ).tocsr()


def _lap3d_spectrum(g):
    mu = 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None, None] + mu[None, :, None] + mu[None, None, :]).ravel())


def _cycle(n):
    A = (
        sps.diags([2.0] * n) + sps.diags([-1.0] * (n - 1), 1)
        + sps.diags([-1.0] * (n - 1), -1)
    ).tolil()
    A[0, n - 1] = A[n - 1, 0] = -1.0
    return A.tocsr()


def _triple_top(n=80):
    return sps.diags(np.concatenate([[9.0, 9.0, 9.0], np.linspace(1.0, 5.0, n - 3)])).tocsr()


def _both(A, nev, ncv, rule, v0=None, **kw):
    """compute_locked in both packages; returns (port, jax) solvers."""
    out = []
    for mod, dev in ((stt, dict(device="cpu")), (st, {})):
        s = mod.SymEigsSolver(mod.SparseSymMatProd.from_full(A, **dev), nev=nev, ncv=ncv)
        s.init(v0)
        rules = {k: getattr(mod.SortRule, v) for k, v in kw.items()
                 if k in ("sorting", "want")}
        other = {k: v for k, v in kw.items() if k not in ("sorting", "want")}
        s.compute_locked(getattr(mod.SortRule, rule), **rules, **other)
        out.append(s)
    return out


def _check(p, j, want_vals, atol=1e-9):
    for s in (p, j):
        assert s.certified()
        assert s.info().name == "Successful"
    pv, jv = p.eigenvalues(), np.asarray(j.eigenvalues())
    np.testing.assert_allclose(np.sort(pv), np.sort(want_vals), atol=atol, rtol=0)
    np.testing.assert_allclose(np.sort(pv), np.sort(jv), atol=1e-10, rtol=0)
    return pv


def test_degenerate_smallest_full_multiplicity():
    g = 16
    A = _laplacian_2d(g)
    p, j = _both(A, 4, 16, "SmallestAlge", sorting="SmallestAlge")
    lam = _check(p, j, _lap2d_spectrum(g)[:4])
    X = p.eigenvectors().numpy()
    assert np.abs(A @ X - X * lam[None, :]).max() < 1e-8
    np.testing.assert_allclose(X.T @ X, np.eye(4), atol=1e-8)


def test_cycle_laplacian_issue_144():
    n = 64
    true = np.sort(2.0 - 2.0 * np.cos(2.0 * np.pi * np.arange(n) / n))
    p, j = _both(_cycle(n), 6, 18, "SmallestAlge", sorting="SmallestAlge")
    _check(p, j, true[:6])


def test_shift_invert_locked_smallest():
    g = 12
    A = _laplacian_2d(g)
    out = []
    for mod, dev in ((stt, dict(device="cpu")), (st, {})):
        op = mod.SparseSymShiftSolve.create(A, **dev).set_shift(0.0)
        s = mod.SymEigsShiftSolver.from_factored(op, 6, 20, 0.0)
        s.init()
        assert s.compute_locked(
            mod.SortRule.LargestMagn, sorting=mod.SortRule.SmallestAlge,
            want=mod.SortRule.SmallestAlge,
        ) == 6
        out.append(s)
    _check(*out, _lap2d_spectrum(g)[:6])


def test_high_multiplicity():
    """Multiplicity 3 at the top: one Krylov run from one vector never
    returns three copies."""
    p, j = _both(_triple_top(), 4, 16, "LargestAlge")
    _check(p, j, [9.0, 9.0, 9.0, 5.0], atol=1e-8)


def test_certified_without_degeneracy_one_extra_round():
    d = np.linspace(1.0, 10.0, 200)
    p, j = _both(sps.diags(d).tocsr(), 3, 12, "LargestAlge")
    _check(p, j, np.sort(d)[-3:])
    assert len(p.locking_rounds()) == 2


def test_ncv_locked_continuation_rounds():
    p, j = _both(_triple_top(), 4, 20, "LargestAlge", ncv_locked=10)
    _check(p, j, [9.0, 9.0, 9.0, 5.0], atol=1e-8)
    assert p._ncv == 20
    with pytest.raises(ValueError):
        p.compute_locked(stt.SortRule.LargestAlge, ncv_locked=3)


def test_zero_convergence_leaves_clean_state():
    rng = np.random.RandomState(1)
    R = sps.random(200, 200, density=0.1, random_state=rng, format="csr")
    A = (R + R.T).tocsr()
    s = stt.SymEigsSolver(stt.SparseSymMatProd.from_full(A, device="cpu"), nev=6, ncv=10)
    s.init()
    nconv = s.compute_locked(stt.SortRule.LargestMagn, maxit=1)
    if nconv == 0:
        assert s.eigenvalues().size == 0
        assert s.eigenvectors().shape[1] == 0


def test_compute_locked_restores_v0():
    n = 120
    A = sps.diags(np.linspace(1.0, 12.0, n)).tocsr()
    s = stt.SymEigsSolver(stt.SparseSymMatProd.from_full(A, device="cpu"), nev=3, ncv=12)
    my_v0 = np.linspace(1.0, 2.0, n)
    s.init(my_v0)
    arnop = s._arnop
    s.compute_locked(stt.SortRule.LargestAlge)
    np.testing.assert_allclose(s._v0.numpy(), my_v0)
    assert s._arnop is arnop
    with pytest.raises(ValueError):
        s.compute_locked(stt.SortRule.BothEnds, want=stt.SortRule.BothEnds)


def test_locked_operator_deflates():
    """``P A P`` annihilates the locked block, and the residual of a
    step on it carries no locked component."""
    A = _laplacian_2d(10)
    inner = ArnoldiOp(stt.SparseSymMatProd.from_full(A, device="cpu"))
    Q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(100, 5)))
    blocks = (torch.from_numpy(Q[:, :2].T.copy()), torch.from_numpy(Q[:, 2:].T.copy()))
    op = LockedArnoldiOp(inner, blocks)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=100))
    y = op.perform_op(x)
    assert float(np.abs(Q.T @ y.numpy()).max()) < 1e-12
    for b in blocks:
        assert float(op.perform_op(b[0]).abs().max()) < 1e-12
    assert op.dtype == torch.float64 and op.rows() == 100


def test_cheb_solver_locked_largest():
    """``ChebSymEigsSolver`` through ``compute_locked``: the 4 largest of
    the g=16 Laplacian with their multiplicity, as in the JAX package."""
    g = 16
    A = _laplacian_2d(g)
    kw = dict(nev=4, ncv=16, which="largest", degree=20, cut_fraction=0.1)
    p = ChebSymEigsSolver(stt.SparseSymMatProd.from_full(A, device="cpu"), **kw)
    j = JCheb(st.SparseSymMatProd.from_full(A), **kw)
    for s, mod in ((p, stt), (j, st)):
        s.init()
        s.compute_locked(mod.SortRule.LargestMagn, maxit=60)
    _check(p, j, _lap2d_spectrum(g)[-4:])


def test_north_star_shape_locked_matches_jax():
    """The north star's shape (g=16, n = 4,096, k=20, ncv=40, sigma=0,
    multigrid) through ``compute_locked(LargestMagn, sorting=SmallestAlge,
    want=SmallestAlge, max_rounds=3)``, as
    ``scripts/tpu_northstar_100m.py`` runs it: both packages are
    ``certified()``, return exactly the 20 smallest eigenvalues with
    their multiplicity (within 1e-9 of the analytic list, element by
    element) and agree within 1e-10. g=16 keeps the file's time down:
    the locked rounds cost three plain runs in each package."""
    g = 16
    A = _laplacian_3d(g)
    v0 = SimpleRandom(0).random_vec(g**3)
    lam = _lap3d_spectrum(g)[:20]
    out = []
    for mod, kw in ((stt, dict(device="cpu")), (st, {})):
        op = mod.SparseSymShiftSolve.create(A, method="mg", **kw).set_shift(0.0)
        s = mod.SymEigsShiftSolver.from_factored(op, 20, 40, 0.0)
        s.init(v0)
        nconv = s.compute_locked(
            mod.SortRule.LargestMagn, maxit=60, tol=1e-10,
            sorting=mod.SortRule.SmallestAlge, want=mod.SortRule.SmallestAlge,
            max_rounds=3,
        )
        assert nconv == 20 and s.certified()
        assert s.info().name == "Successful"
        vals = np.asarray(s.eigenvalues())
        assert np.all(np.diff(vals) >= 0)
        np.testing.assert_allclose(vals, lam, rtol=0, atol=1e-9)
        out.append(vals)
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-10)
