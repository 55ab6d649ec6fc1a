"""The port's selective (omega-recurrence) re-orthogonalization against
the JAX package: the cases of ``tests/test_selective_reorth.py`` with
sparse operators (its dense cases wait for ``matop/dense.py``).

``set_reorth("selective")`` replaces the always-on DGKS projections by
Simon's partial re-orthogonalization; the contract is a semiorthogonal
basis and Ritz pairs that match full re-orthogonalization to solver
tolerance. Where the wanted eigenvalues are simple (the anisotropic
grid AN30, a diagonal with distinct entries) the restart and operation
counts equal the JAX package's, and eigenvalues agree within 1e-10
(relative on the 1e4-scaled diagonal).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg import krylov as pkry
from spectra_tpu_torch.util.rng import SimpleRandom

torch.set_num_threads(1)


def _lap1(g):
    return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))


def _an30():
    g = 30
    return (sps.kron(sps.eye(g), _lap1(g)) + 0.7 * sps.kron(_lap1(g), sps.eye(g))).tocsr()


def _ghosting_diag():
    """Widely separated dominant eigenvalues: the classic case where
    Lanczos without re-orthogonalization produces ghost copies."""
    return sps.diags(np.linspace(1.0, 100.0, 500) ** 2).tocsr()


def _solve(pkg, A, k, m, rule, reorth="full", tol=1e-10, stepped=False,
           restart="implicit"):
    mod = st if pkg == "jax" else stt
    kw = {} if pkg == "jax" else dict(device="cpu")
    s = mod.SymEigsSolver(mod.SparseSymMatProd.from_full(A, **kw), nev=k, ncv=m)
    s.set_reorth(reorth)
    s.set_restart_method(restart)
    if stepped:
        s.set_matvec_granularity(True)
    s.init(SimpleRandom(0).random_vec(A.shape[0]))
    nconv = s.compute(getattr(mod.SortRule, rule), tol=tol)
    assert nconv == k
    assert s.info().name == "Successful"
    return s


def _vecs(s):
    v = s.eigenvectors()
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def test_rejects_unknown_method():
    op = stt.SparseSymMatProd.from_full(sps.eye(4).tocsr(), device="cpu")
    with pytest.raises(ValueError):
        stt.SymEigsSolver(op, 1, 3).set_reorth("sometimes")


@pytest.mark.parametrize("rule", ["LargestAlge", "SmallestAlge"])
def test_selective_counts_equal_jax_on_simple_spectrum(rule):
    A = _an30()
    p = _solve("port", A, 6, 20, rule, "selective")
    j = _solve("jax", A, 6, 20, rule, "selective")
    full = _solve("port", A, 6, 20, rule, "full")
    assert (p.num_iterations(), p.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )
    np.testing.assert_allclose(p.eigenvalues(), np.asarray(j.eigenvalues()),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(p.eigenvalues(), full.eigenvalues(), rtol=0, atol=1e-10)


def test_selective_skips_most_projections(monkeypatch):
    """The point of the mode: most steps pay no DGKS projection."""
    calls = []
    orig = pkry._reorth_loop
    monkeypatch.setattr(
        pkry, "_reorth_loop", lambda *a, **k: calls.append(1) or orig(*a, **k)
    )
    s = _solve("port", _an30(), 6, 20, "LargestAlge", "selective")
    steps = s.num_operations() - 2
    assert 0 < len(calls) < steps / 2


def test_fast_convergence_no_ghosts():
    A = _ghosting_diag()
    d = A.diagonal()
    p = _solve("port", A, 8, 24, "LargestMagn", "selective", tol=1e-12)
    j = _solve("jax", A, 8, 24, "LargestMagn", "selective", tol=1e-12)
    vals = np.sort(p.eigenvalues())
    want = np.sort(d)[-8:]
    assert np.abs((vals - want) / want).max() <= 1e-9
    X = _vecs(p)
    assert np.abs(X.T @ X - np.eye(8)).max() <= 1e-7  # semiorthogonality
    assert (p.num_iterations(), p.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )
    jv = np.sort(np.asarray(j.eigenvalues()))
    assert np.abs((vals - jv) / jv).max() <= 1e-10


def test_semiorthogonal_basis_residuals():
    rng = np.random.RandomState(11)
    R = sps.random(300, 300, density=0.05, random_state=rng, format="csr")
    A = (R + R.T).tocsr()
    p = _solve("port", A, 10, 30, "BothEnds", "selective")
    vals, X = p.eigenvalues(), _vecs(p)
    assert np.abs(A @ X - X * vals[None, :]).max() <= 1e-9
    j = _solve("jax", A, 10, 30, "BothEnds", "selective")
    np.testing.assert_allclose(np.sort(vals), np.sort(np.asarray(j.eigenvalues())),
                               rtol=0, atol=1e-10)


def test_shift_invert_selective():
    n = 400
    A = sps.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    v0 = SimpleRandom(0).random_vec(n)
    out = {}
    for pkg, mod, kw in (("port", stt, dict(device="cpu")), ("jax", st, {})):
        op = mod.SparseSymShiftSolve.create(A, **kw).set_shift(0.0)
        s = mod.SymEigsShiftSolver.from_factored(op, 4, 16, 0.0)
        s.set_reorth("selective")
        s.init(v0)
        assert s.compute(mod.SortRule.LargestMagn, tol=1e-10) == 4
        assert s.info().name == "Successful"
        out[pkg] = s
    vals = np.sort(out["port"].eigenvalues())
    i = np.arange(1, 5)
    want = 4 * np.sin(i * np.pi / (2 * (n + 1))) ** 2
    assert np.abs(vals - want).max() <= 1e-10
    assert out["port"].num_operations() == out["jax"].num_operations()
    np.testing.assert_allclose(vals, np.sort(np.asarray(out["jax"].eigenvalues())),
                               rtol=0, atol=1e-10)


def test_thick_restart_falls_back_to_full():
    A = _ghosting_diag()
    d = A.diagonal()
    op = stt.SparseSymMatProd.from_full(A, device="cpu")
    s = stt.SymEigsSolver(op, nev=8, ncv=16)
    s.set_restart_method("thick")
    s.set_reorth("selective")
    assert s._eff_mode() == "lanczos"
    s.set_restart_method("implicit")
    assert s._eff_mode() == "lanczos_selective"
    p = _solve("port", A, 8, 16, "LargestMagn", "selective", restart="thick")
    vals = np.sort(p.eigenvalues())
    want = np.sort(d)[-8:]
    assert np.abs((vals - want) / want).max() <= 1e-9
    X = _vecs(p)
    assert np.abs(X.T @ X - np.eye(8)).max() <= 1e-7
    j = _solve("jax", A, 8, 16, "LargestMagn", "selective", restart="thick")
    assert (p.num_iterations(), p.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )


def test_stepped_driver_selective_parity():
    """The stepped driver honors selective re-orthogonalization: the
    eigenvalues match the stepped full run within 1e-10 relative and the
    JAX package's stepped selective run's counts."""
    A = _ghosting_diag()
    d = A.diagonal()
    sel = _solve("port", A, 8, 24, "LargestMagn", "selective", tol=1e-12, stepped=True)
    vals = np.sort(sel.eigenvalues())
    want = np.sort(d)[-8:]
    assert np.abs((vals - want) / want).max() <= 1e-9
    full = np.sort(_solve("port", A, 8, 24, "LargestMagn", "full", tol=1e-12,
                          stepped=True).eigenvalues())
    assert np.abs((vals - full) / full).max() <= 1e-10
    X = _vecs(sel)
    assert np.abs(X.T @ X - np.eye(8)).max() <= 1e-7
    j = _solve("jax", A, 8, 24, "LargestMagn", "selective", tol=1e-12, stepped=True)
    assert (sel.num_iterations(), sel.num_operations()) == (
        j.num_iterations(), j.num_operations()
    )


def test_stepped_selective_matches_unstepped_selective():
    """The same mode through the plain and the stepped driver: bitwise
    the same values and counts (one loop, run in segments of one
    restart)."""
    A = _an30()
    plain = _solve("port", A, 6, 20, "LargestMagn", "selective")
    stepped = _solve("port", A, 6, 20, "LargestMagn", "selective", stepped=True)
    np.testing.assert_array_equal(stepped.eigenvalues(), plain.eigenvalues())
    assert torch.equal(stepped.eigenvectors(), plain.eigenvectors())
    assert (stepped.num_iterations(), stepped.num_operations()) == (
        plain.num_iterations(), plain.num_operations()
    )
    assert len(stepped.convergence_history()) == stepped.num_iterations() - 1
