"""The port's symmetric solvers against the JAX package: the slice as a
whole, from scipy matrix to eigenpairs, on the CPU.

Two matrices:
* L30, the g=30 2-D Laplacian, whose spectrum ``mu_i + mu_j`` has
  double eigenvalues. The second copy of a double eigenvalue enters the
  Krylov space only through rounding, so the restart and operation
  counts follow the rounding noise: a one-ulp change of one entry of
  the start vector moves the JAX package's own counts (14/303 ->
  14/304 for LargestAlge, 16/350 -> 16/351 for SmallestAlge; see
  ``test_l30_counts_follow_rounding_in_the_reference``). The port sums
  its products in another order than XLA, so on L30 it is held to the
  JAX eigenpairs and to counts within one restart.
* AN30, the anisotropic grid ``kron(I, L1) + 0.7 kron(L1, I)``, whose
  extreme eigenvalues are simple. There the counts are a property of
  the algorithm, and the port must give exactly the JAX counts.

Eigenvalues agree within 1e-10 (1e-12 for the filtered solver), and
eigenvectors up to sign within 1e-8 (as spans where eigenvalues are
double).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.solvers.cheb_sym_eigs import ChebSymEigsSolver as JCheb
from spectra_tpu.util.rng import SimpleRandom
import spectra_tpu_torch as stt

torch.set_num_threads(1)

G = 30
NEV, NCV = 6, 30


def _lap1(g):
    return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))


def _mu(g):
    return 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2


MATRICES = {
    "L30": (
        (sps.kron(sps.eye(G), _lap1(G)) + sps.kron(_lap1(G), sps.eye(G))).tocsr(),
        np.sort((_mu(G)[:, None] + _mu(G)[None, :]).ravel()),
    ),
    "AN30": (
        (sps.kron(sps.eye(G), _lap1(G))
         + 0.7 * sps.kron(_lap1(G), sps.eye(G))).tocsr(),
        np.sort((_mu(G)[:, None] + 0.7 * _mu(G)[None, :]).ravel()),
    ),
}


def _start(nudge=False):
    v0 = SimpleRandom(0).random_vec(G * G)
    if nudge:
        v0[7] = np.nextafter(v0[7], 1.0)
    return v0


def _run_jax(name, rule, nudge=False):
    A = MATRICES[name][0]
    s = st.SymEigsSolver(st.SparseSymMatProd.from_full(A), nev=NEV, ncv=NCV)
    s.init(_start(nudge))
    s.compute(getattr(st.SortRule, rule), maxit=500, tol=1e-10)
    return s


def _run_port(name, rule, chunk=None):
    A = MATRICES[name][0]
    s = stt.SymEigsSolver(
        stt.SparseSymMatProd.from_full(A, device="cpu"), nev=NEV, ncv=NCV
    )
    s.set_restart_chunk(chunk)
    s.init(_start())
    s.compute(getattr(stt.SortRule, rule), maxit=500, tol=1e-10)
    return s


_CACHE = {}


def _cached(*key):
    if key not in _CACHE:
        run = {"jax": _run_jax, "port": _run_port}[key[0]]
        _CACHE[key] = run(*key[1:])
    return _CACHE[key]


def _wanted(name, rule, k):
    lam = MATRICES[name][1]
    return lam[-k:][::-1] if rule.startswith("Largest") else lam[:k][::-1]


def _check_pairs(name, rule, j, p):
    assert p.info() == stt.CompInfo.Successful
    assert j.info() == st.CompInfo.Successful
    jv, pv = np.asarray(j.eigenvalues()), p.eigenvalues()
    assert len(pv) == len(jv) == NEV
    np.testing.assert_allclose(pv, jv, atol=1e-10, rtol=0)
    np.testing.assert_allclose(pv, _wanted(name, rule, NEV), atol=1e-10, rtol=0)
    A = MATRICES[name][0]
    X = p.eigenvectors().numpy()
    np.testing.assert_allclose(A @ X - X * pv, 0.0, atol=1e-8)
    # Same invariant subspaces: compare projectors, which a rotation
    # inside the eigenspace of a double eigenvalue leaves unchanged.
    Y = np.asarray(j.eigenvectors())
    np.testing.assert_allclose(X @ X.T, Y @ Y.T, atol=1e-8)


@pytest.mark.parametrize("rule", ["LargestAlge", "SmallestAlge"])
def test_l30_matches_jax(rule):
    j, p = _cached("jax", "L30", rule), _cached("port", "L30", rule)
    _check_pairs("L30", rule, j, p)
    assert abs(p.num_iterations() - j.num_iterations()) <= 1
    assert abs(p.num_operations() - j.num_operations()) <= NCV


@pytest.mark.parametrize("rule", ["LargestAlge", "SmallestAlge"])
def test_l30_counts_follow_rounding_in_the_reference(rule):
    """The JAX package itself, from a start vector one ulp away in one
    entry, makes a different number of operator applications on L30."""
    j = _cached("jax", "L30", rule)
    nudged = _cached("jax", "L30", rule, True)
    assert nudged.info() == st.CompInfo.Successful
    assert (nudged.num_iterations(), nudged.num_operations()) != (
        j.num_iterations(), j.num_operations()
    )


@pytest.mark.parametrize("rule", ["LargestAlge", "SmallestAlge"])
def test_counts_equal_jax_on_simple_spectrum(rule):
    j, p = _cached("jax", "AN30", rule), _cached("port", "AN30", rule)
    _check_pairs("AN30", rule, j, p)
    assert p.num_iterations() == j.num_iterations()
    assert p.num_operations() == j.num_operations()
    # Simple eigenvalues: eigenvectors agree up to sign.
    X, Y = p.eigenvectors().numpy(), np.asarray(j.eigenvectors())
    np.testing.assert_allclose(X * np.sign(np.sum(X * Y, axis=0)), Y, atol=1e-8)


def test_restart_chunk_is_bit_identical():
    one = _cached("port", "L30", "LargestAlge")
    chunked = _run_port("L30", "LargestAlge", chunk=3)
    np.testing.assert_array_equal(chunked.eigenvalues(), one.eigenvalues())
    assert torch.equal(chunked.eigenvectors(), one.eigenvectors())
    assert chunked.num_iterations() == one.num_iterations()
    assert chunked.num_operations() == one.num_operations()
    hist = chunked.convergence_history()
    assert hist[-1]["nconv"] >= NEV
    assert [h["restarts"] for h in hist][:2] == [3, 6]


def _cheb(pkg, name):
    A = MATRICES[name][0]
    kw = dict(nev=10, ncv=NCV, which="largest", degree=20, cut_fraction=0.1)
    if pkg == "jax":
        s = JCheb(st.SparseSymMatProd.from_full(A), **kw)
    else:
        s = stt.ChebSymEigsSolver(
            stt.SparseSymMatProd.from_full(A, device="cpu"), **kw
        )
    s.init()
    s.compute(maxit=60)
    return s


@pytest.mark.parametrize("name", ["L30", "AN30"])
def test_cheb_matches_jax(name):
    j, p = _cheb("jax", name), _cheb("port", name)
    assert p.info() == stt.CompInfo.Successful
    assert j.info() == st.CompInfo.Successful
    pv, jv = p.eigenvalues(), np.asarray(j.eigenvalues())
    assert len(pv) == len(jv) == 10
    np.testing.assert_allclose(pv, jv, atol=1e-12, rtol=0)
    np.testing.assert_allclose(pv, _wanted(name, "Largest", 10), atol=1e-12, rtol=0)
    assert p.num_iterations() == j.num_iterations() == 2
    if name == "AN30":
        assert p.num_operations() == j.num_operations()
    else:
        assert abs(p.num_operations() - j.num_operations()) <= NCV


def test_float32_operator_converges():
    A = MATRICES["AN30"][0]
    op = stt.SparseSymMatProd.from_full(A, dtype=torch.float32, device="cpu")
    s = stt.SymEigsSolver(op, nev=4, ncv=20)
    s.init()
    assert s.compute(stt.SortRule.LargestAlge, tol=1e-5) == 4
    vals = s.eigenvalues()
    assert vals.dtype == np.float32
    assert s.eigenvectors().dtype == torch.float32
    np.testing.assert_allclose(vals, _wanted("AN30", "Largest", 4), atol=1e-4)


def test_solver_api_checks():
    op = stt.SparseSymMatProd.from_full(MATRICES["AN30"][0], device="cpu")
    with pytest.raises(ValueError):
        stt.SymEigsSolver(op, nev=0, ncv=5)
    with pytest.raises(ValueError):
        stt.SymEigsSolver(op, nev=5, ncv=5)
    s = stt.SymEigsSolver(op, nev=3, ncv=10)
    assert s.info() == stt.CompInfo.NotComputed
    assert s.eigenvalues().shape == (0,)
    assert tuple(s.eigenvectors().shape) == (G * G, 0)
    with pytest.raises(ValueError):
        s.init(np.zeros(G * G))
    with pytest.raises(ValueError):
        s.init(np.ones(5))
    for call, item in [
        (lambda: s.set_precision("mixed"), "item 16"),
        (lambda: stt.SymEigsSolver(op, nev=3, ncv=10, bop=op), "item 13"),
    ]:
        with pytest.raises(NotImplementedError, match=item):
            call()
    for call in (lambda: s.set_restart_method("qr"), lambda: s.set_reorth("some"),
                 lambda: s.set_precision("half")):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(RuntimeError, match="no iteration state"):
        s.save_checkpoint("unused.npz")
    s.set_restart_method("thick")
    s.set_reorth("selective")
    s.set_matvec_granularity(False)
    s.set_restart_method("implicit")
    s.set_reorth("full")
    s.set_precision("double")
    # A torch start vector is taken as it is.
    s.init(torch.from_numpy(SimpleRandom(0).random_vec(G * G)))
    assert s.compute(stt.SortRule.LargestMagn) == 3
    assert jnp.allclose(
        jnp.asarray(s.eigenvalues()), jnp.asarray(_wanted("AN30", "Largest", 3)),
        atol=1e-10,
    )


# -- thick restart, the stepped driver and checkpoints -------------------
#
# The cases of tests/test_sym_eigs.py:160-252, :254-325 and :356-420 on
# sparse operators (the dense ones wait for matop/dense.py): AN30, whose
# wanted eigenvalues are simple, so restarts and operations equal the JAX
# package's; the port's stepped and resumed runs are bitwise its own
# plain run.


def _driver(pkg, A, nev=6, ncv=12, rule="LargestMagn", restart="implicit",
            chunk=None, stepped=False, maxit=1000, resume=None, v0=None, tol=1e-10):
    mod = st if pkg == "jax" else stt
    kw = {} if pkg == "jax" else dict(device="cpu")
    s = mod.SymEigsSolver(mod.SparseSymMatProd.from_full(A, **kw), nev=nev, ncv=ncv)
    s.set_restart_method(restart)
    s.set_restart_chunk(chunk)
    s.set_matvec_granularity(stepped)
    s.init(_start() if v0 is None else v0)
    if resume is not None:
        s.load_checkpoint(resume)
    s.compute(getattr(mod.SortRule, rule), maxit=maxit, tol=tol)
    return s


def _same_run(a, b):
    np.testing.assert_array_equal(a.eigenvalues(), b.eigenvalues())
    assert torch.equal(a.eigenvectors(), b.eigenvectors())
    assert (a.num_iterations(), a.num_operations()) == (
        b.num_iterations(), b.num_operations()
    )


def _counts(s):
    return s.num_iterations(), s.num_operations()


@pytest.mark.parametrize("restart", ["implicit", "thick"])
def test_matvec_granularity_matches_plain(restart):
    """The stepped driver replays the plain run: bitwise the same values,
    vectors and counts, and the JAX package's stepped counts."""
    A = MATRICES["AN30"][0]
    plain = _driver("port", A, restart=restart)
    stepped = _driver("port", A, restart=restart, stepped=True)
    assert stepped.info() == stt.CompInfo.Successful
    _same_run(stepped, plain)
    j = _driver("jax", A, restart=restart, stepped=True)
    assert _counts(stepped) == _counts(j)
    np.testing.assert_allclose(stepped.eigenvalues(), np.asarray(j.eigenvalues()),
                               rtol=0, atol=1e-10)
    X = stepped.eigenvectors().numpy()
    assert np.abs(A @ X - X * stepped.eigenvalues()).max() < 1e-9


def test_matvec_granularity_shift_invert():
    """Stepped execution through the sparse shift-invert operator (one
    inner MINRES solve per operator application), as in the JAX
    package."""
    g = 30
    lap1 = _lap1(g)
    A = (sps.kron(sps.eye(g), lap1) + 1.37 * sps.kron(lap1, sps.eye(g))).tocsr()
    v0 = SimpleRandom(0).random_vec(g * g)
    out = {}
    for pkg, mod, kw in (("port", stt, dict(device="cpu")), ("jax", st, {})):
        op = mod.SparseSymShiftSolve.create(A, method="minres", **kw).set_shift(0.0)
        s = mod.SymEigsShiftSolver.from_factored(op, 4, 12, 0.0)
        s.set_matvec_granularity(True)
        s.init(v0)
        assert s.compute(mod.SortRule.LargestMagn, maxit=100, tol=1e-8) == 4
        out[pkg] = s
    vals = np.sort(out["port"].eigenvalues())
    mu = _mu(g)
    lam = np.sort((mu[:, None] + 1.37 * mu[None, :]).ravel())[:4]
    np.testing.assert_allclose(vals, lam, rtol=1e-7)
    assert _counts(out["port"]) == _counts(out["jax"])
    np.testing.assert_allclose(vals, np.sort(np.asarray(out["jax"].eigenvalues())),
                               rtol=0, atol=1e-10)


def test_checkpoint_resume_identical(tmp_path):
    """Save after two segments of five restarts, resume in a fresh
    solver: bitwise the uninterrupted chunked run (and the plain run),
    with the JAX package's counts."""
    A = MATRICES["AN30"][0]
    ref = _driver("port", A, chunk=5)
    part = _driver("port", A, chunk=5, maxit=10)
    assert part.info() == stt.CompInfo.NotConverging
    path = str(tmp_path / "state.npz")
    part.save_checkpoint(path)
    with np.load(path) as data:
        assert {"state_V", "state_H", "ritz_val", "restarts", "nev", "ncv"} <= set(data.files)
        assert int(data["restarts"]) == 10
    res = _driver("port", A, chunk=5, resume=path)
    assert res.info() == stt.CompInfo.Successful
    _same_run(res, ref)
    _same_run(res, _driver("port", A))
    assert _counts(res) == _counts(_driver("jax", A, chunk=5))
    bad = stt.SymEigsSolver(
        stt.SparseSymMatProd.from_full(A, device="cpu"), nev=5, ncv=12
    )
    with pytest.raises(ValueError, match="mismatch"):
        bad.load_checkpoint(path)


def test_thick_restart_matches_implicit():
    A = MATRICES["AN30"][0]
    results = {}
    for meth in ("implicit", "thick"):
        e = _driver("port", A, ncv=20, restart=meth)
        assert e.info() == stt.CompInfo.Successful
        v, u = e.eigenvalues(), e.eigenvectors().numpy()
        assert np.abs(A @ u - u * v[None, :]).max() < 1e-9
        results[meth] = e
        j = _driver("jax", A, ncv=20, restart=meth)
        assert _counts(e) == _counts(j)
        np.testing.assert_allclose(v, np.asarray(j.eigenvalues()), rtol=0, atol=1e-10)
    np.testing.assert_allclose(results["thick"].eigenvalues(),
                               results["implicit"].eigenvalues(), atol=1e-9)


def test_thick_restart_smallest_sparse():
    g = 14
    lap1 = _lap1(g)
    A = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    e = _driver("port", A, nev=5, ncv=24, rule="SmallestAlge", restart="thick",
                v0=SimpleRandom(0).random_vec(g * g))
    assert e.info() == stt.CompInfo.Successful
    true = np.sort(np.linalg.eigvalsh(A.toarray()))[:5]
    np.testing.assert_allclose(np.sort(e.eigenvalues()), true, atol=1e-9)


def test_matvec_granularity_checkpoint_resume(tmp_path):
    """A state saved by the chunked driver resumes under the stepped
    driver and equals the uninterrupted plain run bitwise."""
    A = MATRICES["AN30"][0]
    ref = _driver("port", A)
    part = _driver("port", A, chunk=5, maxit=10)
    path = str(tmp_path / "state.npz")
    part.save_checkpoint(path)
    res = _driver("port", A, stepped=True, resume=path)
    assert res.info() == stt.CompInfo.Successful
    _same_run(res, ref)


def test_matvec_granularity_breakdown_expansion():
    """An exact eigenvector start forces ||f|| = 0 at init, so step 1
    expands the basis with a random vector: the stepped driver takes the
    same branch (the expansion's extra operator application is counted)
    and the same values as the plain driver, as in the JAX package."""
    n = 50
    A = sps.diags(np.arange(1.0, n + 1.0)).tocsr()
    v0 = np.zeros(n)
    v0[-1] = 1.0
    ref = _driver("port", A, nev=3, ncv=8, v0=v0)
    stepped = _driver("port", A, nev=3, ncv=8, v0=v0, stepped=True)
    assert stepped.info() == stt.CompInfo.Successful
    _same_run(stepped, ref)
    np.testing.assert_allclose(np.sort(stepped.eigenvalues()),
                               [n - 2.0, n - 1.0, float(n)], atol=1e-9)
    j = _driver("jax", A, nev=3, ncv=8, v0=v0)
    np.testing.assert_allclose(np.sort(stepped.eigenvalues()),
                               np.sort(np.asarray(j.eigenvalues())), atol=1e-12)
