"""A non-finite operator in the port's solvers against the JAX package.

The matrix is tridiagonal, n = 100: diagonal ``linspace(1, 10)``,
off-diagonals 1, and a NaN at (50, 50). Every Lanczos solver of the
JAX package ends on it with ``CompInfo.NumericalIssue``, and its
frontends raise ``NoConvergence`` with ``info=NumericalIssue``;
``test_port_matches_reference`` holds the port to the same ``info``,
``nconv``, ``num_iterations()`` and ``num_operations()``, or to the same
exception class and its ``NumericalIssue``, case by case (nev 4, ncv 12,
maxit 50, ``LargestAlge`` unless a case says otherwise). It also holds
the other dense linear algebra that a non-finite operator reaches (the
Chebyshev bounds, LOBPCG's whitening, the JD family, mixed precision's
refinement, the QR of the JD basis) to the JAX package's outcome.

Two paths where the reference is at fault (``ROADMAP.md`` section 3,
"Faults of the reference") hold the port alone: ``GenEigsSolver``,
whose JAX ``np.linalg.eig`` raises inside a ``pure_callback``, and the
dense Bunch-Kaufman shift-invert, whose JAX factorization returns
finite factors that do not solve the system. The port ends the first
with ``NumericalIssue`` and refuses the second at ``set_shift`` with
``ShiftFactorizationError``.

The guard is one helper, ``linalg.jacobi.eigh_accurate``: a non-finite
matrix gives NaN pairs, as ``jnp.linalg.eigh`` does, and a finite one
goes to ``torch.linalg.eigh`` as it is, which
``test_eigh_helpers_bitwise_on_finite_input`` holds bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
import spectra_tpu_torch as stt

torch.set_num_threads(1)

N = 100
NEV, NCV, MAXIT = 4, 12, 50


def _tridiag(nan=True, scale=1.0):
    A = sps.diags(
        [np.ones(N - 1), np.linspace(1.0, 10.0, N) * scale, np.ones(N - 1)],
        [-1, 0, 1],
    ).toarray()
    if nan:
        A[50, 50] = np.nan
    return A


def _dev(pkg):
    return {"device": "cpu"} if pkg is stt else {}


def _counts(s, nconv, ops=None):
    ops = s.num_operations() if ops is None else ops
    return (s.info().name, int(nconv), s.num_iterations(), ops)


def _sym(pkg, *, dense=False, restart=None, stepped=False, locked=False,
         A=None, precision=None, tol=1e-10):
    A = _tridiag() if A is None else A
    if dense:
        op = pkg.DenseSymMatProd.create(A, **_dev(pkg))
    else:
        op = pkg.SparseSymMatProd.from_full(sps.csr_matrix(A), **_dev(pkg))
    s = pkg.SymEigsSolver(op, nev=NEV, ncv=NCV)
    if restart:
        s.set_restart_method(restart)
    if stepped:
        s.set_matvec_granularity(True)
    if precision:
        s.set_precision(precision)
    s.init()
    run = s.compute_locked if locked else s.compute
    return _counts(s, run(pkg.SortRule.LargestAlge, maxit=MAXIT, tol=tol))


def _herm(pkg):
    op = pkg.DenseHermMatProd.create(_tridiag().astype(complex), **_dev(pkg))
    s = pkg.HermEigsSolver(op, nev=NEV, ncv=NCV)
    s.init()
    return _counts(s, s.compute(pkg.SortRule.LargestAlge, maxit=MAXIT))


def _partial_svd(pkg, mat):
    s = pkg.PartialSVDSolver(mat, NEV, NCV, **_dev(pkg))
    nconv = s.compute(maxit=MAXIT)
    # The JAX package's solver has no num_operations(): its Gram solver's.
    return _counts(s, nconv, s._eigs.num_operations())


def _eigsh(pkg):
    return pkg.eigsh(_tridiag(), k=3, which="LA", maxiter=MAXIT, **_dev(pkg))


def _svds(pkg):
    return pkg.svds(_tridiag(), k=3, maxiter=MAXIT, **_dev(pkg))


def _buckling(pkg):
    """K indefinite (smallest eigenvalue -0.46): its K-norm goes
    imaginary, and the projection non-finite."""
    n = 120
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    K = (Q * np.linspace(-0.46, 5.0, n)) @ Q.T
    R = rng.normal(size=(n, n))
    KG = R @ R.T / n + np.eye(n)
    return pkg.eigsh(0.5 * (K + K.T), k=4, M=0.5 * (KG + KG.T), sigma=2.0,
                     mode="buckling", which="SM", maxiter=MAXIT, **_dev(pkg))


def _cheb_bounds(pkg):
    from importlib import import_module

    cheb = import_module(pkg.__name__ + ".matop.chebyshev")
    op = pkg.SparseSymMatProd.from_full(sps.csr_matrix(_tridiag()), **_dev(pkg))
    lo, hi = cheb.estimate_spectrum_bounds(op)
    return (bool(np.isnan(lo)), bool(np.isnan(hi)))


def _cheb(pkg, bounds=None):
    op = pkg.SparseSymMatProd.from_full(sps.csr_matrix(_tridiag()), **_dev(pkg))
    s = pkg.ChebSymEigsSolver(op, nev=NEV, ncv=NCV, bounds=bounds)
    s.init()
    return _counts(s, s.compute(maxit=MAXIT))


def _lobpcg(pkg, nan_b=False):
    A, B = _tridiag(), np.eye(N)
    if nan_b:  # a finite A and a NaN in B
        A = np.nan_to_num(A)
        B[30, 30] = np.nan
    X0 = np.random.default_rng(0).normal(size=(N, NEV))
    if pkg is stt:
        s = stt.LOBPCGSolver(A, torch.from_numpy(X0), device="cpu")
        B = torch.from_numpy(B)
    else:
        s = st.LOBPCGSolver(A, X0)
    if nan_b:
        s.set_B(B)
    nconv = s.compute(maxit=MAXIT)
    return (s.info().name, int(nconv), s.num_iterations())


def _davidson(pkg):
    op = pkg.SparseSymMatProd.from_full(sps.csr_matrix(_tridiag()), **_dev(pkg))
    s = pkg.DavidsonSymEigsSolver(op, NEV)
    nconv = s.compute(pkg.SortRule.LargestAlge, maxit=MAXIT)
    return (s.info().name, int(nconv), s.num_iterations())


def _refine(pkg):
    """Mixed precision's f64 Rayleigh-Ritz rounds on a NaN operator:
    its thin QR and its eigh."""
    from importlib import import_module

    mixed = import_module(pkg.__name__ + ".solvers.mixed")
    U = np.linalg.qr(np.random.default_rng(1).normal(size=(N, NEV)))[0]
    op = pkg.DenseSymMatProd.create(_tridiag(), **_dev(pkg))
    rule = pkg.SortRule.LargestAlge
    theta = mixed._refine_rounds(
        op, torch.from_numpy(U) if pkg is stt else U, rule, rule
    )[0]
    return np.isnan(np.asarray(theta)).tolist()


def _qr(pkg):
    from importlib import import_module

    orth = import_module(pkg.__name__ + ".linalg.orthogonalization")
    X = np.random.default_rng(2).normal(size=(N, NEV))
    X[3, 1] = np.nan
    Q = orth.qr_orthogonalisation(torch.from_numpy(X) if pkg is stt else X)
    return np.isnan(np.asarray(Q)).tolist()


CASES = {
    "sym_sparse_dia": _sym,
    "sym_dense": lambda p: _sym(p, dense=True),
    "sym_thick": lambda p: _sym(p, restart="thick"),
    "sym_compute_locked": lambda p: _sym(p, locked=True),
    "sym_stepped": lambda p: _sym(p, stepped=True),
    "herm_dense": _herm,
    "partial_svd_dense": lambda p: _partial_svd(p, _tridiag()),
    "partial_svd_wide": lambda p: _partial_svd(p, _tridiag()[:60]),
    "partial_svd_sparse": lambda p: _partial_svd(p, sps.csr_matrix(_tridiag())),
    # finite in f64, its f32 twin overflows
    "mixed_f32_overflow": lambda p: _sym(
        p, A=_tridiag(nan=False, scale=1e38), precision="mixed", tol=1e-6
    ),
    "eigsh_LA": _eigsh,
    "svds": _svds,
    "eigsh_buckling_indefinite": _buckling,
    "chebyshev_bounds": _cheb_bounds,
    "chebyshev_estimated": _cheb,
    "chebyshev_given_bounds": lambda p: _cheb(p, bounds=(0.0, 11.0)),
    "lobpcg": _lobpcg,
    "lobpcg_nan_b": lambda p: _lobpcg(p, nan_b=True),
    "davidson": _davidson,
    "mixed_refine": _refine,
    "qr_orthogonalisation": _qr,
}


def _outcome(fn, pkg):
    """What a case gives: its result, or the class of what it raised and
    whether the message names ``NumericalIssue``."""
    try:
        return fn(pkg)
    except Exception as err:  # noqa: BLE001 - the outcome under test
        return ("raised", type(err).__name__, "NumericalIssue" in str(err))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    ref = _outcome(CASES[case], st)
    got = _outcome(CASES[case], stt)
    assert got == ref
    if case in ("eigsh_LA", "svds", "eigsh_buckling_indefinite"):
        assert got[:2] == ("raised", "NoConvergence")
    if case in ("eigsh_LA", "eigsh_buckling_indefinite"):
        assert got[2]  # the message names NumericalIssue


def test_reference_counts_pinned():
    """The counts the cases above compare, written out: 50 restarts of
    8 re-expansion steps after the 13 operations of the start; the
    stepped driver stops on ``||f||`` before its first restart."""
    got = _outcome(CASES["sym_sparse_dia"], stt)
    assert got == ("NumericalIssue", 0, MAXIT + 1, 13 + MAXIT * (NCV - NEV))
    assert _outcome(CASES["sym_stepped"], stt) == ("NumericalIssue", 0, 1, 13)


def test_gen_eigs_nonfinite_port_alone():
    """``GenEigsSolver`` on the NaN matrix: ``NumericalIssue`` after the
    first factorization. The JAX package raises out of ``np.linalg.eig``
    in a ``pure_callback`` instead, a fault of the reference
    (``ROADMAP.md`` section 3), so the port is held alone."""
    s = stt.GenEigsSolver(stt.DenseGenMatProd.create(_tridiag(), device="cpu"), NEV, NCV)
    s.init()
    nconv = s.compute(stt.SortRule.LargestMagn, maxit=MAXIT)
    assert _counts(s, nconv) == ("NumericalIssue", 0, 1, 13)


@pytest.mark.parametrize("kind", ["sym", "herm", "generalized"])
def test_dense_shift_invert_refuses_nonfinite(kind):
    """The dense Bunch-Kaufman shift-invert refuses the NaN matrix at
    ``set_shift``: a non-finite pivot fails the factorization, as the
    LU's does. (The JAX package reports ``Successful`` with finite
    values that solve nothing, ``ROADMAP.md`` section 3.)"""
    from spectra_tpu_torch.matop.shift_solve import ShiftFactorizationError

    A = _tridiag()
    with pytest.raises(ShiftFactorizationError, match="non-finite"):
        if kind == "sym":
            op = stt.DenseSymShiftSolve.create(A, device="cpu")
            stt.SymEigsShiftSolver(op, nev=NEV, ncv=NCV, sigma=0.5)
        elif kind == "herm":
            stt.DenseHermShiftSolve.create(A.astype(complex), device="cpu").set_shift(0.5)
        else:
            stt.eigsh(A, k=NEV, M=np.eye(N), sigma=0.5, maxiter=MAXIT, device="cpu")


def test_reference_bkldlt_solves_nan_matrix_to_garbage():
    """Why the dense shift-invert holds the port alone: the JAX
    factorization of the NaN matrix is ``ok`` and solves to finite
    values that do not satisfy the finite rows' equations. (At the last
    step the NaN pivot fails the direct tests, the candidate row is row
    0, whose eliminated pivot passes the other test, and the step swaps
    it in: ``perm`` and L are scrambled and the NaN is gone.) The
    port's factors are refused."""
    from spectra_tpu.linalg import bkldlt as jbk

    from spectra_tpu_torch.linalg import bkldlt as tbk

    A = _tridiag()
    x = np.random.default_rng(0).normal(size=N)
    fac = jbk.factorize(A, 0.5)
    y = np.asarray(jbk.solve(fac, x))
    assert bool(fac.ok) and np.isfinite(y).all()
    finite_rows = np.delete(np.nan_to_num(A - 0.5 * np.eye(N)), 50, axis=0)
    assert np.abs(finite_rows @ y - np.delete(x, 50)).max() > 1.0
    assert not tbk.factorize(torch.from_numpy(A), 0.5).ok
    # a finite matrix still factors, and solves as before
    B = _tridiag(nan=False)
    tf = tbk.factorize(torch.from_numpy(B), 0.5)
    assert tf.ok
    y = tbk.solve(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose((B - 0.5 * np.eye(N)) @ y, x, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eigh_helpers_bitwise_on_finite_input(seed):
    """The guard moves no finite result: ``eigh_accurate`` and
    ``tridiag_eigen`` equal ``torch.linalg.eigh`` bitwise, and
    ``eigh_host`` equals ``np.linalg.eigh`` bitwise, on finite
    tridiagonal and full symmetric (and Hermitian) matrices."""
    from spectra_tpu_torch.linalg.jacobi import eigh_accurate
    from spectra_tpu_torch.linalg.ritz_pairs import eigh_host
    from spectra_tpu_torch.linalg.tridiag import tridiag_eigen, tridiag_to_dense

    rng = np.random.default_rng(seed)
    m = 12 + 9 * seed
    d = torch.from_numpy(rng.normal(size=m))
    e = torch.from_numpy(rng.normal(size=m - 1))
    G = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    S = torch.from_numpy(G.real + G.real.T)
    Hm = torch.from_numpy(G + G.conj().T)
    pairs = [
        (tridiag_eigen(d, e), torch.linalg.eigh(tridiag_to_dense(d, e))),
        (eigh_accurate(S), torch.linalg.eigh(S)),
        (eigh_accurate(Hm), torch.linalg.eigh(Hm)),
        (eigh_host(S), np.linalg.eigh(S.numpy())),
        (eigh_host(Hm), np.linalg.eigh(Hm.numpy())),
    ]
    for (w, v), (w0, v0) in pairs:
        assert torch.equal(w, torch.as_tensor(w0))
        assert torch.equal(v, torch.as_tensor(v0))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_eigh_helpers_nan_pairs_on_nonfinite_input(bad):
    """A non-finite entry gives NaN values (real), as ``jnp.linalg.eigh``
    does, and NaN vectors (of the matrix's dtype) from every helper.
    (``jnp.linalg.eigh``'s vectors are NaN for a NaN entry; for an
    infinite one they are the identity. The solvers stop on the
    values.)"""
    import jax.numpy as jnp

    from spectra_tpu_torch.linalg.jacobi import eigh_accurate
    from spectra_tpu_torch.linalg.ritz_pairs import eigh_host
    from spectra_tpu_torch.linalg.tridiag import tridiag_eigen

    d = np.linspace(1.0, 2.0, 8)
    d[3] = bad
    e = np.ones(7)
    S = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    wj, vj = jnp.linalg.eigh(S)
    assert np.isnan(np.asarray(wj)).all()
    assert np.isnan(np.asarray(vj)).all() == np.isnan(bad)
    for M in (S, S.astype(complex)):
        for w, v in (eigh_accurate(M), eigh_host(torch.from_numpy(M))):
            assert w.shape == (8,) and v.shape == (8, 8)
            assert not w.dtype.is_complex and v.dtype == torch.from_numpy(M).dtype
            assert torch.isnan(w).all() and torch.isnan(v).all()
    w, v = tridiag_eigen(torch.from_numpy(d), torch.from_numpy(e))
    assert torch.isnan(w).all() and torch.isnan(v).all()
