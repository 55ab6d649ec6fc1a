"""The port's Bunch-Kaufman LDL^H and dense shift-solve against the JAX
package, on the CPU.

The cases of ``tests/test_bkldlt.py`` (reference: test/BKLDLT.cpp) and
the dense cases of ``tests/test_shift_solve.py``. The port's host loop
picks the same pivots as the JAX package's ``lax.while_loop``: ``perm``
and ``is2x2`` are equal, and L, d and e agree within 1e-12 relative
(the trailing updates sum in another order). Solves agree within 1e-12
relative, also when the port's ``solve`` runs on the JAX package's
factors (``convert.bk_factors_from_numpy``), which holds the solve apart
from the factorization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectra_tpu as st
from spectra_tpu.linalg import bkldlt as jbk
import spectra_tpu_torch as stt
from spectra_tpu_torch import convert
from spectra_tpu_torch.linalg import bkldlt as tbk

torch.set_num_threads(1)


def _rand_sym(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    return A + A.T


def _rand_herm(n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(n, n)) - 0.5) + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A + A.conj().T


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _both(A, shift):
    """The JAX and the port's factorization of ``A - shift I``, the
    port's pivots checked equal and its factors within 1e-12."""
    fj = jax.jit(jbk.factorize)(jnp.asarray(A), shift)
    ft = tbk.factorize(torch.from_numpy(A), shift)
    assert ft.ok == bool(fj.ok)
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    np.testing.assert_array_equal(ft.is2x2.numpy(), np.asarray(fj.is2x2))
    for name in ("L", "d", "e"):
        want = np.asarray(getattr(fj, name))
        if np.abs(want).max() > 0:
            assert _rel(getattr(ft, name).numpy(), want) < 1e-12, name
    return fj, ft


def _solves_agree(fj, ft, b):
    want = np.asarray(jbk.solve(fj, jnp.asarray(b)))
    got = tbk.solve(ft, torch.from_numpy(b)).numpy()
    assert _rel(got, want) < 1e-12
    on_jax_factors = convert.bk_factors_from_numpy(
        *(np.asarray(x) for x in fj), device="cpu"
    )
    assert _rel(tbk.solve(on_jax_factors, torch.from_numpy(b)).numpy(), want) < 1e-12
    return got


@pytest.mark.parametrize("n", [10, 50, 200])
@pytest.mark.parametrize("shift", [0.0, 1.3])
def test_solve_sym(n, shift):
    A = _rand_sym(n, n)
    b = np.random.default_rng(n + 1).normal(size=n)
    fj, ft = _both(A, shift)
    assert ft.ok
    x = _solves_agree(fj, ft, b)
    resid = np.abs((A - shift * np.eye(n)) @ x - b).max()
    assert resid < 1e-10 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("n", [10, 64])
def test_solve_herm(n, shift=0.7):
    A = _rand_herm(n, n)
    b = np.random.default_rng(n + 2).normal(size=n) + 1j * 0.3
    fj, ft = _both(A, shift)
    assert ft.ok
    assert (ft.d.imag == 0).all()
    x = _solves_agree(fj, ft, b)
    assert np.abs((A - shift * np.eye(n)) @ x - b).max() < 1e-10


def test_factorization_reconstructs():
    """P A P^T == L D L^H, entrywise."""
    n = 40
    A = _rand_sym(n, 3)
    _, fac = _both(A, 0.0)
    L, d, e = fac.L.numpy(), fac.d.numpy(), fac.e.numpy()
    perm = fac.perm.numpy()
    D = np.diag(d)
    for k in np.nonzero(fac.is2x2.numpy())[0]:
        D[k + 1, k] = e[k]
        D[k, k + 1] = np.conj(e[k])
    np.testing.assert_allclose(L @ D @ L.conj().T, A[np.ix_(perm, perm)], atol=1e-12)


def test_forced_2x2_pivots():
    """Zero diagonal forces 2x2 pivots everywhere."""
    n = 6
    A = np.zeros((n, n))
    for i in range(0, n, 2):
        A[i, i + 1] = A[i + 1, i] = 1.0 + i
    fj, ft = _both(A, 0.0)
    assert ft.ok and ft.is2x2.numpy().tolist() == [True, False] * 3
    b = np.arange(1.0, n + 1)
    x = _solves_agree(fj, ft, b)
    np.testing.assert_allclose(A @ x, b, atol=1e-12)


@pytest.mark.parametrize("n", [1, 4])
def test_singular_flags_not_ok(n):
    _, ft = _both(np.zeros((n, n)), 0.0)
    assert not ft.ok


@pytest.mark.parametrize("n", [1, 2, 3])
def test_smallest_sizes(n):
    A = _rand_sym(n, 40 + n)
    fj, ft = _both(A, 0.1)
    x = _solves_agree(fj, ft, np.ones(n))
    np.testing.assert_allclose((A - 0.1 * np.eye(n)) @ x, np.ones(n), atol=1e-12)


def test_block_solve():
    n = 30
    A = _rand_sym(n, 9)
    B = np.random.default_rng(10).normal(size=(n, 4))
    fj, ft = _both(A, 0.25)
    X = _solves_agree(fj, ft, B)
    np.testing.assert_allclose((A - 0.25 * np.eye(n)) @ X, B, atol=1e-10)


def _rand_sym_rs(n, seed=123):
    rng = np.random.RandomState(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    return A + A.T


def test_dense_sym_shift_solve():
    """``tests/test_shift_solve.py::test_dense_sym_shift_solve``."""
    A = _rand_sym_rs(50)
    x = np.random.default_rng(1).normal(size=50)
    want = np.asarray(st.DenseSymShiftSolve.create(A).set_shift(0.7).perform_op(x))
    op = stt.DenseSymShiftSolve.create(A, device="cpu").set_shift(0.7)
    y = op.perform_op(torch.from_numpy(x)).numpy()
    assert _rel(y, want) < 1e-12
    np.testing.assert_allclose((A - 0.7 * np.eye(50)) @ y, x, atol=1e-10)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dense_sym_shift_solve_uplo(uplo):
    """``tests/test_shift_solve.py::test_dense_sym_shift_solve_uplo``:
    only the ``uplo`` triangle is read."""
    A = _rand_sym_rs(30)
    tri = np.tril(A) if uplo == "L" else np.triu(A)
    want = np.asarray(
        st.DenseSymShiftSolve.create(A, uplo=uplo).set_shift(-0.3).perform_op(np.ones(30))
    )
    op = stt.DenseSymShiftSolve.create(tri, uplo=uplo, device="cpu").set_shift(-0.3)
    y = op.perform_op(torch.ones(30, dtype=torch.float64)).numpy()
    assert _rel(y, want) < 1e-12
    np.testing.assert_allclose((A + 0.3 * np.eye(30)) @ y, np.ones(30), atol=1e-10)


def test_dense_sym_shift_solve_at_an_eigenvalue_raises():
    op = stt.DenseSymShiftSolve.create(np.diag([1.0, 2.0, 3.0]), device="cpu")
    with pytest.raises(stt.matop.shift_solve.ShiftFactorizationError):
        op.set_shift(2.0)
