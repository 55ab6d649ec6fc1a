"""The host eigh on one BLAS thread (``linalg/ritz_pairs.py::eigh_host``,
``util/blas_threads.py``) on the CPU.

Below ``ONE_THREAD_BELOW`` the eigh runs with numpy's OpenBLAS pool held
to one thread, and the pool reads its previous count after the call,
also when the call raises; above it the pool is left as it is. The
pairs equal the unlimited call's (values to 1e-13 relative, vectors up
to sign), on a plain matrix and on a padded, block-diagonal one. A
non-finite matrix gives NaN pairs, and Davidson ends on it with
``NumericalIssue`` under ``LargestAlge`` and ``BothEnds``. Without a
pool the call runs as before.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import spectra_tpu_torch as stt
from spectra_tpu_torch.linalg.ritz_pairs import ONE_THREAD_BELOW, eigh_host
from spectra_tpu_torch.util import blas_threads

#: The pool's count before each call, other than its default, so that a
#: call that restores it is told apart from one that resets it.
BEFORE = 3
ORDERS = [20, 60, 110, ONE_THREAD_BELOW + 88]


def symmetric(m, seed=0):
    A = np.random.default_rng(seed).standard_normal((m, m))
    return torch.from_numpy(0.5 * (A + A.T))


def padded(m, seed=0):
    """A block-diagonal matrix: a symmetric block of half the order, and
    a diagonal whose values sort past the block's."""
    size = m // 2
    P = torch.zeros((m, m), dtype=torch.float64)
    P[:size, :size] = symmetric(size, seed)
    j = torch.arange(m, dtype=torch.float64)
    pad = j >= size
    cap = 2.0 * P.abs().max() + 1.0
    return P + torch.diag(torch.where(pad, cap * (1.0 + j), 0.0))


@pytest.fixture
def pool():
    """numpy's pool, set to ``BEFORE`` threads; its default count after."""
    p = blas_threads.pool()
    if p is None:
        pytest.skip("numpy carries no OpenBLAS whose pool can be held")
    default = p.threads()
    p.set_threads(BEFORE)
    yield p, default
    p.set_threads(default)


@pytest.mark.parametrize("form", ["plain", "padded"])
@pytest.mark.parametrize("order", ORDERS)
def test_eigh_host_holds_the_pool_below_the_threshold(order, form, pool, monkeypatch):
    p, default = pool
    M = symmetric(order) if form == "plain" else padded(order)
    real = np.linalg.eigh
    p.set_threads(default)
    w_ref, s_ref = real(M.numpy())  # the unlimited call
    p.set_threads(BEFORE)

    inside, fail = [], []

    def spy(a):
        inside.append(p.threads())
        if fail:
            raise np.linalg.LinAlgError("raised inside the call")
        return real(a)

    monkeypatch.setattr(np.linalg, "eigh", spy)
    want = 1 if order < ONE_THREAD_BELOW else BEFORE
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w, s = eigh_host(M)
    assert inside == [want] and p.threads() == BEFORE
    opened = [ev.name() for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CPU and ev.name() == "eigh.one_thread"]
    assert len(opened) == (order < ONE_THREAD_BELOW)
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=0, atol=1e-13 * np.abs(w_ref).max())
    signs = np.sign(np.sum(s.numpy() * s_ref, axis=0))
    assert np.all(signs != 0)
    np.testing.assert_allclose(s.numpy() * signs, s_ref, rtol=0, atol=1e-10)
    # A call that raises gives the count back too.
    fail.append(True)
    with pytest.raises(np.linalg.LinAlgError, match="raised inside the call"):
        eigh_host(M)
    assert inside == [want, want] and p.threads() == BEFORE


@pytest.mark.parametrize("order", ORDERS)
def test_a_non_finite_matrix_gives_nan_pairs(order, pool):
    p, _ = pool
    M = symmetric(order)
    M[order // 3, order // 2] = M[order // 2, order // 3] = float("nan")
    w, s = eigh_host(M)
    assert w.shape == (order,) and s.shape == (order, order)
    assert torch.isnan(w).all() and torch.isnan(s).all()
    assert p.threads() == BEFORE


@pytest.mark.parametrize("rule", ["LargestAlge", "BothEnds"])
def test_davidson_on_a_nan_matrix_is_a_numerical_issue(rule, pool):
    p, _ = pool
    n = 200
    d = np.arange(1.0, n + 1)
    d[n // 2] = np.nan
    A = sps.diags([np.full(n - 1, 0.5), d, np.full(n - 1, 0.5)], [-1, 0, 1]).tocsr()
    s = stt.DavidsonSymEigsSolver(stt.SparseSymMatProd.from_full(A, device="cpu"), 3)
    s.compute(getattr(stt.SortRule, rule), maxit=20)
    assert s.info() == stt.CompInfo.NumericalIssue
    assert p.threads() == BEFORE


def test_without_a_pool_the_call_runs_as_before(monkeypatch):
    M = padded(110)
    want = np.linalg.eigh(M.numpy())
    monkeypatch.setattr(blas_threads, "pool", lambda: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w, s = eigh_host(M)
    assert not [ev for ev in prof.profiler.kineto_results.events()
                if ev.name() == "eigh.one_thread"]
    np.testing.assert_array_equal(w.numpy(), want[0])
    np.testing.assert_array_equal(s.numpy(), want[1])
