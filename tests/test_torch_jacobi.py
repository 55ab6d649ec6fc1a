"""The port's parallel cyclic Jacobi and ``eigh_accurate``
(``spectra_tpu_torch/linalg/jacobi.py``) against the JAX package's: the
7 cases of ``tests/test_jacobi.py``.

Both run on the same seeded matrices. Each case holds the port to the
reference test's own tolerances against LAPACK, and to the JAX
package's eigenvalues within the same tolerance. The schedule is
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectra_tpu.linalg import jacobi as jjac
from spectra_tpu_torch.linalg import jacobi as pjac
from spectra_tpu_torch.linalg.tridiag import accumulate_q, apply_yq


def _both(A):
    """(port w, V), (JAX w, V) as numpy arrays."""
    pw, pV = pjac.jacobi_eigh(torch.from_numpy(A))
    jw, jV = jax.jit(jjac.jacobi_eigh)(jnp.asarray(A))
    return (pw.numpy(), pV.numpy()), (np.asarray(jw), np.asarray(jV))


@pytest.mark.parametrize("m", [1, 2, 5, 8, 40, 41, 64])
def test_random_symmetric(m):
    rng = np.random.default_rng(m)
    A = rng.normal(size=(m, m))
    A = A + A.T
    (w, V), (jw, _) = _both(A)
    assert np.all(np.diff(w) >= 0)  # ascending
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=0, atol=1e-11)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-11)
    assert np.abs(A @ V - V * w[None, :]).max() <= 1e-11
    assert np.abs(V.T @ V - np.eye(m)).max() <= 1e-12


def test_degenerate_clusters():
    d = np.repeat([1.0, 2.0, 2.0 + 1e-9, 5.0], 10)
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    A = Q @ np.diag(d) @ Q.T
    A = 0.5 * (A + A.T)
    (w, V), (jw, _) = _both(A)
    np.testing.assert_allclose(w, np.sort(d), rtol=0, atol=1e-12)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-12)
    assert np.abs(A @ V - V * w[None, :]).max() <= 1e-12
    assert np.abs(V.T @ V - np.eye(40)).max() <= 1e-13


def test_wide_dynamic_range():
    d = np.geomspace(1e-12, 1e6, 30)
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(30, 30)))
    A = Q @ np.diag(d) @ Q.T
    A = 0.5 * (A + A.T)
    (w, _), (jw, _) = _both(A)
    np.testing.assert_allclose(w, np.sort(d), rtol=0, atol=1e-8)
    # Each within 1e-8 (1e-14 of ||A||) of the truth, so within 2e-8 of
    # each other: their rotations round differently at ||A|| = 1e6.
    np.testing.assert_allclose(w, jw, rtol=0, atol=2e-8)


def test_tiny_offdiag_no_overflow():
    A = np.diag([1.0, 11.0, -3.0, 7.0])
    A[0, 1] = A[1, 0] = 1e-20
    A[2, 3] = A[3, 2] = 1e-17
    (w, V), (jw, _) = _both(A)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(V))
    np.testing.assert_allclose(w, np.sort(np.diag(A)), rtol=0, atol=1e-15)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-15)


def test_round_robin_covers_all_pairs():
    for m in [2, 4, 8, 42]:
        sched = pjac._round_robin(m)
        np.testing.assert_array_equal(sched, jjac._round_robin(m))
        assert sched.shape == (m - 1, m // 2, 2)
        seen = set()
        for rnd in sched:
            flat = [int(x) for pair in rnd for x in pair]
            assert len(set(flat)) == m  # disjoint within a round
            seen |= {tuple(p) for p in rnd.tolist()}
        assert len(seen) == m * (m - 1) // 2  # every pair exactly once


def test_eigh_accurate_matches_eigh_off_tpu():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(12, 12))
    A = A + A.T
    w, V = pjac.eigh_accurate(A)
    assert w.device.type == "cpu" and w.dtype == torch.float64
    jw, _ = jjac.eigh_accurate(jnp.asarray(A))
    w, V = w.numpy(), V.numpy()
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=0, atol=1e-12)
    np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=1e-12)
    assert np.abs(A @ V - V * w[None, :]).max() <= 1e-12


def test_equal_diagonal_live_pivot():
    A = np.array([[2.0, 1.0], [1.0, 2.0]])
    (w, V), (jw, _) = _both(A)
    np.testing.assert_allclose(w, [1.0, 3.0], atol=1e-14)
    np.testing.assert_allclose(w, jw, atol=1e-14)
    assert np.abs(A @ V - V * w[None, :]).max() < 1e-14
    B = np.full((6, 6), 0.3)
    np.fill_diagonal(B, 5.0)
    (w2, _), (jw2, _) = _both(B)
    np.testing.assert_allclose(w2, np.linalg.eigvalsh(B), atol=1e-12)
    np.testing.assert_allclose(w2, jw2, atol=1e-12)


def test_accumulate_q_matches_jax():
    """``tridiag.accumulate_q`` (the rotations' product as a dense
    matrix) equals the JAX package's within 1e-15, and ``apply_yq`` on
    the identity."""
    from spectra_tpu.linalg.tridiag import accumulate_q as jacc

    rng = np.random.default_rng(6)
    theta = rng.uniform(0, 2 * np.pi, size=9)
    c, s = np.cos(theta), np.sin(theta)
    Q = accumulate_q(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(Q.numpy(), np.asarray(jacc(jnp.asarray(c), jnp.asarray(s))),
                               rtol=0, atol=1e-15)
    assert np.abs(Q.numpy().T @ Q.numpy() - np.eye(10)).max() < 1e-14
    np.testing.assert_array_equal(
        Q.numpy(), apply_yq(torch.eye(10, dtype=torch.float64),
                            torch.from_numpy(c), torch.from_numpy(s)).numpy())
    assert accumulate_q(torch.from_numpy(c), torch.from_numpy(s), m=12).shape == (12, 12)
