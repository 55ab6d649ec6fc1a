"""The port's Lanczos factorization, restart pieces and tridiagonal
kernels against the JAX package's, on the same inputs.

The factorization runs on the g=30 2-D Laplacian (offsets -30, -1, 0,
1, 30) from the bit-identical SimpleRandom start. Tolerances: H to
1e-12 and V to 1e-10 after 20 Lanczos steps (the reductions sum in
another order); 1e-12 for one restart compression started from the
JAX state itself; 1e-13 for the small tridiagonal sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.linalg import givens as jgiv
from spectra_tpu.linalg import krylov as jkry
from spectra_tpu.linalg import tridiag as jtri
from spectra_tpu.matop.arnoldi_op import ArnoldiOp as JArnoldiOp
from spectra_tpu.solvers import _herm_core as jcore
from spectra_tpu.util.rng import SimpleRandom
from spectra_tpu_torch.convert import krylov_state_from_numpy
from spectra_tpu_torch.linalg import givens as pgiv
from spectra_tpu_torch.linalg import krylov as pkry
from spectra_tpu_torch.linalg import tridiag as ptri
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp as PArnoldiOp
from spectra_tpu_torch.matop.sparse import SparseSymMatProd
from spectra_tpu_torch.solvers import _herm_core as pcore
from spectra_tpu_torch.util import selection as psel

torch.set_num_threads(1)


def _laplacian_2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


@pytest.fixture(scope="module")
def ops():
    A = _laplacian_2d(30)
    v0 = SimpleRandom(0).random_vec(A.shape[0])
    jop = JArnoldiOp.create(st.SparseSymMatProd.from_full(A))
    pop = PArnoldiOp.create(SparseSymMatProd.from_full(A, device="cpu"))
    return jop, pop, v0


@pytest.fixture(scope="module")
def jax_start(ops):
    """One JAX IRLM start at ncv=20, nev=6 (LargestAlge) and the inputs
    of its first restart."""
    jop, _, v0 = ops
    carry = jcore.irlm_start(
        jop, jnp.asarray(v0), jax.random.PRNGKey(0), jnp.asarray(1e-10),
        nev=6, ncv=20, selection=st.SortRule.LargestAlge, mode="lanczos",
    )
    k_new = int(jcore._nev_adjusted(carry.nconv, carry.ritz_est, 6, 20))
    H_new, Q = jcore._shift_sweep(carry.state.H, carry.ritz_val, k_new, 6, 20)
    return carry, k_new, np.array(H_new), np.array(Q)


def _port_state(jstate):
    return krylov_state_from_numpy(
        np.asarray(jstate.V), np.asarray(jstate.H), np.asarray(jstate.f),
        float(jstate.beta), int(jstate.k), int(jstate.nops), device="cpu",
    )


def test_init_and_factorize_match_jax(ops):
    jop, pop, v0 = ops
    js = jkry.init(jop, jnp.asarray(v0), 20, jax.random.PRNGKey(0))
    ps = pkry.init(pop, torch.from_numpy(v0), 20)
    assert ps.k == 1 and ps.nops == int(js.nops) == 2
    np.testing.assert_allclose(ps.H.numpy(), np.asarray(js.H), atol=1e-12)
    js = jkry.factorize_from(jop, js, 1, "lanczos")
    ps = pkry.factorize_from(pop, ps, 1, "lanczos")
    assert ps.k == int(js.k) == 20
    assert ps.nops == int(js.nops)
    np.testing.assert_allclose(ps.H.numpy(), np.asarray(js.H), atol=1e-12)
    np.testing.assert_allclose(ps.V.numpy(), np.asarray(js.V), atol=1e-10)
    np.testing.assert_allclose(ps.f.numpy(), np.asarray(js.f), atol=1e-10)
    assert ps.beta == pytest.approx(float(js.beta), abs=1e-12)
    # The basis is orthonormal and H is tridiagonal.
    G = ps.V @ ps.V.T
    np.testing.assert_allclose(G.numpy(), np.eye(20), atol=1e-13)
    assert torch.count_nonzero(torch.triu(ps.H, 2)) == 0


def test_step_once_matches_jax(ops):
    jop, pop, v0 = ops
    js = jkry.init(jop, jnp.asarray(v0), 8, jax.random.PRNGKey(0))
    ps = pkry.init(pop, torch.from_numpy(v0), 8)
    for i in (1, 2, 3):
        js = jkry.step_once(jop, js, i, "lanczos")
        ps = pkry.step_once(pop, ps, i, "lanczos")
        assert ps.k == int(js.k) == i + 1 and ps.nops == int(js.nops)
    np.testing.assert_allclose(ps.H.numpy(), np.asarray(js.H), atol=1e-12)
    np.testing.assert_allclose(ps.V.numpy(), np.asarray(js.V), atol=1e-12)
    np.testing.assert_allclose(ps.f.numpy(), np.asarray(js.f), atol=1e-12)


def test_shift_sweep_matches_jax(jax_start):
    """The restart keeps the leading k x k block of H_new and the first
    k columns of Q. With exact shifts the coupling H_new[k, k-1] is
    rounding noise, and the trailing block and columns hold the shifts'
    eigenvectors, which rounding decides; those are only checked to be
    negligible where the restart reads them."""
    carry, k, H_new, Q = jax_start
    H_p, Q_p = pcore._shift_sweep(
        torch.from_numpy(np.array(carry.state.H)),
        torch.from_numpy(np.array(carry.ritz_val)), k, 20,
    )
    np.testing.assert_allclose(H_p[:k, :k].numpy(), H_new[:k, :k], atol=1e-13)
    np.testing.assert_allclose(Q_p[:, :k].numpy(), Q[:, :k], atol=1e-13)
    assert abs(float(H_p[k, k - 1])) < 1e-12 and abs(H_new[k, k - 1]) < 1e-12
    # The sweep is an orthogonal similarity: Q^T H Q = H_new.
    H0 = torch.from_numpy(np.array(carry.state.H))
    np.testing.assert_allclose((Q_p.T @ H0 @ Q_p).numpy(), H_p.numpy(), atol=1e-12)


def test_compress_from_jax_state_matches(ops, jax_start):
    jop, pop, _ = ops
    carry, k_new, H_new, Q = jax_start
    want = jkry.compress(jop, carry.state, jnp.asarray(Q), jnp.asarray(H_new), k_new)
    got = pkry.compress(
        pop, _port_state(carry.state), torch.from_numpy(Q),
        torch.from_numpy(H_new), k_new,
    )
    assert got.k == int(want.k) == k_new
    for name in ("V", "H", "f"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            atol=1e-12, err_msg=name,
        )
    assert got.beta == pytest.approx(float(want.beta), abs=1e-12)
    # Zero-tail invariant: rows past k_new are exactly zero.
    assert torch.count_nonzero(got.V[k_new:]) == 0


def test_restart_from_jax_state_matches(ops, jax_start):
    jop, pop, _ = ops
    carry, k_new, _, _ = jax_start
    want = jcore._restart(
        jop, carry.state, carry.ritz_val, k_new, 6, 20, "lanczos"
    )
    got = pcore._restart(
        pop, _port_state(carry.state),
        torch.from_numpy(np.array(carry.ritz_val)), k_new, 20, "lanczos",
    )
    assert got.nops == int(want.nops)
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), atol=1e-11)
    np.testing.assert_allclose(got.V.numpy(), np.asarray(want.V), atol=1e-10)


def test_ritz_bookkeeping_matches_jax(jax_start):
    carry = jax_start[0]
    H = torch.from_numpy(np.array(carry.state.H))
    val, est, vec = pcore._retrieve_ritzpair(H, psel.SortRule.LargestAlge, 6)
    np.testing.assert_allclose(val.numpy(), np.asarray(carry.ritz_val), atol=1e-13)
    np.testing.assert_allclose(
        np.abs(est.numpy()), np.abs(np.asarray(carry.ritz_est)), atol=1e-13
    )
    conv, nconv = pcore._num_converged(
        val, est, float(carry.state.beta), 1e-10, 6, torch.float64
    )
    assert nconv == int(carry.nconv)
    rng = np.random.default_rng(0)
    for nconv in range(7):
        est = rng.normal(size=20) * (rng.random(20) < 0.7)
        want = int(jcore._nev_adjusted(jnp.asarray(nconv), jnp.asarray(est), 6, 20))
        got = pcore._nev_adjusted(nconv, torch.from_numpy(est), 6, 20, torch.float64)
        assert got == want


def _tridiag_case(m, seed, tiny=False):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=m)
    e = rng.normal(size=m - 1)
    if tiny:
        e[[2, 5]] = 1e-18  # below the deflation threshold
    return d, e, float(rng.normal())


@pytest.mark.parametrize("tiny", [False, True])
def test_tridiag_sweep_matches_jax(tiny):
    d, e, mu = _tridiag_case(16, seed=4 + tiny, tiny=tiny)
    cj, sj, ej = jtri.tridiag_qr(jnp.asarray(d), jnp.asarray(e), mu)
    cp, sp, ep = ptri.tridiag_qr(torch.from_numpy(d), torch.from_numpy(e), mu)
    tol = dict(atol=1e-13, rtol=0)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **tol)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **tol)
    np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    dj, e2j = jtri.tridiag_qtq(jnp.asarray(d), ej, cj, sj)
    dp, e2p = ptri.tridiag_qtq(torch.from_numpy(d), ep, cp, sp)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), **tol)
    np.testing.assert_allclose(e2p.numpy(), np.asarray(e2j), **tol)
    Y = np.random.default_rng(9).normal(size=(7, 16))
    np.testing.assert_allclose(
        ptri.apply_yq(torch.from_numpy(Y), cp, sp).numpy(),
        np.asarray(jtri.apply_yq(jnp.asarray(Y), cj, sj)), **tol,
    )
    wj, _ = jtri.tridiag_eigen(jnp.asarray(d), jnp.asarray(e))
    wp, vp = ptri.tridiag_eigen(torch.from_numpy(d), torch.from_numpy(e))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), **tol)
    T = ptri.tridiag_to_dense(torch.from_numpy(d), torch.from_numpy(e))
    np.testing.assert_allclose((T @ vp - vp * wp).numpy(), 0.0, atol=1e-13)


@pytest.mark.parametrize(
    "x, y", [(3.0, 4.0), (-1e-300, 2e-300), (0.0, 0.0), (5.0, 0.0), (0.0, -2.0)]
)
def test_givens_matches_jax(x, y):
    want = [float(v) for v in jgiv.givens_rotation(jnp.asarray(x), jnp.asarray(y))]
    got = pgiv.givens_rotation(x, y)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    c, s, r = got
    assert c * x - s * y == pytest.approx(r, abs=1e-15 * max(r, 1e-300))


def test_other_modes_wait_for_their_slice(ops):
    """The Arnoldi factorization of the general solvers waits for its
    slice; the selective mode and the single full-projection step (the
    thick restart's arrow column) are in."""
    _, pop, v0 = ops
    state = pkry.init(pop, torch.from_numpy(v0), 5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 12"):
        pkry.factorize_from(pop, state, 1, "arnoldi")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 12"):
        pkry.step_once(pop, state, 1, "lanczos_selective")
    state = pkry.factorize_from(pop, state, 1, "lanczos_selective")
    assert state.k == 5


def test_selective_factorize_matches_jax(ops):
    """Simon's omega recurrence from the same init: H, V and the operator
    count as in the JAX package, and fewer DGKS projections than steps."""
    jop, pop, v0 = ops
    js = jkry.init(jop, jnp.asarray(v0), 20, jax.random.PRNGKey(0))
    js = jkry.factorize_from(jop, js, 1, "lanczos_selective")
    ps = pkry.init(pop, torch.from_numpy(v0), 20)
    ps = pkry.factorize_from(pop, ps, 1, "lanczos_selective")
    assert ps.k == int(js.k) == 20 and ps.nops == int(js.nops)
    np.testing.assert_allclose(ps.H.numpy(), np.asarray(js.H), atol=1e-12)
    np.testing.assert_allclose(ps.V.numpy(), np.asarray(js.V), atol=1e-10)
    G = (ps.V @ ps.V.T).numpy()
    assert np.abs(G - np.eye(20)).max() < 1e-7  # semiorthogonal


def test_thick_compress_matches_jax(ops, jax_start):
    """The thick restart's collapse and arrow column from one JAX state:
    the same arrowhead H (up to the signs of the eigenvectors, which the
    two eigensolvers choose freely) and the same restarted subspace."""
    jop, pop, _ = ops
    carry, k_new, _, _ = jax_start
    want = jcore._restart_thick_compress(
        jop, carry.state, k_new, 20, st.SortRule.LargestAlge
    )
    got = pcore._restart_thick_compress(
        pop, _port_state(carry.state), k_new, psel.SortRule.LargestAlge
    )
    assert got.k == int(want.k) == k_new + 1 and got.nops == int(want.nops)
    Hj, Hp = np.asarray(want.H), got.H.numpy()
    np.testing.assert_allclose(np.abs(Hp), np.abs(Hj), atol=1e-11)
    np.testing.assert_allclose(
        np.linalg.eigvalsh(Hp[: k_new + 1, : k_new + 1]),
        np.linalg.eigvalsh(Hj[: k_new + 1, : k_new + 1]), atol=1e-11,
    )
    Vj, Vp = np.asarray(want.V), got.V.numpy()
    np.testing.assert_allclose(Vp.T @ Vp, Vj.T @ Vj, atol=1e-10)
    assert torch.count_nonzero(got.V[k_new + 1:]) == 0
