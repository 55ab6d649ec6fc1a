"""The port's geometric multigrid against the JAX package.

Same matrices and right-hand sides through ``spectra_tpu.linalg.multigrid``
and ``spectra_tpu_torch.linalg.multigrid`` on the CPU. Tolerances: grid
inference exact; transfers 1e-14 (as ``tests/test_multigrid.py``);
level operators, ``lam_max`` and the coarse inverse within 1e-12
relative (the port forms the Galerkin products and the power
iteration's matvecs with scipy, the JAX package with its native kernels,
which may sum in another order); ``mg_solve`` solutions within 1e-10
relative and equal cycle counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu.linalg import multigrid as jmg
from spectra_tpu_torch.linalg import multigrid as pmg
from spectra_tpu_torch.sparse.formats import DiaMatrix

torch.set_num_threads(1)


def lap1d(g):
    return sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g)).tocsr()


def lap2d(gy, gx=None):
    gx = gy if gx is None else gx
    return (
        sps.kron(sps.eye(gy), lap1d(gx)) + sps.kron(lap1d(gy), sps.eye(gx))
    ).tocsr()


def lap3d(g):
    e = sps.eye(g)
    return (
        sps.kron(sps.kron(lap1d(g), e), e)
        + sps.kron(sps.kron(e, lap1d(g)), e)
        + sps.kron(sps.kron(e, e), lap1d(g))
    ).tocsr()


def weighted_lap2d(gy, gx, seed=0):
    """Variable-coefficient 5-point graph Laplacian plus a small mass."""
    rng = np.random.default_rng(seed)
    n = gy * gx
    rows, cols, vals = [], [], []
    for iy in range(gy):
        for ix in range(gx):
            i = iy * gx + ix
            for j, ok in ((i + 1, ix + 1 < gx), (i + gx, iy + 1 < gy)):
                if ok:
                    w = rng.uniform(0.5, 2.0)
                    rows.extend([i, j, i, j])
                    cols.extend([j, i, i, j])
                    vals.extend([-w, -w, w, w])
    A = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return (A + 0.1 * sps.eye(n)).tocsr()


def _offsets(A):
    coo = A.tocoo()
    return np.unique(coo.col - coo.row)


NINE_POINT = sorted(dy * 20 + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1))
INFERENCE = {
    "2d": (_offsets(lap2d(40)), 1600, (40, 40)),
    "2d_rect": (_offsets(lap2d(24, 37)), 24 * 37, (24, 37)),
    "3d": (_offsets(lap3d(9)), 729, (9, 9, 9)),
    "1d_band": ([-1, 0, 1], 100, (100,)),
    "9_point": (NINE_POINT, 400, (20, 20)),
    "non_grid": ([-97, -5, 0, 5, 97], 100, None),
}


@pytest.mark.parametrize("case", list(INFERENCE))
def test_grid_inference_matches_jax(case):
    offsets, n, want = INFERENCE[case]
    got = pmg.infer_grid_dims(offsets, n)
    assert got == jmg.infer_grid_dims(offsets, n) == want


@pytest.mark.parametrize("boundary", ["clip", "const"])
@pytest.mark.parametrize("dims", [(9,), (16,), (13, 16), (12, 12), (7, 9, 11)])
def test_transfers_match_jax(dims, boundary):
    rng = np.random.default_rng(3)
    dc = pmg.coarse_dims(dims)
    P = pmg.prolong_matrix(dims, boundary)
    assert (P != jmg.prolong_matrix(dims, boundary)).nnz == 0
    e = rng.normal(size=P.shape[1])
    got = pmg.prolong_nd(torch.from_numpy(e), dc, dims, boundary).numpy()
    want = np.asarray(jmg.prolong_nd(jnp.asarray(e), dc, dims, boundary))
    np.testing.assert_allclose(got, want, atol=1e-14)
    np.testing.assert_allclose(got, P @ e, atol=1e-14)
    r = rng.normal(size=P.shape[0])
    got = pmg.restrict_nd(torch.from_numpy(r), dims, dc, boundary).numpy()
    want = np.asarray(jmg.restrict_nd(jnp.asarray(r), dims, dc, boundary))
    np.testing.assert_allclose(got, want, atol=1e-14)
    np.testing.assert_allclose(got, P.T @ r, atol=1e-14)


HIERARCHIES = {
    "3d_g12": (lambda: lap3d(12), 128),
    "2d_rough": (lambda: weighted_lap2d(16, 16, seed=4), 8),
    "2d_neumann": (lambda: weighted_lap2d(24, 24, seed=9), 128),
}


@pytest.mark.parametrize("case", list(HIERARCHIES))
def test_build_mg_matches_jax(case):
    make, max_coarse_n = HIERARCHIES[case]
    A = make()
    jm = jmg.build_mg(A, max_coarse_n=max_coarse_n)
    pm = pmg.build_mg(A, max_coarse_n=max_coarse_n, device="cpu")
    assert pm.dims_per_level == jm.dims_per_level
    assert pm.boundary == jm.boundary
    assert len(pm.ops) == len(jm.ops)
    for po, jo in zip(pm.ops, jm.ops):
        assert isinstance(po, DiaMatrix)
        assert po.offsets == tuple(jo.offsets)
        want = np.asarray(jo.data)
        np.testing.assert_allclose(
            po.data.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max()
        )
    for pd, jd in zip(pm.inv_diags, jm.inv_diags):
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-12)
    np.testing.assert_allclose(
        pm.lam_max, [float(v) for v in jm.lam_max], rtol=1e-12
    )
    want = np.asarray(jm.coarse_inv)
    np.testing.assert_allclose(
        pm.coarse_inv.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max()
    )


SOLVES = {
    "3d_g24": lambda: lap3d(24),
    "2d_g32": lambda: lap2d(32),
    "2d_rough": lambda: weighted_lap2d(40, 40),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_mg_solve_matches_jax(case):
    A = SOLVES[case]()
    jm = jmg.build_mg(A, max_coarse_n=128)
    pm = pmg.build_mg(A, max_coarse_n=128, device="cpu")
    b = np.random.default_rng(1).normal(size=A.shape[0])
    xj, kj = jmg.mg_solve(jm, jnp.asarray(b), rtol=1e-12)
    cycles, solves = pmg.CYCLES, pmg.SOLVES
    xp, kp = pmg.mg_solve(pm, torch.from_numpy(b), rtol=1e-12)
    assert (pmg.CYCLES, pmg.SOLVES) == (cycles + kp, solves + 1)
    assert kp == int(kj)
    xj = np.asarray(xj)
    assert np.abs(xp.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    relres = np.linalg.norm(A @ xp.numpy() - b) / np.linalg.norm(b)
    assert relres <= 1e-11


def test_mg_solve_with_start_and_cycle_cap():
    A = lap2d(32)
    jm = jmg.build_mg(A)
    pm = pmg.build_mg(A, device="cpu")
    rng = np.random.default_rng(2)
    b, x0 = rng.normal(size=A.shape[0]), rng.normal(size=A.shape[0])
    xj, kj = jmg.mg_solve(jm, jnp.asarray(b), rtol=1e-14, maxiter=3,
                          x0=jnp.asarray(x0))
    xp, kp = pmg.mg_solve(pm, torch.from_numpy(b), rtol=1e-14, maxiter=3,
                          x0=torch.from_numpy(x0))
    assert kp == int(kj) == 3
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())


def test_non_grid_raises():
    R = sps.random(200, 200, density=0.03, random_state=2)
    S = (R + R.T + 10 * sps.eye(200)).tocsr()
    with pytest.raises(pmg.MGBuildError):
        pmg.build_mg(S, device="cpu")
    with pytest.raises(jmg.MGBuildError):
        jmg.build_mg(S)


def test_level0_is_shared_when_given():
    A = lap2d(16)
    from spectra_tpu_torch.sparse.formats import dia_from_scipy

    level0 = dia_from_scipy(A, device="cpu")
    pm = pmg.build_mg(A, device="cpu", level0=level0)
    assert pm.ops[0] is level0
