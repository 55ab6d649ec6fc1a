"""The port's row-sharded multigrid against the JAX package's.

Reference tests: ``tests/test_mg_sharded.py`` (every test has its
counterpart here, named after it). As in ``test_torch_parallel.py``,
the port runs in one gloo world of four CPU processes, spawned once for
this file (this file run as a script is one rank of it), on meshes of
1, 2 and 4 ranks; the JAX package runs on the conftest's 8-device CPU
mesh, its sharded functions under ``jax.jit``.

Tolerances (the reference test's own): transfers within 1e-13 of the
JAX package's sharded and single-device transfers; one V-cycle within
1e-12 of the JAX package's; the solve to a relative residual of 1e-11,
within 1e-9 of the JAX package's solution, cycle counts within 2; the
shift-invert solve equal in ``nconv``, ``info`` and method, eigenvalues
within 1e-9 of the analytic values and of the JAX package's.
"""

import os
import sys
from functools import lru_cache

import numpy as np
import pytest
import scipy.sparse as sps
import torch

WORLD = 4
MESHES = (1, 2, 4)
DIMS = [(32, 24), (16, 13), (16, 6, 10)]
BOUNDARIES = ["clip", "const"]


def lap2d(gy, gx=None):
    gx = gy if gx is None else gx
    ly = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(gy, gy))
    lx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(gx, gx))
    return (sps.kron(sps.eye(gy), lx) + sps.kron(ly, sps.eye(gx))).tocsr()


def transfer_inputs(dims):
    """The reference's restriction and prolongation inputs."""
    from spectra_tpu_torch.linalg.multigrid import coarse_dims

    rng = np.random.default_rng(0)
    r = rng.normal(size=int(np.prod(dims)))
    e = rng.normal(size=int(np.prod(coarse_dims(dims))))
    return r, e


# ---------------------------------------------------------------------------
# The port's side: one rank of the gloo world
# ---------------------------------------------------------------------------


def _local(a, mesh):
    return mesh.local_rows(torch.from_numpy(np.asarray(a))).contiguous()


def _gather(t, mesh):
    from spectra_tpu_torch.distributed import gather_rows

    return gather_rows(t, mesh).numpy()


def case_transfers(mesh):
    from spectra_tpu_torch.linalg.multigrid import coarse_dims
    from spectra_tpu_torch.parallel.mg_sharded import make_prolong0, make_restrict0

    out = {}
    for i, dims in enumerate(DIMS):
        dims_c = coarse_dims(dims)
        r, e = transfer_inputs(dims)
        for b in BOUNDARIES:
            rc = make_restrict0(mesh, "rows", dims, dims_c, b)(_local(r, mesh))
            pf = make_prolong0(mesh, "rows", dims_c, dims, b)(_local(e, mesh))
            out[f"restrict{i}_{b}"] = _gather(rc, mesh)
            out[f"prolong{i}_{b}"] = _gather(pf, mesh)
    return out


def case_solve(mesh):
    from spectra_tpu_torch.parallel.mg_sharded import build_mg_sharded, mg_solve_sharded

    A = lap2d(64, 24)
    smg = build_mg_sharded(A, mesh, max_coarse_n=128)
    b = np.random.default_rng(1).normal(size=A.shape[0])
    xs, ks = mg_solve_sharded(smg, _local(b, mesh), rtol=1e-12)
    return dict(x=_gather(xs, mesh), cycles=ks, s_levels=len(smg.s_ops))


def case_single_cycle(mesh):
    from spectra_tpu_torch.parallel.mg_sharded import build_mg_sharded, v_cycle_sharded

    A = lap2d(32, 32)
    smg = build_mg_sharded(A, mesh, max_coarse_n=64)
    b = _local(np.random.default_rng(2).normal(size=A.shape[0]), mesh)
    return dict(y=_gather(v_cycle_sharded(smg, b, torch.zeros_like(b)), mesh))


def case_auto_mg(mesh):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import sharded_stencil_shift_solve
    from spectra_tpu_torch.util.rng import SimpleRandom

    g = 32
    op = sharded_stencil_shift_solve(lap2d(g), 0.0, mesh)
    e = stt.SymEigsShiftSolver.from_factored(op, 4, 16, 0.0)
    e.init(SimpleRandom(0).random_vec(g * g))
    nconv = e.compute(stt.SortRule.LargestMagn, tol=1e-10)
    return dict(method=op.method, sharded=hasattr(op.mg, "s_ops"), nconv=nconv,
                info=e.info().name, values=e.eigenvalues())


def case_minres_pin(mesh):
    from spectra_tpu_torch.parallel import sharded_stencil_shift_solve

    op = sharded_stencil_shift_solve(lap2d(16), 0.0, mesh, method="minres")
    return dict(method=op.method, mg_none=op.mg is None)


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


def _worker(out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from spectra_tpu_torch import distributed
    from spectra_tpu_torch.parallel import row_mesh

    distributed.initialize(device="cpu")
    for k in MESHES:
        mesh = row_mesh(k)
        if mesh is None:
            continue
        res = {}
        for name, case in CASES.items():
            for key, val in case(mesh).items():
                res[f"{name}.{key}"] = np.asarray(val)
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, f"mesh{k}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX package's side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from test_torch_parallel import spawn_world

    out = tmp_path_factory.mktemp("torch_mg_sharded")
    spawn_world(__file__, out, WORLD)
    results = {}
    for k in MESHES:
        with np.load(out / f"mesh{k}.npz") as f:
            results[k] = {key: f[key] for key in f.files}
    return results


def _sharded(x):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spectra_tpu.parallel import row_mesh

    return jax.device_put(jax.numpy.asarray(x), NamedSharding(row_mesh(8), P("rows")))


@lru_cache(maxsize=None)
def jax_transfer(i, boundary):
    import jax
    import jax.numpy as jnp

    from spectra_tpu.linalg.multigrid import coarse_dims, prolong_nd, restrict_nd
    from spectra_tpu.parallel import row_mesh
    from spectra_tpu.parallel.mg_sharded import make_prolong0, make_restrict0

    dims = DIMS[i]
    dims_c = coarse_dims(dims)
    r, e = transfer_inputs(dims)
    mesh = row_mesh(8)
    return dict(
        restrict=np.asarray(jax.jit(make_restrict0(mesh, "rows", dims, dims_c, boundary))(_sharded(r))),
        prolong=np.asarray(jax.jit(make_prolong0(mesh, "rows", dims_c, dims, boundary))(_sharded(e))),
        restrict_single=np.asarray(restrict_nd(jnp.asarray(r), dims, dims_c, boundary)),
        prolong_single=np.asarray(prolong_nd(jnp.asarray(e), dims_c, dims, boundary)),
    )


@lru_cache(maxsize=None)
def jax_case(name):
    import jax
    import jax.numpy as jnp

    import spectra_tpu as st
    from spectra_tpu.parallel import row_mesh, sharded_stencil_shift_solve
    from spectra_tpu.parallel.mg_sharded import (
        build_mg_sharded,
        mg_solve_sharded,
        v_cycle_sharded,
    )
    from spectra_tpu.util.rng import SimpleRandom

    mesh = row_mesh(8)
    if name == "solve":
        A = lap2d(64, 24)
        smg = build_mg_sharded(A, mesh, max_coarse_n=128)
        b = np.random.default_rng(1).normal(size=A.shape[0])
        xs, ks = jax.jit(lambda bb: mg_solve_sharded(smg, bb, rtol=1e-12))(_sharded(b))
        return dict(x=np.asarray(xs), cycles=int(ks))
    if name == "single_cycle":
        A = lap2d(32, 32)
        smg = build_mg_sharded(A, mesh, max_coarse_n=64)
        b = np.random.default_rng(2).normal(size=A.shape[0])
        ys = jax.jit(lambda bb: v_cycle_sharded(smg, bb, jnp.zeros_like(bb)))(_sharded(b))
        return dict(y=np.asarray(ys))
    if name == "auto_mg":
        g = 32
        op = sharded_stencil_shift_solve(lap2d(g), 0.0, mesh)
        e = st.SymEigsShiftSolver.from_factored(op, 4, 16, 0.0)
        e.init(_sharded(SimpleRandom(0).random_vec(g * g)))
        nconv = e.compute(st.SortRule.LargestMagn, tol=1e-10)
        return dict(method=op.method, nconv=nconv, info=e.info().name,
                    values=np.asarray(e.eigenvalues()))
    raise KeyError(name)


def _get(port, k, case):
    return {key.split(".", 1)[1]: v for key, v in port[k].items()
            if key.split(".", 1)[0] == case}


class TestShardedTransfers:
    @pytest.mark.parametrize("k", MESHES)
    @pytest.mark.parametrize("boundary", BOUNDARIES)
    @pytest.mark.parametrize("i", range(len(DIMS)), ids=[str(d) for d in DIMS])
    def test_match_single_device(self, port, i, boundary, k):
        got = _get(port, k, "transfers")
        ref = jax_transfer(i, boundary)
        for kind in ("restrict", "prolong"):
            y = got[f"{kind}{i}_{boundary}"]
            np.testing.assert_allclose(y, ref[kind], atol=1e-13)
            np.testing.assert_allclose(y, ref[kind + "_single"], atol=1e-13)


class TestShardedVcycle:
    def test_levels_split(self):
        from spectra_tpu.parallel.mg_sharded import shardable_levels as jax_levels
        from spectra_tpu_torch.parallel.mg_sharded import shardable_levels

        dims = [(64, 8), (32, 4), (16, 2), (8, 1)]
        assert shardable_levels(dims, 8) == 3 == jax_levels(dims, 8)
        for k in (1, 2, 4, 16, 64):
            assert shardable_levels(dims, k) == jax_levels(dims, k)

    @pytest.mark.parametrize("k", MESHES)
    def test_solve_matches_unsharded(self, port, k):
        got, ref = _get(port, k, "solve"), jax_case("solve")
        A = lap2d(64, 24)
        b = np.random.default_rng(1).normal(size=A.shape[0])
        assert int(got["s_levels"]) >= 1
        assert np.linalg.norm(A @ got["x"] - b) / np.linalg.norm(b) <= 1e-11
        assert abs(int(got["cycles"]) - ref["cycles"]) <= 2
        np.testing.assert_allclose(got["x"], ref["x"], atol=1e-9)

    @pytest.mark.parametrize("k", MESHES)
    def test_single_cycle_matches_unsharded(self, port, k):
        got, ref = _get(port, k, "single_cycle"), jax_case("single_cycle")
        np.testing.assert_allclose(got["y"], ref["y"], atol=1e-12)


class TestShardedShiftInvert:
    @pytest.mark.parametrize("k", MESHES)
    def test_auto_routes_to_mg_and_solves(self, port, k):
        got, ref = _get(port, k, "auto_mg"), jax_case("auto_mg")
        assert str(got["method"]) == "mg" == ref["method"] and bool(got["sharded"])
        assert int(got["nconv"]) == 4 == ref["nconv"]
        assert str(got["info"]) == "Successful" == ref["info"]
        g = 32
        i = np.arange(1, g + 1)
        mu = 4 * np.sin(np.pi * i / (2 * (g + 1))) ** 2
        lam = np.sort((mu[:, None] + mu[None, :]).ravel())[:4]
        vals = np.sort(got["values"])
        np.testing.assert_allclose(vals, lam, atol=1e-9)
        np.testing.assert_allclose(vals, np.sort(ref["values"]), atol=1e-9)

    @pytest.mark.parametrize("k", MESHES)
    def test_minres_pin_still_works(self, port, k):
        from spectra_tpu.parallel import row_mesh, sharded_stencil_shift_solve

        got = _get(port, k, "minres_pin")
        ref = sharded_stencil_shift_solve(lap2d(16), 0.0, row_mesh(8), method="minres")
        assert str(got["method"]) == "minres" == ref.method
        assert bool(got["mg_none"]) and ref.mg is None


if __name__ == "__main__":
    _worker(sys.argv[1])
