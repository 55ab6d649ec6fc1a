"""The port's multi-device layer against the JAX package's.

Reference tests: ``tests/test_parallel.py`` (every test has its
counterpart here, named after it). The port runs in ONE gloo world of
four CPU processes, spawned once for this file by the ``port`` fixture
(this file run as a script is one rank of it, started with the
environment ``torchrun`` sets). Each case runs on meshes of 1, 2 and 4
ranks (``row_mesh(k)``, subgroups of that world); the rank-0 process of
each mesh writes the gathered results to an ``.npz``, and the tests
compare them, in the main process, with the JAX package on the
conftest's 8-device CPU mesh (the hi/lo class in interpret mode, as its
own tests run it). The halo plan and the hi/lo planes the port
multiplies in ``test_matvec_and_block_exact`` and
``test_matvec_block_diag_exact`` are the JAX package's, through
``spectra_tpu_torch.convert``.

Tolerances: every product within 1e-13 relative of the JAX package's
(and the reference test's own bound against scipy); solves equal in
``nconv`` and ``info``, eigenvalues within the reference test's atol of
the JAX package's, residuals as the reference test bounds them, and
restart and operation counts equal to the single-device port's on the
random matrices, whose spectra are simple. The plan and the partition
report are compared exactly, at 8 parts on both sides.

The composed solvers on the row mesh (the Chebyshev-filtered IRLM, the
partial SVD and ``svds``, mixed precision, LOBPCG, the general and
Hermitian drivers, the Cholesky and RegularInverse modes with B whole,
the real embedding and the JD host loop) are held to the JAX package's
values on its 8-device mesh at the tolerances each test names. Two
references are not sharded: LOBPCG's (the JAX package's eager steps
over its sharded stencil operator compile for minutes at g=16; the
values are GSPMD's either way) and the JD host loop's (``eigvalsh``).
"""

import os
import socket
import subprocess
import sys
from functools import lru_cache

import numpy as np
import pytest
import scipy.sparse as sps
import torch

WORLD = 4
MESHES = (1, 2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _laplacian_2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _random_sym(seed, density, n=16 * 8):
    """The reference tests' random symmetric matrix, with the
    ``RandomState`` that then draws their right-hand sides."""
    rng = np.random.RandomState(seed)
    A = sps.random(n, n, density=density, random_state=rng, format="csr")
    return (A + A.T).tocsr(), rng


def _mass_2d(g):
    mass1 = sps.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(g, g)) / 6.0
    return (sps.kron(sps.eye(g), mass1) + sps.kron(mass1, sps.eye(g))).tocsr()


def _davidson_matrix(g=16):
    n = g * g
    return (_laplacian_2d(g) + sps.diags(np.arange(n) * 0.05)).tocsr()


def _analytic_2d(g, k):
    i = np.arange(1, g + 1)
    mu = 4 * np.sin(np.pi * i / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None] + mu[None, :]).ravel())[:k]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# The port's side: one rank of the gloo world
# ---------------------------------------------------------------------------


def _v0(n):
    from spectra_tpu_torch.util.rng import SimpleRandom

    return SimpleRandom(0).random_vec(n)


def _gather(t, mesh):
    from spectra_tpu_torch.distributed import gather_rows

    return gather_rows(t, mesh).numpy()


def _local(a, mesh):
    return mesh.local_rows(torch.from_numpy(np.asarray(a))).contiguous()


def _solve(op, mesh, nev, ncv, rule, v0=None, **kw):
    import spectra_tpu_torch as stt

    e = stt.SymEigsSolver(op, nev, ncv)
    e.init(_v0(op.rows()) if v0 is None else v0)
    nconv = e.compute(rule, **kw)
    vecs = e.eigenvectors()
    return dict(
        values=e.eigenvalues(), nconv=nconv, info=e.info().name,
        niter=e.num_iterations(), nops=e.num_operations(),
        vectors=_gather(vecs, mesh) if mesh is not None else vecs.numpy(),
    )


def _with_ref(out, ref):
    out.update({f"ref_{k}": ref[k] for k in ("niter", "nops", "nconv")})
    return out


def case_ell_solve(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_problem

    A, _ = _random_sym(0, 0.1)
    op = stt.SparseSymMatProd.from_full(A, format="ell", device="cpu")
    op_s, v0_s = shard_problem(op, _v0(A.shape[0]), mesh)
    rule = stt.SortRule.LargestMagn
    return _with_ref(_solve(op_s, mesh, 4, 16, rule, v0=v0_s),
                     _solve(op, None, 4, 16, rule))


def case_dia_solve(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import RowShardedMatProd, shard_problem
    from spectra_tpu_torch.sparse.formats import DiaMatrix

    A = _laplacian_2d(16)
    op = stt.SparseSymMatProd.from_full(A, device="cpu")
    op_s, v0_s = shard_problem(op, _v0(A.shape[0]), mesh)
    assert isinstance(op.ell, DiaMatrix) and isinstance(op_s, RowShardedMatProd)
    assert isinstance(op_s.local, DiaMatrix)
    return _solve(op_s, mesh, 4, 16, stt.SortRule.LargestMagn, v0=v0_s)


def case_dense_solve(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_problem

    rng = np.random.default_rng(5)
    A = rng.normal(size=(256, 256))
    A = A + A.T
    op_s, v0_s = shard_problem(
        stt.DenseSymMatProd.create(A, device="cpu"), _v0(256), mesh
    )
    return _solve(op_s, mesh, 4, 16, stt.SortRule.LargestMagn, v0=v0_s)


def case_spmv_formats(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_problem

    g = 24
    A = _laplacian_2d(g)
    x, X = spmv_inputs(g)
    out = {}
    for fmt in ("dia", "ell"):
        op_s, x_s = shard_problem(
            stt.SparseSymMatProd.from_full(A, format=fmt, device="cpu"), x, mesh
        )
        out[fmt] = _gather(op_s.perform_op(x_s), mesh)
        out[fmt + "_block"] = _gather(op_s.perform_op(_local(X, mesh)), mesh)
    return out


def spmv_inputs(g):
    """The reference's x, and a 3-column block after it."""
    rng = np.random.default_rng(1)
    return rng.normal(size=g * g), rng.normal(size=(g * g, 3))


def _stencil(A, mesh):
    from spectra_tpu_torch.parallel import ShardedStencilMatProd
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia

    return ShardedStencilMatProd.create(host_dia(A), mesh)


def case_stencil_matvec(mesh, inp):
    g = 16
    op = _stencil(_laplacian_2d(g), mesh)
    xs = _local(np.random.default_rng(0).normal(size=g * g), mesh)
    y = op.perform_op(xs)
    return dict(y=_gather(y, mesh), y2=_gather(op.perform_op(y), mesh))


def halo_case_inputs():
    """The wide stencil of the reference's HLO test (offsets +-128 over
    8 x 1024 rows), with random data and x."""
    rng = np.random.default_rng(3)
    n, offsets = 8 * 1024, (-128, -1, 0, 1, 128)
    return offsets, rng.normal(size=(len(offsets), n)), rng.normal(size=n)


def case_halo_volume(mesh, inp):
    from spectra_tpu_torch.parallel import ShardedStencilMatProd
    from spectra_tpu_torch.sparse.formats import DiaMatrix

    offsets, data, x = halo_case_inputs()
    n = x.shape[0]
    dia = DiaMatrix(data=torch.from_numpy(data), offsets=offsets, n_rows=n, n_cols=n)
    op = ShardedStencilMatProd.create(dia, mesh)
    xs = _local(x, mesh)
    before = dict(mesh.stats)
    y = op.perform_op(xs)
    moved = torch.tensor([
        mesh.stats["exchange"] - before["exchange"],
        mesh.stats["sent_elements"] - before["sent_elements"],
        mesh.stats["all_gather"] - before["all_gather"],
    ])
    return dict(y=_gather(y, mesh), moved=_gather(moved[None, :], mesh))


def case_stencil_solver(mesh, inp):
    import spectra_tpu_torch as stt

    A = _laplacian_2d(16)
    out = _solve(_stencil(A, mesh), mesh, 4, 16, stt.SortRule.SmallestAlge)
    return _with_ref(out, _solve(stt.SparseSymMatProd.from_full(A, device="cpu"),
                                 None, 4, 16, stt.SortRule.SmallestAlge))


def case_ell_matvec(mesh, inp):
    from spectra_tpu_torch.convert import halo_plan_from_numpy
    from spectra_tpu_torch.parallel import ShardedEllMatProd

    A, rng = _random_sym(0, 0.08)
    x = rng.normal(size=A.shape[0])
    X = rng.normal(size=(A.shape[0], 5))
    op = ShardedEllMatProd.create(A, mesh)
    key = f"ellplan{mesh.size}"
    fields = [inp[f"{key}.{f}"] for f in ("n", "n_parts", "rows_per", "dists",
                                           "halo_sizes")]
    sends = [inp[f"{key}.send_idx{i}"] for i in range(len(fields[3]))]
    plan = halo_plan_from_numpy(*fields, sends, *[
        inp[f"{key}.{f}"] for f in ("cols_local", "vals_local", "b_rows", "b_pos", "b_vals")
    ])
    op_jax_plan = ShardedEllMatProd.from_plan(plan, A.diagonal(), mesh)
    return dict(
        y=_gather(op.perform_op(_local(x, mesh)), mesh),
        Y=_gather(op.perform_op(_local(X, mesh)), mesh),
        diag=_gather(op.diagonal(), mesh),
        y_jax_plan=_gather(op_jax_plan.perform_op(_local(x, mesh)), mesh),
        dists=np.asarray(op.dists),
    )


def case_ell_solver(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import ShardedEllMatProd

    A, _ = _random_sym(3, 0.08)
    out = _solve(ShardedEllMatProd.create(A, mesh), mesh, 4, 16, stt.SortRule.LargestMagn)
    return _with_ref(out, _solve(
        stt.SparseSymMatProd.from_full(A, format="ell", device="cpu"), None, 4, 16,
        stt.SortRule.LargestMagn,
    ))


def block_diag_matrix():
    rng = np.random.RandomState(1)
    blocks = [sps.random(16, 16, density=0.3, random_state=rng) for _ in range(8)]
    A = sps.block_diag(blocks).tocsr()
    return A, rng.normal(size=A.shape[0])


def case_block_diag(mesh, inp):
    from spectra_tpu_torch.parallel import ShardedEllMatProd

    A, x = block_diag_matrix()
    op = ShardedEllMatProd.create(A, mesh)
    before = mesh.stats["exchange"]
    y = op.perform_op(_local(x, mesh))
    return dict(y=_gather(y, mesh), n_dists=len(op.dists),
                exchanges=mesh.stats["exchange"] - before)


def _shift_solve_run(mesh, g, nev, ncv, **kw):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import sharded_stencil_shift_solve

    op = sharded_stencil_shift_solve(_laplacian_2d(g), 0.0, mesh, **kw)
    e = stt.SymEigsShiftSolver.from_factored(op, nev, ncv, 0.0)
    e.init(_local(_v0(g * g), mesh))
    return op, e


def case_shift_invert(mesh, inp):
    import spectra_tpu_torch as stt

    op, e = _shift_solve_run(mesh, 16, 4, 16)
    nconv = e.compute(stt.SortRule.LargestMagn, tol=1e-10)
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name,
                method=op.method, niter=e.num_iterations(), nops=e.num_operations())


def case_stencil_block(mesh, inp):
    g = 16
    X = np.random.default_rng(0).normal(size=(g * g, 4))
    return dict(Y=_gather(_stencil(_laplacian_2d(g), mesh).perform_op(_local(X, mesh)), mesh))


def case_generalized(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import sharded_stencil_shift_solve

    g = 16
    A, B = _laplacian_2d(g), _mass_2d(g)
    solve = sharded_stencil_shift_solve(A, 0.0, mesh, b_csr=B)
    e = stt.SymGEigsShiftSolver.from_factored(solve, _stencil(B, mesh), 3, 14, 0.0)
    e.init(_v0(g * g))
    nconv = e.compute(stt.SortRule.LargestMagn, tol=1e-10)
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name,
                method=solve.method)


def case_davidson(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import ShardedEllMatProd

    A = _davidson_matrix()
    dav = stt.DavidsonSymEigsSolver(ShardedEllMatProd.create(A, mesh), 3, 12)
    nconv = dav.compute(stt.SortRule.LargestAlge, maxit=100, tol=1e-9)
    ref = stt.DavidsonSymEigsSolver(
        stt.SparseSymMatProd.from_full(A, format="ell", device="cpu"), 3, 12
    )
    ref.compute(stt.SortRule.LargestAlge, maxit=100, tol=1e-9)
    return dict(values=dav.eigenvalues(), nconv=nconv, info=dav.info().name,
                niter=dav.num_iterations(), nops=dav.num_operations(),
                vectors=_gather(dav.eigenvectors(), mesh),
                ref_niter=ref.num_iterations(), ref_nops=ref.num_operations())


def case_locked(mesh, inp):
    import spectra_tpu_torch as stt

    _, e = _shift_solve_run(mesh, 16, 2, 8)
    nconv = e.compute_locked(
        stt.SortRule.LargestMagn, maxit=60, tol=1e-9,
        sorting=stt.SortRule.SmallestAlge, want=stt.SortRule.SmallestAlge,
        max_rounds=2,
    )
    return dict(values=e.eigenvalues(), nconv=nconv, rounds=len(e.locking_rounds()),
                certified=e.certified())


def case_hilo_matvec(mesh, inp):
    from spectra_tpu_torch.convert import hilo_shards_from_numpy
    from spectra_tpu_torch.parallel import ShardedStencilHiLoMatProd
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia

    g = 16
    dia = host_dia(_laplacian_2d(g))
    op = ShardedStencilHiLoMatProd.create(dia, mesh, chunk=32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=g * g)
    X = rng.normal(size=(g * g, 3))
    y = op.perform_op(_local(x, mesh))
    hi, lo = hilo_shards_from_numpy(inp["hilo.data_hi"], inp["hilo.data_lo"],
                                    int(inp["hilo.n_dev"]), int(inp["hilo.rows_per"]))
    op_jax = ShardedStencilHiLoMatProd.from_planes(hi, lo, dia.offsets, g * g, mesh)
    return dict(
        y=_gather(y, mesh), y2=_gather(op.perform_op(y), mesh),
        Y=_gather(op.perform_op(_local(X, mesh)), mesh),
        diag=_gather(op.diagonal(), mesh),
        y_jax_planes=_gather(op_jax.perform_op(_local(x, mesh)), mesh),
    )


def case_hilo_solver(mesh, inp):
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import ShardedStencilHiLoMatProd
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia

    op = ShardedStencilHiLoMatProd.create(host_dia(_laplacian_2d(16)), mesh, chunk=32)
    e = stt.SymEigsSolver(op, 4, 12)
    e.init(_local(_v0(256), mesh))
    nconv = e.compute()
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name)


def case_routing(mesh, inp):
    from spectra_tpu_torch.parallel import sharded_stencil_op
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia

    dia = host_dia(_laplacian_2d(16))
    return dict(auto=type(sharded_stencil_op(dia, mesh, hilo="auto")).__name__,
                forced=type(sharded_stencil_op(dia, mesh, hilo=True)).__name__)


def case_create_raises(mesh, inp):
    """``create`` refuses, as the JAX one does, rows that do not divide
    over the mesh and a halo wider than a shard."""
    from spectra_tpu_torch.parallel import ShardedStencilHiLoMatProd, ShardedStencilMatProd
    from spectra_tpu_torch.sparse.formats import DiaMatrix

    out = {}
    for name, n, offsets in (("uneven", 4 * 9 + 1, (-1, 0, 1)), ("wide", 32, (-9, 0, 9))):
        dia = DiaMatrix(data=torch.ones((3, n), dtype=torch.float64), offsets=offsets,
                        n_rows=n, n_cols=n)
        for cls in (ShardedStencilMatProd, ShardedStencilHiLoMatProd):
            try:
                cls.create(dia, mesh)
                out[f"{name}_{cls.__name__}"] = "built"
            except ValueError as err:
                out[f"{name}_{cls.__name__}"] = str(err)
    return out


def case_global_put(mesh, inp):
    """Each rank reads only its rows of a memmap (a vector and a
    matrix) and of a DIA array's columns; gathered back, the arrays."""
    from spectra_tpu_torch.distributed import global_put
    from spectra_tpu_torch.parallel.mesh import Placement

    arr = np.load(str(inp["memmap_path"]), mmap_mode="r")
    return dict(
        vector=_gather(global_put(arr[:, 0], mesh), mesh),
        matrix=_gather(global_put(arr, mesh), mesh),
        columns=_gather(global_put(arr.T, Placement(mesh, 1)).T.contiguous(), mesh),
    )


def cheb_settings():
    """``tests/test_chebyshev.py::test_chebyshev_over_sharded_halo_op``."""
    return dict(nev=6, ncv=24, which="largest", degree=40, cut_fraction=0.02)


def _cheb_run(op, mesh, v0):
    import spectra_tpu_torch as stt

    e = stt.ChebSymEigsSolver(op, **cheb_settings())
    e.init(v0)
    nconv = e.compute()
    vecs = e.eigenvectors()
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name,
                niter=e.num_iterations(), nops=e.num_operations(),
                vectors=_gather(vecs, mesh) if mesh is not None else vecs.numpy())


def case_chebyshev(mesh, inp):
    """The Chebyshev-filtered IRLM over the halo-exchange stencil
    operator, from the whole start vector (each rank keeps its rows)."""
    import spectra_tpu_torch as stt

    A = _laplacian_2d(40)
    before = mesh.stats["all_reduce"]
    out = _cheb_run(_stencil(A, mesh), mesh, _v0(A.shape[0]))
    out["all_reduces"] = mesh.stats["all_reduce"] - before
    return _with_ref(out, _cheb_run(stt.SparseSymMatProd.from_full(A, device="cpu"), None,
                                    _v0(A.shape[0])))


def svd_matrices():
    """A tall sparse (ELL) and a wide dense random matrix."""
    tall = sps.random(128, 64, density=0.1, random_state=np.random.RandomState(0),
                      format="csr")
    return dict(tall=tall, wide=np.random.default_rng(1).normal(size=(64, 128)))


def _svd_operator(name, M):
    import spectra_tpu_torch as stt

    if name == "tall":
        return stt.SparseGenMatProd.create(M, device="cpu")
    return stt.DenseGenMatProd.create(M, device="cpu")


def case_partial_svd(mesh, inp):
    """``PartialSVDSolver`` and ``svds`` over ``shard_operator`` of a tall
    and a wide matrix: singular values, the gathered factors, counts."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_operator

    out = {}
    for name, M in svd_matrices().items():
        op = shard_operator(_svd_operator(name, M), mesh)
        p = stt.PartialSVDSolver(op, 3, 12)
        out[f"{name}_nconv"] = p.compute()
        out[f"{name}_s"] = p.singular_values()
        out[f"{name}_U"] = _gather(p.matrix_U(3), mesh)
        out[f"{name}_V"] = _gather(p.matrix_V(3), mesh)
        out[f"{name}_counts"] = [p.num_iterations(), p.num_operations()]
        ref = stt.PartialSVDSolver(_svd_operator(name, M), 3, 12)
        ref.compute()
        out[f"{name}_ref_counts"] = [ref.num_iterations(), ref.num_operations()]
        u, s, vh = stt.svds(op, k=3, ncv=12)
        out[f"{name}_svds_s"] = s
        out[f"{name}_svds_u"] = _gather(torch.from_numpy(np.ascontiguousarray(u)), mesh)
        out[f"{name}_svds_v"] = _gather(
            torch.from_numpy(np.ascontiguousarray(vh.conj().T)), mesh)
    return out


def _mixed_run(op, mesh, v0):
    import spectra_tpu_torch as stt

    e = stt.SymEigsSolver(op, 4, 16)
    e.set_precision("mixed")
    e.init(v0)
    nconv = e.compute(stt.SortRule.LargestAlge, tol=1e-6)
    vecs = e.eigenvectors()
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name,
                resid=e.mixed_report()["resid_f64"],
                vectors=_gather(vecs, mesh) if mesh is not None else vecs.numpy())


def case_mixed(mesh, inp):
    """Mixed precision over ``shard_problem`` of the g=16 Laplacian in
    each local storage (the f32 twin of its rows), and the refusal of a
    halo-exchange stencil operator."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_problem

    A = _laplacian_2d(16)
    out = {}
    for fmt in ("dia", "ell", "dia_hilo"):
        op_s, v0_s = shard_problem(
            stt.SparseSymMatProd.from_full(A, format=fmt, device="cpu"), _v0(256), mesh)
        out.update({f"{fmt}_{k}": v for k, v in _mixed_run(op_s, mesh, v0_s).items()})
        out[f"{fmt}_twin"] = type(op_s.local).__name__
    try:
        _mixed_run(_stencil(A, mesh), mesh, _v0(256))
        out["stencil_error"] = "ran"
    except ValueError as err:
        out["stencil_error"] = str(err)
    return out


def lobpcg_inputs(g=16):
    """The Laplacian's start block (4 columns), and the constraint case
    of ``tests/test_contrib.py::test_lobpcg_constraints_deflation`` at
    this g: the two smallest eigenvectors and a 2-column start."""
    n = g * g
    _, V = np.linalg.eigh(_laplacian_2d(g).toarray())
    return (np.random.default_rng(0).normal(size=(n, 4)), V[:, :2],
            np.random.default_rng(3).normal(size=(n, 2)))


def _lobpcg_run(op, mesh, X0, Y=None, maxit=200, tol_div_n=1e-10):
    import spectra_tpu_torch as stt

    lo = stt.LOBPCGSolver(op, X0)
    if Y is not None:
        lo.set_constraints(Y)
    nconv = lo.compute(maxit=maxit, tol_div_n=tol_div_n)
    vecs = lo.eigenvectors()
    return dict(values=lo.eigenvalues(), nconv=nconv, info=lo.info().name,
                niter=lo.num_iterations(), resid=lo.residuals(),
                vectors=_gather(vecs, mesh) if mesh is not None else vecs.numpy())


def case_lobpcg(mesh, inp):
    """LOBPCG over ``ShardedStencilMatProd`` from the whole start block,
    and with the whole constraint block, at the reference test's
    tolerance; and on the Davidson matrix at ``tol_div_n=1e-8``, with
    the single-device port's iterations beside it."""
    import spectra_tpu_torch as stt

    A = _laplacian_2d(16)
    X0, Y, X2 = lobpcg_inputs()
    out = _lobpcg_run(_stencil(A, mesh), mesh, X0)
    con = _lobpcg_run(_stencil(A, mesh), mesh, X2, Y, maxit=300)
    out.update({f"con_{k}": v for k, v in con.items()})
    D = _davidson_matrix()
    dav = _lobpcg_run(_stencil(D, mesh), mesh, X0, tol_div_n=1e-8)
    out.update({f"dav_{k}": v for k, v in dav.items()})
    out["dav_ref_niter"] = _lobpcg_run(
        stt.SparseSymMatProd.from_full(D, device="cpu"), None, X0, tol_div_n=1e-8)["niter"]
    return out


def gen_matrix():
    """A random non-symmetric sparse matrix (ELL), n = 128."""
    return sps.random(128, 128, density=0.1, random_state=np.random.RandomState(0),
                      format="csr")


def herm_matrix():
    """A random sparse complex Hermitian matrix, n = 128."""
    rng = np.random.RandomState(0)
    A = (sps.random(128, 128, density=0.1, random_state=rng)
         + 1j * sps.random(128, 128, density=0.1, random_state=rng))
    return (A + A.conj().T).tocsr()


def _general_run(cls, op, mesh, rule):
    import spectra_tpu_torch as stt

    e = getattr(stt, cls)(op, 4, 16)
    e.init()
    nconv = e.compute(getattr(stt.SortRule, rule))
    vecs = e.eigenvectors()
    return dict(values=e.eigenvalues(), nconv=nconv, info=e.info().name,
                niter=e.num_iterations(), nops=e.num_operations(),
                vectors=_gather(vecs, mesh) if mesh is not None else vecs.numpy())


def case_general(mesh, inp):
    """``GenEigsSolver`` over ``shard_problem(SparseGenMatProd)`` and
    ``HermEigsSolver`` over ``shard_operator(SparseHermMatProd)``."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_operator, shard_problem

    out = {}
    gen = stt.SparseGenMatProd.create(gen_matrix(), device="cpu")
    op_s, _ = shard_problem(gen, _v0(128), mesh)
    res = _with_ref(_general_run("GenEigsSolver", op_s, mesh, "LargestMagn"),
                    _general_run("GenEigsSolver", gen, None, "LargestMagn"))
    out.update({f"gen_{k}": v for k, v in res.items()})
    herm = stt.SparseHermMatProd.create(herm_matrix(), device="cpu")
    res = _with_ref(
        _general_run("HermEigsSolver", shard_operator(herm, mesh), mesh, "LargestAlge"),
        _general_run("HermEigsSolver", herm, None, "LargestAlge"))
    out.update({f"herm_{k}": v for k, v in res.items()})
    return out


def geigs_pair():
    """The 8 x 9 grid's Laplacian and FEM mass matrix (a simple spectrum:
    the reference tests' square grid has double eigenvalues)."""
    lx = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(8, 8))
    ly = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(9, 9))
    mx = sps.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(8, 8)) / 6.0
    my = sps.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(9, 9)) / 6.0
    A = (sps.kron(sps.eye(9), lx) + sps.kron(ly, sps.eye(8))).tocsr()
    B = (sps.kron(sps.eye(9), mx) + sps.kron(my, sps.eye(8))).tocsr()
    return A, B


def embed_matrix():
    """A random sparse complex matrix, n = 64 (its real embedding 128)."""
    rng = np.random.RandomState(0)
    M = sps.random(64, 64, density=0.1, random_state=rng)
    return (M + 1j * sps.random(64, 64, density=0.1, random_state=rng)).tocsr()


def case_whole_b(mesh, inp):
    """The operators that hold a whole factor or matrix over a row-sharded
    A: ``SymGEigsSolver`` in the Cholesky and RegularInverse modes over
    ``shard_problem(SparseSymMatProd)``, and ``GenEigsSolver`` on the real
    embedding of a complex matrix with its inner operator sharded
    (LargestMagn, and LargestImag through the rotated embedding)."""
    import dataclasses

    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import shard_operator, shard_problem

    A, B = geigs_pair()
    n = A.shape[0]
    out = {}
    for mode, bop in (("Cholesky", stt.SparseCholesky.create(B, device="cpu")),
                      ("RegularInverse", stt.SparseRegularInverse.create(B, device="cpu"))):
        op_s, v0_s = shard_problem(stt.SparseSymMatProd.from_full(A, device="cpu"), _v0(n),
                                   mesh)
        for label, op, v0 in (("", op_s, v0_s), ("ref_", None, None)):
            op = op or stt.SparseSymMatProd.from_full(A, device="cpu")
            e = stt.SymGEigsSolver(op, bop, 3, 12, mode=getattr(stt.GEigsMode, mode))
            e.init(_v0(n) if v0 is None else v0)
            nconv = e.compute(stt.SortRule.LargestAlge)
            vecs = e.eigenvectors()
            out.update({f"{mode}_{label}nconv": nconv, f"{mode}_{label}values": e.eigenvalues(),
                        f"{mode}_{label}counts": [e.num_iterations(), e.num_operations()]})
            if not label:
                out[f"{mode}_vectors"] = _gather(vecs, mesh)
    emb = stt.RealEmbeddedGenMatProd.create(embed_matrix(), device="cpu")
    sharded = dataclasses.replace(emb, inner=shard_operator(emb.inner, mesh))
    for rule in ("LargestMagn", "LargestImag"):
        for label, op in (("", sharded), ("ref_", emb)):
            e = stt.GenEigsSolver(op, 3, 12)
            e.init()
            nconv = e.compute(getattr(stt.SortRule, rule))
            out.update({f"embed_{rule}_{label}nconv": nconv,
                        f"embed_{rule}_{label}values": e.eigenvalues(),
                        f"embed_{rule}_{label}counts": [e.num_iterations(),
                                                         e.num_operations()]})
            if not label:
                out[f"embed_{rule}_vectors"] = _gather(e.eigenvectors(), mesh)
    return out


def case_davidson_host(mesh, inp):
    """The JD host loop (``SearchSpace``) over ``ShardedEllMatProd``:
    BothEnds (always the host loop) and LargestAlge with
    ``SPECTRA_TPU_JD_DRIVER=host``, each beside the single-device port."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import ShardedEllMatProd

    A = _davidson_matrix()
    out = {}
    saved = os.environ.get("SPECTRA_TPU_JD_DRIVER")
    try:
        for rule, route in (("BothEnds", None), ("LargestAlge", "host")):
            if route is not None:
                os.environ["SPECTRA_TPU_JD_DRIVER"] = route
            for label, op in (("", ShardedEllMatProd.create(A, mesh)),
                              ("ref_", stt.SparseSymMatProd.from_full(A, format="ell",
                                                                      device="cpu"))):
                dav = stt.DavidsonSymEigsSolver(op, 4, 12)
                nconv = dav.compute(getattr(stt.SortRule, rule), maxit=100, tol=1e-9)
                out.update({f"{rule}_{label}nconv": nconv,
                            f"{rule}_{label}values": dav.eigenvalues(),
                            f"{rule}_{label}counts": [dav.num_iterations(),
                                                       dav.num_operations()]})
                if not label:
                    out[f"{rule}_vectors"] = _gather(dav.eigenvectors(), mesh)
    finally:
        if saved is None:
            os.environ.pop("SPECTRA_TPU_JD_DRIVER", None)
        else:
            os.environ["SPECTRA_TPU_JD_DRIVER"] = saved
    return out


def nonfinite_laplacian():
    """The g=16 Laplacian with a NaN on its diagonal at row 200: in the
    last rank's rows on 2 and 4 ranks."""
    A = _laplacian_2d(16).tolil()
    A[200, 200] = np.nan
    return A.tocsr()


def case_nonfinite(mesh, inp):
    """``SymEigsSolver`` over ``ShardedStencilMatProd`` of a matrix with a
    NaN in one rank's rows, single-shot and stepped: each rank's
    (info, nconv, restarts, operations), gathered as one row a rank, and
    the one-rank run's beside them."""
    import spectra_tpu_torch as stt

    A = nonfinite_laplacian()
    out = {}
    for stepped in (False, True):
        key = "stepped" if stepped else "single"
        rows = []
        for op in (_stencil(A, mesh), stt.SparseSymMatProd.from_full(A, device="cpu")):
            e = stt.SymEigsSolver(op, 4, 16)
            e.set_matvec_granularity(stepped)
            e.init(_v0(256))
            nconv = e.compute(stt.SortRule.SmallestAlge, maxit=20)
            rows.append([e.info().value, nconv, e.num_iterations(), e.num_operations()])
        out[key] = _gather(torch.tensor(rows[:1]), mesh)
        out[key + "_ref"] = np.asarray(rows[1])
    return out


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


def _worker(out_dir):
    """One rank of the world: every case on every mesh; the rank-0
    process of each mesh saves its gathered results."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from spectra_tpu_torch import distributed
    from spectra_tpu_torch.parallel import row_mesh

    distributed.initialize(device="cpu")
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inp = dict(f)
    for k in MESHES:
        mesh = row_mesh(k)
        if mesh is None:
            continue
        res = {}
        for name, case in CASES.items():
            for key, val in case(mesh, inp).items():
                res[f"{name}.{key}"] = np.asarray(val)
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, f"mesh{k}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The launcher and the JAX package's side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(script, out_dir, world, timeout=900):
    """Run ``script out_dir`` as ``world`` ranks of a gloo world on this
    host, with the environment ``torchrun`` sets; fails the test with
    the ranks' output when one fails."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(out_dir)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the port's ranks timed out\n" + "\n".join(o[-4000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {r} of the port's world failed:\n{out[-6000:]}")


def _jax_inputs():
    """The JAX package's halo plans (at 1, 2 and 4 parts) of the matrix
    of ``test_matvec_and_block_exact`` and its hi/lo planes of the g=16
    Laplacian on the 8-device mesh, for the port to multiply."""
    from spectra_tpu.parallel import ShardedStencilHiLoMatProd, plan_halo_partition, row_mesh
    from spectra_tpu.sparse import dia_from_scipy

    inp = {}
    A, _ = _random_sym(0, 0.08)
    for k in MESHES:
        plan = plan_halo_partition(A, k)
        for f in ("n", "n_parts", "rows_per", "dists", "halo_sizes", "cols_local",
                  "vals_local", "b_rows", "b_pos", "b_vals"):
            inp[f"ellplan{k}.{f}"] = np.asarray(getattr(plan, f))
        for i, s in enumerate(plan.send_idx):
            inp[f"ellplan{k}.send_idx{i}"] = np.asarray(s)
    op = ShardedStencilHiLoMatProd.create(
        dia_from_scipy(_laplacian_2d(16)), row_mesh(8), chunk=32
    )
    inp["hilo.data_hi"] = np.asarray(op.data_hi)
    inp["hilo.data_lo"] = np.asarray(op.data_lo)
    inp["hilo.n_dev"] = np.asarray(8)
    inp["hilo.rows_per"] = np.asarray(op.rows_per)
    return inp


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results: ``port[k]["case.key"]`` on a mesh of k ranks."""
    out = tmp_path_factory.mktemp("torch_parallel")
    np.save(out / "memmap.npy", memmap_array())
    np.savez(out / "inputs.npz", memmap_path=str(out / "memmap.npy"), **_jax_inputs())
    spawn_world(__file__, out, WORLD)
    results = {}
    for k in MESHES:
        with np.load(out / f"mesh{k}.npz") as f:
            results[k] = {key: f[key] for key in f.files}
    return results


def memmap_array():
    return np.arange(64 * 3, dtype=np.float64).reshape(64, 3) / 7.0


@pytest.mark.parametrize("k", MESHES)
def test_create_raises_on_bad_partitions(port, k):
    """37 rows split over 2 or 4 ranks, and offsets of 9 over shards of
    32 / k < 9 rows, raise in both stencil classes; one rank takes
    both."""
    got = _get(port, k, "create_raises")
    for cls in ("ShardedStencilMatProd", "ShardedStencilHiLoMatProd"):
        uneven, wide = str(got[f"uneven_{cls}"]), str(got[f"wide_{cls}"])
        assert (uneven == "built") == (k == 1)
        assert k == 1 or "divide evenly" in uneven
        assert (wide == "built") == (32 // k >= 9)
        assert 32 // k >= 9 or "halo exceeds shard size" in wide


@pytest.mark.parametrize("k", MESHES)
def test_global_put_takes_rank_rows(port, k):
    """``distributed.global_put`` of a memmap: each rank's rows (or, for
    a column placement, its columns) reassemble the array."""
    got, want = _get(port, k, "global_put"), memmap_array()
    np.testing.assert_array_equal(got["vector"], want[:, 0])
    np.testing.assert_array_equal(got["matrix"], want)
    np.testing.assert_array_equal(got["columns"], want)


def _mesh8():
    from spectra_tpu.parallel import row_mesh

    return row_mesh(8)


def _put(x, spec):
    import jax
    from jax.sharding import NamedSharding

    return jax.device_put(jax.numpy.asarray(x), NamedSharding(_mesh8(), spec))


def _rows(x):
    from jax.sharding import PartitionSpec as P

    return _put(x, P("rows") if np.ndim(x) == 1 else P("rows", None))


def _jax_solve(op, nev, ncv, rule, v0, **kw):
    import spectra_tpu as st

    e = st.SymEigsSolver(op, nev=nev, ncv=ncv)
    e.init(v0)
    nconv = e.compute(getattr(st.SortRule, rule), **kw)
    return dict(values=np.asarray(e.eigenvalues()), nconv=nconv, info=e.info().name,
                vectors=np.asarray(e.eigenvectors()))


@lru_cache(maxsize=None)
def jax_case(name):
    """The JAX package's result of the reference test behind ``name``."""
    import jax
    import spectra_tpu as st
    from spectra_tpu.parallel import (
        ShardedEllMatProd,
        ShardedStencilHiLoMatProd,
        ShardedStencilMatProd,
        shard_problem,
        sharded_stencil_shift_solve,
    )
    from spectra_tpu.sparse import dia_from_scipy
    from spectra_tpu.util.rng import SimpleRandom

    mesh = _mesh8()
    v0 = lambda n: SimpleRandom(0).random_vec(n)  # noqa: E731
    if name in ("ell_solve", "dia_solve", "dense_solve"):
        if name == "dense_solve":
            rng = np.random.default_rng(5)
            A = rng.normal(size=(256, 256))
            op = st.DenseSymMatProd.create(A + A.T)
        else:
            A = _random_sym(0, 0.1)[0] if name == "ell_solve" else _laplacian_2d(16)
            fmt = "ell" if name == "ell_solve" else "auto"
            op = st.SparseSymMatProd.from_full(A, format=fmt)
        op_s, v0_s = shard_problem(op, v0(op.rows()), mesh)
        return _jax_solve(op_s, 4, 16, "LargestMagn", v0_s)
    if name == "spmv_formats":
        A = _laplacian_2d(24)
        x, X = spmv_inputs(24)
        out = {}
        for fmt in ("dia", "ell"):
            op_s, x_s = shard_problem(st.SparseSymMatProd.from_full(A, format=fmt), x, mesh)
            out[fmt] = np.asarray(jax.jit(op_s.perform_op)(x_s))
            out[fmt + "_block"] = np.asarray(jax.jit(op_s.perform_op)(_rows(X)))
        return out
    if name == "stencil_matvec":
        op = ShardedStencilMatProd.create(dia_from_scipy(_laplacian_2d(16)), mesh)
        xs = _rows(np.random.default_rng(0).normal(size=256))
        return dict(y=np.asarray(jax.jit(op.perform_op)(xs)),
                    y2=np.asarray(jax.jit(lambda v: op.perform_op(op.perform_op(v)))(xs)))
    if name == "halo_volume":
        from jax.sharding import PartitionSpec as P

        from spectra_tpu.parallel.stencil_spmv import make_stencil_matvec

        offsets, data, x = halo_case_inputs()
        mv = make_stencil_matvec(mesh, offsets)
        return dict(y=np.asarray(mv(_put(data, P(None, "rows")), _rows(x))))
    if name == "stencil_solver":
        op = ShardedStencilMatProd.create(dia_from_scipy(_laplacian_2d(16)), mesh)
        return _jax_solve(op, 4, 16, "SmallestAlge", _rows(v0(256)))
    if name == "ell_matvec":
        A, rng = _random_sym(0, 0.08)
        x = rng.normal(size=A.shape[0])
        X = rng.normal(size=(A.shape[0], 5))
        op = ShardedEllMatProd.create(A, mesh)
        return dict(y=np.asarray(jax.jit(op.perform_op)(_rows(x))),
                    Y=np.asarray(jax.jit(op.perform_op)(_rows(X))),
                    diag=np.asarray(op.diagonal()))
    if name == "ell_solver":
        op = ShardedEllMatProd.create(_random_sym(3, 0.08)[0], mesh)
        return _jax_solve(op, 4, 16, "LargestMagn", _rows(v0(128)))
    if name == "block_diag":
        A, x = block_diag_matrix()
        op = ShardedEllMatProd.create(A, mesh)
        return dict(y=np.asarray(jax.jit(op.perform_op)(_rows(x))), n_dists=len(op.dists))
    if name == "shift_invert":
        op = sharded_stencil_shift_solve(_laplacian_2d(16), 0.0, mesh)
        e = st.SymEigsShiftSolver.from_factored(op, 4, 16, 0.0)
        e.init(_rows(v0(256)))
        nconv = e.compute(st.SortRule.LargestMagn, tol=1e-10)
        return dict(values=np.asarray(e.eigenvalues()), nconv=nconv, info=e.info().name,
                    method=op.method)
    if name == "stencil_block":
        op = ShardedStencilMatProd.create(dia_from_scipy(_laplacian_2d(16)), mesh)
        X = np.random.default_rng(0).normal(size=(256, 4))
        return dict(Y=np.asarray(jax.jit(op.perform_op)(_rows(X))))
    if name == "generalized":
        from spectra_tpu.solvers.sym_geigs_shift import SymGEigsShiftSolver

        A, B = _laplacian_2d(16), _mass_2d(16)
        solve = sharded_stencil_shift_solve(A, 0.0, mesh, b_csr=B)
        bop = ShardedStencilMatProd.create(dia_from_scipy(B), mesh)
        e = SymGEigsShiftSolver.from_factored(solve, bop, 3, 14, 0.0)
        e.init(_rows(v0(256)))
        nconv = e.compute(st.SortRule.LargestMagn, tol=1e-10)
        return dict(values=np.asarray(e.eigenvalues()), nconv=nconv, info=e.info().name)
    if name == "davidson":
        from spectra_tpu.solvers.davidson import DavidsonSymEigsSolver

        dav = DavidsonSymEigsSolver(ShardedEllMatProd.create(_davidson_matrix(), mesh), 3, 12)
        nconv = dav.compute(st.SortRule.LargestAlge, maxit=100, tol=1e-9)
        return dict(values=np.asarray(dav.eigenvalues()), nconv=nconv,
                    niter=dav.num_iterations())
    if name == "locked":
        op = sharded_stencil_shift_solve(_laplacian_2d(16), 0.0, mesh)
        e = st.SymEigsShiftSolver.from_factored(op, 2, 8, 0.0)
        e.init(_rows(v0(256)))
        nconv = e.compute_locked(
            st.SortRule.LargestMagn, maxit=60, tol=1e-9, sorting=st.SortRule.SmallestAlge,
            want=st.SortRule.SmallestAlge, max_rounds=2,
        )
        return dict(values=np.sort(np.asarray(e.eigenvalues())), nconv=nconv)
    if name == "nonfinite":
        op = ShardedStencilMatProd.create(dia_from_scipy(nonfinite_laplacian()), mesh)
        e = st.SymEigsSolver(op, 4, 16)
        e.init(_rows(v0(256)))
        nconv = int(e.compute(st.SortRule.SmallestAlge, maxit=20))
        return dict(counts=[e.info().value, nconv, e.num_iterations(), e.num_operations()])
    if name in ("hilo_matvec", "hilo_solver"):
        op = ShardedStencilHiLoMatProd.create(dia_from_scipy(_laplacian_2d(16)), mesh, chunk=32)
        if name == "hilo_solver":
            e = st.SymEigsSolver(op, 4, 12)
            e.init(_rows(v0(256)))
            nconv = e.compute()
            return dict(values=np.sort(np.asarray(e.eigenvalues())), nconv=nconv)
        rng = np.random.default_rng(0)
        x = rng.normal(size=256)
        X = rng.normal(size=(256, 3))
        return dict(y=np.asarray(jax.jit(op.perform_op)(_rows(x))),
                    y2=np.asarray(jax.jit(lambda v: op.perform_op(op.perform_op(v)))(_rows(x))),
                    Y=np.asarray(jax.jit(op.perform_op)(_rows(X))),
                    diag=np.asarray(op.diagonal()))
    if name == "chebyshev":
        from spectra_tpu.solvers.cheb_sym_eigs import ChebSymEigsSolver

        op = ShardedStencilMatProd.create(dia_from_scipy(_laplacian_2d(40)), mesh)
        e = ChebSymEigsSolver(op, **cheb_settings())
        e.init(_rows(v0(1600)))
        nconv = e.compute()
        return dict(values=np.asarray(e.eigenvalues()), nconv=nconv, info=e.info().name)
    if name == "partial_svd":
        from spectra_tpu.parallel import shard_operator

        out = {}
        for key, M in svd_matrices().items():
            op = (st.SparseGenMatProd.create(M) if key == "tall"
                  else st.DenseGenMatProd.create(M))
            p = st.PartialSVDSolver(shard_operator(op, mesh), 3, 12)
            out[f"{key}_nconv"] = p.compute()
            out[f"{key}_s"] = np.asarray(p.singular_values())
            out[f"{key}_U"] = np.asarray(p.matrix_U(3))
            out[f"{key}_V"] = np.asarray(p.matrix_V(3))
            out[f"{key}_svds_s"] = np.asarray(st.svds(shard_operator(op, mesh), k=3, ncv=12)[1])
        return out
    if name == "mixed":
        A = _laplacian_2d(16)
        op_s, v0_s = shard_problem(st.SparseSymMatProd.from_full(A), v0(256), mesh)
        e = st.SymEigsSolver(op_s, 4, 16)
        e.set_precision("mixed")
        e.init(v0_s)
        nconv = e.compute(st.SortRule.LargestAlge, tol=1e-6)
        out = dict(values=np.asarray(e.eigenvalues()), nconv=nconv, info=e.info().name)
        e = st.SymEigsSolver(ShardedStencilMatProd.create(dia_from_scipy(A), mesh), 4, 16)
        e.set_precision("mixed")
        e.init(v0_s)
        try:
            e.compute(st.SortRule.LargestAlge, tol=1e-6)
            out["stencil_error"] = "ran"
        except ValueError as err:
            out["stencil_error"] = str(err)
        return out
    if name == "lobpcg":
        # The JAX package's LOBPCG on the unsharded matrix: over the
        # sharded stencil operator each of its eager steps compiles for
        # the mesh, for minutes at this size, where GSPMD computes the
        # same values.
        X0, Y, X2 = lobpcg_inputs()
        out = {}
        for key, A, X, con, tol in (("", _laplacian_2d(16), X0, None, 1e-10),
                                    ("con_", _laplacian_2d(16), X2, Y, 1e-10),
                                    ("dav_", _davidson_matrix(), X0, None, 1e-8)):
            lo = st.LOBPCGSolver(A, X)
            if con is not None:
                lo.set_constraints(con)
            out[key + "nconv"] = lo.compute(maxit=300 if con is not None else 200,
                                            tol_div_n=tol)
            out[key + "values"] = np.asarray(lo.eigenvalues())
            out[key + "niter"] = lo.num_iterations()
        return out
    if name == "general":
        op_s, v0_s = shard_problem(st.SparseGenMatProd.create(gen_matrix()), v0(128), mesh)
        e = st.GenEigsSolver(op_s, 4, 16)
        e.init(v0_s)
        out = dict(gen_nconv=e.compute(st.SortRule.LargestMagn),
                   gen_values=np.asarray(e.eigenvalues()))
        from spectra_tpu.parallel import shard_operator

        e = st.HermEigsSolver(shard_operator(st.SparseHermMatProd.create(herm_matrix()), mesh),
                              4, 16)
        e.init()
        out.update(herm_nconv=e.compute(st.SortRule.LargestAlge),
                   herm_values=np.asarray(e.eigenvalues()))
        return out
    if name == "whole_b":
        import dataclasses

        from spectra_tpu.parallel import shard_operator

        A, B = geigs_pair()
        out = {}
        for mode, bop in (("Cholesky", st.SparseCholesky.create(B)),
                          ("RegularInverse", st.SparseRegularInverse.create(B))):
            op_s, v0_s = shard_problem(st.SparseSymMatProd.from_full(A), v0(A.shape[0]), mesh)
            e = st.SymGEigsSolver(op_s, bop, 3, 12, mode=getattr(st.GEigsMode, mode))
            e.init(v0_s)
            out[f"{mode}_nconv"] = e.compute(st.SortRule.LargestAlge)
            out[f"{mode}_values"] = np.asarray(e.eigenvalues())
        emb = st.RealEmbeddedGenMatProd.create(embed_matrix())
        emb = dataclasses.replace(emb, inner=shard_operator(emb.inner, mesh))
        for rule in ("LargestMagn", "LargestImag"):
            e = st.GenEigsSolver(emb, 3, 12)
            e.init()
            out[f"embed_{rule}_nconv"] = e.compute(getattr(st.SortRule, rule))
            out[f"embed_{rule}_values"] = np.asarray(e.eigenvalues())
        return out
    raise KeyError(name)


def _get(port, k, case):
    return {key.split(".", 1)[1]: v for key, v in port[k].items()
            if key.split(".", 1)[0] == case}


def _residual(A, vals, vecs):
    return float(np.abs(A @ vecs - vecs * vals[None, :]).max())


# ---------------------------------------------------------------------------
# TestShardedSolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", MESHES)
class TestShardedSolve:
    def _check(self, port, k, case, A, counts):
        got, ref = _get(port, k, case), jax_case(case)
        assert int(got["nconv"]) == ref["nconv"] and str(got["info"]) == ref["info"]
        np.testing.assert_allclose(got["values"], ref["values"], atol=1e-10)
        assert _residual(A, got["values"], got["vectors"]) < 1e-9
        if counts:  # a simple spectrum: the single-device port's counts
            assert (int(got["niter"]), int(got["nops"])) == (
                int(got["ref_niter"]), int(got["ref_nops"]))

    def test_sharded_ell_matches_unsharded(self, port, k):
        self._check(port, k, "ell_solve", _random_sym(0, 0.1)[0], counts=True)

    def test_sharded_dia_matches_unsharded(self, port, k):
        self._check(port, k, "dia_solve", _laplacian_2d(16), counts=False)

    def test_sharded_dense(self, port, k):
        rng = np.random.default_rng(5)
        A = rng.normal(size=(256, 256))
        self._check(port, k, "dense_solve", A + A.T, counts=False)


@pytest.mark.parametrize("k", MESHES)
def test_spmv_sharded_correct(port, k):
    """GSPMD's lowering (``RowShardedMatProd``: all-gather, then K1's
    plain version on DIA rows, the ELL rows' gather), vector and block,
    equals the JAX package's sharded product and scipy's."""
    got, ref = _get(port, k, "spmv_formats"), jax_case("spmv_formats")
    A = _laplacian_2d(24)
    x, X = spmv_inputs(24)
    for fmt in ("dia", "ell"):
        assert _rel(got[fmt], ref[fmt]) <= 1e-13
        assert _rel(got[fmt + "_block"], ref[fmt + "_block"]) <= 1e-13
        np.testing.assert_allclose(got[fmt], A @ x, atol=1e-12)
        np.testing.assert_allclose(got[fmt + "_block"], A @ X, atol=1e-12)


@pytest.mark.parametrize("k", MESHES)
class TestHaloStencilSpMV:
    def test_matvec_exact(self, port, k):
        got, ref = _get(port, k, "stencil_matvec"), jax_case("stencil_matvec")
        A = _laplacian_2d(16)
        x = np.random.default_rng(0).normal(size=256)
        assert _rel(got["y"], ref["y"]) <= 1e-13 and _rel(got["y2"], ref["y2"]) <= 1e-13
        np.testing.assert_allclose(got["y"], A @ x, atol=1e-13)
        np.testing.assert_allclose(got["y2"], A @ (A @ x), atol=1e-12)

    def test_interior_compute_independent_of_halo_exchange(self, port, k):
        """The reference checks in the compiled HLO that only the
        boundary slices (<= 128 elements) travel. The port makes the
        exchange explicit: one exchange a product, each rank sending its
        bottom ``lo`` rows right and its top ``hi`` rows left (128 each,
        none past the ends), no all-gather; the product equals the JAX
        package's."""
        got, ref = _get(port, k, "halo_volume"), jax_case("halo_volume")
        assert _rel(got["y"], ref["y"]) <= 1e-13
        moved = got["moved"]  # per rank: exchanges, elements sent, all-gathers
        assert moved.shape == (k, 3)
        ends = 0 if k == 1 else 128
        want_sent = [ends if r in (0, k - 1) else 256 for r in range(k)]
        assert moved[:, 1].tolist() == want_sent
        assert moved[:, 0].tolist() == [int(k > 1)] * k
        assert moved[:, 2].tolist() == [0] * k

    def test_solver_matches_unsharded(self, port, k):
        got, ref = _get(port, k, "stencil_solver"), jax_case("stencil_solver")
        A = _laplacian_2d(16)
        assert str(got["info"]) == "Successful" == ref["info"]
        assert int(got["nconv"]) == ref["nconv"]
        assert _residual(A, got["values"], got["vectors"]) < 1e-9
        np.testing.assert_allclose(got["values"].min(), ref["values"].min(), atol=1e-12)


def test_partition_report():
    """The port's census equals the JAX package's exactly (4 parts, as
    the reference; and 8), with the reference's own bounds."""
    from spectra_tpu.parallel import partition_report as jax_report
    from spectra_tpu_torch.parallel import partition_report

    g = 32
    A = _laplacian_2d(g)
    for parts in (4, 8):
        assert partition_report(A, parts) == jax_report(A, parts)
    rep = partition_report(A, 4)
    assert rep["stencil_path_applicable"]
    assert rep["halo_per_part"][0] == g and rep["halo_per_part"][-1] == g
    assert all(h == 2 * g for h in rep["halo_per_part"][1:-1])
    assert rep["halo_bytes_per_spmv"] < rep["allgather_bytes_per_spmv"] / 10


@pytest.mark.parametrize("k", MESHES)
class TestHaloEllSpMV:
    def test_matvec_and_block_exact(self, port, k):
        got, ref = _get(port, k, "ell_matvec"), jax_case("ell_matvec")
        A, rng = _random_sym(0, 0.08)
        x = rng.normal(size=A.shape[0])
        X = rng.normal(size=(A.shape[0], 5))
        for key in ("y", "Y"):
            assert _rel(got[key], ref[key]) <= 1e-13
        # the JAX package's own plan, multiplied by the port
        assert _rel(got["y_jax_plan"], ref["y"]) <= 1e-13
        np.testing.assert_allclose(got["y"], A @ x, atol=1e-12)
        np.testing.assert_allclose(got["Y"], A @ X, atol=1e-12)
        np.testing.assert_allclose(got["diag"], A.diagonal(), atol=1e-14)

    def test_solver_matches_unsharded(self, port, k):
        got, ref = _get(port, k, "ell_solver"), jax_case("ell_solver")
        A = _random_sym(3, 0.08)[0]
        assert str(got["info"]) == "Successful" == ref["info"]
        assert int(got["nconv"]) == ref["nconv"]
        np.testing.assert_allclose(got["values"], ref["values"], atol=1e-10)
        lam = got["values"]
        assert _residual(A, lam, got["vectors"]) < 1e-9 * max(1.0, np.abs(lam).max())
        assert (int(got["niter"]), int(got["nops"])) == (
            int(got["ref_niter"]), int(got["ref_nops"]))

    def test_block_diagonal_no_comm(self, port, k):
        got, ref = _get(port, k, "block_diag"), jax_case("block_diag")
        A, x = block_diag_matrix()
        assert int(got["n_dists"]) == 0 == ref["n_dists"]
        assert int(got["exchanges"]) == 0
        assert _rel(got["y"], ref["y"]) <= 1e-13
        np.testing.assert_allclose(got["y"], A @ x, atol=1e-13)


def test_comm_volume_beats_allgather():
    """``plan_halo_partition`` and ``comm_report`` equal the JAX
    package's exactly, at 8 parts on both sides."""
    from spectra_tpu.parallel import plan_halo_partition as jax_plan
    from spectra_tpu_torch.parallel import plan_halo_partition

    A = _laplacian_2d(32)
    plan, ref = plan_halo_partition(A, 8), jax_plan(A, 8)
    for f in ("n", "n_parts", "rows_per", "dists", "halo_sizes"):
        assert getattr(plan, f) == getattr(ref, f)
    for f in ("cols_local", "vals_local", "b_rows", "b_pos", "b_vals"):
        np.testing.assert_array_equal(getattr(plan, f), np.asarray(getattr(ref, f)))
    for s, r in zip(plan.send_idx, ref.send_idx, strict=True):
        np.testing.assert_array_equal(s, np.asarray(r))
    rep = plan.comm_report()
    assert rep == ref.comm_report()
    assert plan.dists == (-1, 1)
    assert rep["halo_bytes"] * 10 <= rep["allgather_bytes"]


@pytest.mark.parametrize("k", MESHES)
def test_sharded_shift_invert_solver(port, k):
    got, ref = _get(port, k, "shift_invert"), jax_case("shift_invert")
    assert int(got["nconv"]) == 4 == ref["nconv"]
    assert str(got["info"]) == "Successful" == ref["info"]
    assert str(got["method"]) == ref["method"]
    vals = np.sort(got["values"])
    np.testing.assert_allclose(vals, _analytic_2d(16, 4), atol=1e-9)
    np.testing.assert_allclose(vals, np.sort(ref["values"]), atol=1e-9)


@pytest.mark.parametrize("k", MESHES)
def test_stencil_block_matvec(port, k):
    got, ref = _get(port, k, "stencil_block"), jax_case("stencil_block")
    X = np.random.default_rng(0).normal(size=(256, 4))
    assert _rel(got["Y"], ref["Y"]) <= 1e-13
    np.testing.assert_allclose(got["Y"], _laplacian_2d(16) @ X, atol=1e-12)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_generalized_b_inner_product(port, k):
    import scipy.linalg as sla

    got, ref = _get(port, k, "generalized"), jax_case("generalized")
    assert int(got["nconv"]) == 3 == ref["nconv"]
    assert str(got["info"]) == "Successful" == ref["info"]
    A, B = _laplacian_2d(16), _mass_2d(16)
    want = np.sort(sla.eigh(A.toarray(), B.toarray(), eigvals_only=True))[:3]
    np.testing.assert_allclose(np.sort(got["values"]), want, atol=1e-8)
    np.testing.assert_allclose(np.sort(got["values"]), np.sort(ref["values"]), atol=1e-8)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_davidson_block_products(port, k):
    """The JD's block products over the distance-grouped exchange, its
    QRs on the gathered block: the JAX package's values, and the
    single-device port's iterations and operations."""
    got, ref = _get(port, k, "davidson"), jax_case("davidson")
    A = _davidson_matrix()
    assert int(got["nconv"]) == 3 == ref["nconv"]
    want = np.sort(np.linalg.eigvalsh(A.toarray()))[-3:]
    np.testing.assert_allclose(np.sort(got["values"]), want, atol=1e-7)
    np.testing.assert_allclose(np.sort(got["values"]), np.sort(ref["values"]), atol=1e-7)
    assert (int(got["niter"]), int(got["nops"])) == (int(got["ref_niter"]), int(got["ref_nops"]))
    assert _residual(A, got["values"], got["vectors"]) < 1e-7


@pytest.mark.parametrize("k", MESHES)
def test_sharded_compute_locked_continuation(port, k):
    got, ref = _get(port, k, "locked"), jax_case("locked")
    assert int(got["nconv"]) >= 2 and ref["nconv"] >= 2
    assert int(got["rounds"]) >= 2  # a deflated continuation round ran
    vals = np.sort(got["values"])
    w_all = np.sort(np.linalg.eigvalsh(_laplacian_2d(16).toarray()))
    assert np.abs(vals[:, None] - w_all[None, :]).min(axis=1).max() < 1e-8
    np.testing.assert_allclose(vals[:2], w_all[:2], atol=1e-8)
    np.testing.assert_allclose(vals[:2], ref["values"][:2], atol=1e-8)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_nonfinite_ends_with_numerical_issue(port, k):
    """A NaN in one rank's rows: every rank reaches the same decision
    from the all-reduced projection and norm, so each ends with
    ``NumericalIssue`` and the same counts, those of the one-rank run
    and of the JAX package on its 8-device mesh (20 restarts, 17 + 20 *
    12 operations); stepped, the run stops before its first restart.
    The world finishing at all shows that no rank left a collective
    another waited in."""
    import spectra_tpu_torch as stt

    got = _get(port, k, "nonfinite")
    issue = stt.CompInfo.NumericalIssue.value
    single, stepped = got["single"], got["stepped"]
    assert single.shape == stepped.shape == (k, 4)
    assert (single == got["single_ref"][None, :]).all()
    assert (stepped == got["stepped_ref"][None, :]).all()
    assert single[0].tolist() == jax_case("nonfinite")["counts"] == [issue, 0, 21, 257]
    assert stepped[0].tolist() == [issue, 0, 1, 17]


@pytest.mark.parametrize("k", MESHES)
class TestHaloStencilHiLoSpMV:
    def test_matvec_block_diag_exact(self, port, k):
        """K2's ``_ext`` entry (its plain version here) over the exchanged
        halo, on the port's planes and on the JAX package's (chunk
        padding stripped), against the JAX kernel in interpret mode."""
        got, ref = _get(port, k, "hilo_matvec"), jax_case("hilo_matvec")
        A = _laplacian_2d(16)
        rng = np.random.default_rng(0)
        x = rng.normal(size=256)
        X = rng.normal(size=(256, 3))
        for key in ("y", "y2", "Y"):
            assert _rel(got[key], ref[key]) <= 1e-13
        assert _rel(got["y_jax_planes"], ref["y"]) <= 1e-13
        np.testing.assert_allclose(got["y"], A @ x, atol=1e-12)
        np.testing.assert_allclose(got["y2"], A @ (A @ x), atol=1e-11)
        np.testing.assert_allclose(got["Y"], A @ X, atol=1e-12)
        np.testing.assert_allclose(got["diag"], A.diagonal(), atol=0)
        np.testing.assert_array_equal(got["diag"], ref["diag"])

    def test_solver_through_kernel_matches_dense(self, port, k):
        got, ref = _get(port, k, "hilo_solver"), jax_case("hilo_solver")
        assert int(got["nconv"]) >= 4 and ref["nconv"] >= 4
        vals = np.sort(got["values"])
        w = np.sort(np.linalg.eigvalsh(_laplacian_2d(16).toarray()))
        assert np.abs(vals[:, None] - w[None, :]).min(axis=1).max() < 1e-10
        distinct = np.unique(np.round(w, 9))
        np.testing.assert_allclose(vals[-2:], distinct[-2:], atol=1e-10)
        np.testing.assert_allclose(vals[-2:], ref["values"][-2:], atol=1e-10)

    def test_auto_routing_policy(self, port, k):
        """On the CPU ``"auto"`` keeps the exact-f64 class; ``hilo=True``
        forces the kernel class, as the JAX package routes."""
        from spectra_tpu.parallel import ShardedStencilHiLoMatProd as JaxHiLo
        from spectra_tpu.parallel import sharded_stencil_op
        from spectra_tpu.sparse import dia_from_scipy

        got = _get(port, k, "routing")
        dia = dia_from_scipy(_laplacian_2d(16))
        assert str(got["auto"]) == type(sharded_stencil_op(dia, _mesh8())).__name__
        assert str(got["auto"]) == "ShardedStencilMatProd"
        assert str(got["forced"]) == "ShardedStencilHiLoMatProd"
        assert isinstance(sharded_stencil_op(dia, _mesh8(), hilo=True), JaxHiLo)


# ---------------------------------------------------------------------------
# The composed solvers on a row mesh
# ---------------------------------------------------------------------------


def _spectrum_2d(g):
    i = np.arange(1, g + 1)
    mu = 4 * np.sin(np.pi * i / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None] + mu[None, :]).ravel())


@pytest.mark.parametrize("k", MESHES)
def test_chebyshev_over_sharded_halo_op(port, k):
    """The Chebyshev-filtered IRLM over the halo-exchange stencil
    operator at the reference test's settings: 6/6 within 1e-10 of the
    analytic values and of the JAX package's on its 8-device mesh; the
    single-device port's restarts and filtered operations."""
    got, ref = _get(port, k, "chebyshev"), jax_case("chebyshev")
    A = _laplacian_2d(40)
    assert int(got["nconv"]) == 6 == ref["nconv"]
    assert str(got["info"]) == "Successful" == ref["info"]
    vals = np.sort(got["values"])
    np.testing.assert_allclose(vals, _spectrum_2d(40)[-6:], atol=1e-10)
    np.testing.assert_allclose(vals, np.sort(ref["values"]), atol=1e-10)
    assert _residual(A, got["values"], got["vectors"]) < 1e-9
    assert (int(got["niter"]), int(got["nops"])) == (int(got["ref_niter"]),
                                                     int(got["ref_nops"]))
    assert int(got["all_reduces"]) > 0


def _same_up_to_sign(X, Y, atol):
    signs = np.sign(np.sum(X * Y, axis=0))
    np.testing.assert_allclose(X * signs[None, :], Y, atol=atol)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_partial_svd_and_svds(port, k):
    """``PartialSVDSolver`` over ``shard_operator`` of a tall sparse and
    a wide dense matrix: singular values within 1e-12 of the JAX
    package's and of numpy's ``svd``, U and V equal to both up to sign
    (within 1e-9: the IRLM's tol over the gap), the single-device port's
    counts; ``svds`` over the same operator gives the class's values and
    factors exactly and the JAX ``svds``'s values."""
    got, ref = _get(port, k, "partial_svd"), jax_case("partial_svd")
    for name, M in svd_matrices().items():
        Md = M.toarray() if hasattr(M, "toarray") else M
        U0, s0, Vt0 = np.linalg.svd(Md)
        s = got[f"{name}_s"]
        assert int(got[f"{name}_nconv"]) == 3 == ref[f"{name}_nconv"]
        np.testing.assert_allclose(s, s0[:3], atol=1e-12)
        np.testing.assert_allclose(s, ref[f"{name}_s"], atol=1e-12)
        for key, want in (("U", U0[:, :3]), ("V", Vt0[:3].T)):
            _same_up_to_sign(got[f"{name}_{key}"], want, 1e-9)
            _same_up_to_sign(got[f"{name}_{key}"], ref[f"{name}_{key}"], 1e-9)
        assert got[f"{name}_counts"].tolist() == got[f"{name}_ref_counts"].tolist()
        np.testing.assert_array_equal(got[f"{name}_svds_s"][::-1], s)
        np.testing.assert_array_equal(got[f"{name}_svds_u"][:, ::-1], got[f"{name}_U"])
        np.testing.assert_array_equal(got[f"{name}_svds_v"][:, ::-1], got[f"{name}_V"])
        np.testing.assert_allclose(got[f"{name}_svds_s"], ref[f"{name}_svds_s"], atol=1e-12)


@pytest.mark.parametrize("k", MESHES)
def test_sharded_mixed_precision(port, k):
    """Mixed precision over ``shard_problem`` of the g=16 Laplacian, its
    f32 twin on the rank's DIA, ELL and hi/lo rows: ``nconv`` and the
    values within 1e-9 max|lambda| of the JAX package's (the mode's
    contract); a halo-exchange stencil operator raises the JAX
    package's ``ValueError``."""
    got, ref = _get(port, k, "mixed"), jax_case("mixed")
    A = _laplacian_2d(16)
    scale = np.abs(ref["values"]).max()
    for fmt, local in (("dia", "DiaMatrix"), ("ell", "EllMatrix"), ("dia_hilo", "_HiLoRows")):
        assert str(got[f"{fmt}_twin"]) == local
        assert int(got[f"{fmt}_nconv"]) == ref["nconv"] == 4
        assert str(got[f"{fmt}_info"]) == ref["info"]
        np.testing.assert_allclose(got[f"{fmt}_values"], ref["values"], atol=1e-9 * scale)
        assert _residual(A, got[f"{fmt}_values"], got[f"{fmt}_vectors"]) < 1e-6 * scale
    assert str(got["stencil_error"]) == ref["stencil_error"]
    assert "got ShardedStencilMatProd" in ref["stencil_error"]


@pytest.mark.parametrize("k", MESHES)
def test_sharded_lobpcg(port, k):
    """LOBPCG over ``ShardedStencilMatProd``: the reference test's
    settings (tolerance 1e-6 on the values) against the JAX package's
    values, also with deflation constraints; the iterations equal the
    single-device port's on the Davidson matrix at ``tol_div_n=1e-8``.
    (On the Laplacian at ``tol_div_n=1e-10`` the count sits at LOBPCG's
    residual floor, where the order of the sums moves it, so it is not
    held there.)"""
    got, ref = _get(port, k, "lobpcg"), jax_case("lobpcg")
    A = _laplacian_2d(16)
    w = np.sort(np.linalg.eigvalsh(A.toarray()))
    for key, want in (("", w[:4]), ("con_", w[2:4])):
        assert int(got[key + "nconv"]) == ref[key + "nconv"] == len(want)
        assert str(got[key + "info"]) == "Successful"
        np.testing.assert_allclose(np.sort(got[key + "values"]), want, atol=1e-6)
        np.testing.assert_allclose(np.sort(got[key + "values"]),
                                   np.sort(ref[key + "values"]), atol=1e-6)
    assert _residual(A, got["values"], got["vectors"]) < 1e-5
    assert int(got["dav_niter"]) == int(got["dav_ref_niter"])
    np.testing.assert_allclose(np.sort(got["dav_values"]), np.sort(ref["dav_values"]),
                               atol=1e-6)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("solver", ["gen", "herm"])
def test_sharded_general_and_hermitian(port, k, solver):
    """``GenEigsSolver`` over ``shard_problem(SparseGenMatProd)`` and
    ``HermEigsSolver`` over ``shard_operator(SparseHermMatProd)``: the
    JAX package's values within 1e-10, residuals under 1e-9, the
    single-device port's counts."""
    got, ref = _get(port, k, "general"), jax_case("general")
    A = gen_matrix() if solver == "gen" else herm_matrix()
    vals = got[f"{solver}_values"]
    assert int(got[f"{solver}_nconv"]) == ref[f"{solver}_nconv"] == 4
    assert str(got[f"{solver}_info"]) == "Successful"
    np.testing.assert_allclose(np.sort_complex(vals),
                               np.sort_complex(ref[f"{solver}_values"]), atol=1e-10)
    assert _residual(A, vals, got[f"{solver}_vectors"]) < 1e-9
    assert (int(got[f"{solver}_niter"]), int(got[f"{solver}_nops"])) == (
        int(got[f"{solver}_ref_niter"]), int(got[f"{solver}_ref_nops"]))


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("mode", ["Cholesky", "RegularInverse"])
def test_sharded_geigs_whole_b(port, k, mode):
    """``SymGEigsSolver`` over a row-sharded A with B's factor (Cholesky)
    or B (RegularInverse) whole on every rank, as the JAX package runs
    it through GSPMD: the JAX package's values within 1e-10, residuals
    ``||A x - lambda B x||`` under 1e-9, the single-device port's counts."""
    got, ref = _get(port, k, "whole_b"), jax_case("whole_b")
    A, B = geigs_pair()
    vals, vecs = got[f"{mode}_values"], got[f"{mode}_vectors"]
    assert int(got[f"{mode}_nconv"]) == ref[f"{mode}_nconv"] == 3
    np.testing.assert_allclose(vals, ref[f"{mode}_values"], atol=1e-10)
    assert np.abs(A @ vecs - (B @ vecs) * vals[None, :]).max() < 1e-9
    assert got[f"{mode}_counts"].tolist() == got[f"{mode}_ref_counts"].tolist()


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("rule", ["LargestMagn", "LargestImag"])
def test_sharded_real_embedding(port, k, rule):
    """``GenEigsSolver`` on the real embedding of a complex matrix with a
    row-sharded inner operator (LargestImag through the rotated
    embedding's half swap): the JAX package's values within 1e-10, the
    gathered complex eigenvectors' residuals under 1e-9, the
    single-device port's counts."""
    got, ref = _get(port, k, "whole_b"), jax_case("whole_b")
    C = embed_matrix()
    key = f"embed_{rule}_"
    vals = got[key + "values"]
    assert int(got[key + "nconv"]) == ref[key + "nconv"] == 3
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(ref[key + "values"]),
                               atol=1e-10)
    assert _residual(C, vals, got[key + "vectors"]) < 1e-9
    assert got[key + "counts"].tolist() == got[key + "ref_counts"].tolist()


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("rule", ["BothEnds", "LargestAlge"])
def test_sharded_davidson_host_route(port, k, rule):
    """The JD host loop over ``ShardedEllMatProd`` (BothEnds, and
    LargestAlge under ``SPECTRA_TPU_JD_DRIVER=host``): the wanted values
    of ``eigvalsh`` within 1e-7 (the reference Davidson test's
    tolerance), residuals under 1e-7, the single-device port's values
    within 1e-12 and its counts. (The JAX package's host loop over its
    sharded operator recompiles each growing search space for the mesh,
    for minutes, so its values are not taken.)"""
    got = _get(port, k, "davidson_host")
    A = _davidson_matrix()
    w = np.sort(np.linalg.eigvalsh(A.toarray()))
    want = np.sort(np.concatenate([w[:2], w[-2:]])) if rule == "BothEnds" else w[-4:]
    vals = got[f"{rule}_values"]
    assert int(got[f"{rule}_nconv"]) == 4
    np.testing.assert_allclose(np.sort(vals), want, atol=1e-7)
    np.testing.assert_allclose(vals, got[f"{rule}_ref_values"], atol=1e-12)
    assert _residual(A, vals, got[f"{rule}_vectors"]) < 1e-7
    assert got[f"{rule}_counts"].tolist() == got[f"{rule}_ref_counts"].tolist()


if __name__ == "__main__":
    _worker(sys.argv[1])
