"""The port's process runtime across two OS processes, against the JAX
package.

Reference test: ``tests/test_multihost.py`` (two JAX processes, gloo,
one global mesh). Here two OS processes form a gloo world through
``spectra_tpu_torch.distributed.initialize`` with the environment
``torchrun`` sets (this file run as a script is one of them), build
``global_row_mesh()`` and run the reference worker's steps
(``tests/multihost_worker.py``): an all-reduce over the mesh, the
halo-exchange ELL IRLM and the distributed shift-invert solve of the
g=8 Laplacian. The JAX package runs the same solves on the conftest's
8-device CPU mesh. Tolerances, the reference worker's: eigenvalues
within 1e-8 of the dense ones (1e-6 for shift-invert, at its tol=1e-8),
and the same ``nconv`` and ``info`` as the JAX package.
"""

import json
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

G = 8


def _laplacian(g=G):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _worker(out_dir):
    """One process ("host"): the reference worker's steps."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    import spectra_tpu_torch as stt
    import spectra_tpu_torch.distributed as sdist
    from spectra_tpu_torch.parallel import ShardedEllMatProd, sharded_stencil_shift_solve
    from spectra_tpu_torch.util.rng import SimpleRandom

    sdist.initialize(device="cpu")
    mesh = sdist.global_row_mesh()
    A = _laplacian()
    n = A.shape[0]
    # all-reduce sanity over the process-spanning mesh
    total = float(mesh.all_reduce(torch.ones(1)).item())
    op = ShardedEllMatProd.create(A, mesh)
    v0 = sdist.global_put(SimpleRandom(0).random_vec(n), mesh)
    eigs = stt.SymEigsSolver(op, nev=2, ncv=8)
    eigs.init(v0)
    eigs.compute(stt.SortRule.SmallestAlge, maxit=300)
    si = stt.SymEigsShiftSolver.from_factored(sharded_stencil_shift_solve(A, 0.0, mesh), 2, 8, 0.0)
    si.init(v0)
    nconv = si.compute(stt.SortRule.LargestMagn, maxit=100, tol=1e-8)
    out = dict(
        rank=mesh.rank, size=mesh.size, total=total, dists=list(op.dists),
        backend=mesh.backend, info=eigs.info().name, values=eigs.eigenvalues().tolist(),
        vectors=sdist.replicated_to_numpy(sdist.gather_rows(eigs.eigenvectors(), mesh)).tolist(),
        si_nconv=nconv, si_info=si.info().name, si_values=si.eigenvalues().tolist(),
    )
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.multihost
def test_two_process_halo_solve(tmp_path):
    from test_torch_parallel import spawn_world

    import spectra_tpu as st
    from spectra_tpu.parallel import ShardedEllMatProd, row_mesh, sharded_stencil_shift_solve
    from spectra_tpu.util.rng import SimpleRandom
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spawn_world(__file__, tmp_path, 2)
    outs = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    A = _laplacian()
    want = np.sort(np.linalg.eigvalsh(A.toarray()))[:2]

    mesh = row_mesh(8)
    v0 = jax.device_put(jax.numpy.asarray(SimpleRandom(0).random_vec(A.shape[0])),
                        NamedSharding(mesh, P("rows")))
    ref = st.SymEigsSolver(ShardedEllMatProd.create(A, mesh), nev=2, ncv=8)
    ref.init(v0)
    ref.compute(st.SortRule.SmallestAlge, maxit=300)
    ref_si = st.SymEigsShiftSolver.from_factored(
        sharded_stencil_shift_solve(A, 0.0, mesh), 2, 8, 0.0)
    ref_si.init(v0)
    ref_nconv = ref_si.compute(st.SortRule.LargestMagn, maxit=100, tol=1e-8)

    for r, out in enumerate(outs):
        assert (out["rank"], out["size"], out["backend"]) == (r, 2, "gloo")
        assert out["total"] == 2.0
        assert out["dists"] == [-1, 1]
        assert out["info"] == "Successful" == ref.info().name
        got = np.sort(out["values"])
        np.testing.assert_allclose(got, want, atol=1e-8)
        np.testing.assert_allclose(got, np.sort(np.asarray(ref.eigenvalues())), atol=1e-8)
        vecs = np.asarray(out["vectors"])
        vals = np.asarray(out["values"])
        assert np.abs(A @ vecs - vecs * vals[None, :]).max() < 1e-8
        assert out["si_nconv"] == 2 == ref_nconv
        assert out["si_info"] == ref_si.info().name
        np.testing.assert_allclose(np.sort(out["si_values"]), want, atol=1e-6)
    assert outs[0]["values"] == outs[1]["values"]  # one replicated result


def test_row_mesh_starts_a_one_rank_group():
    """Without an initialized process group, ``row_mesh`` starts a
    one-rank group itself (gloo for the CPU), as the JAX ``row_mesh()``
    works without ``jax.distributed``; the solvers then run on it."""
    import subprocess

    code = (
        "import numpy as np, scipy.sparse as sps, torch\n"
        "import spectra_tpu_torch as stt\n"
        "from spectra_tpu_torch.parallel import ShardedEllMatProd, row_mesh\n"
        "m = row_mesh(device='cpu')\n"
        "l = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64)).tocsr()\n"
        "e = stt.SymEigsSolver(ShardedEllMatProd.create(l, m), 2, 8)\n"
        "e.init(); e.compute(stt.SortRule.LargestAlge)\n"
        "print(m.rank, m.size, m.backend, m.device, e.info().name, *e.eigenvalues())\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rank, size, backend, device, info, *vals = out.stdout.split()
    assert (rank, size, backend, device, info) == ("0", "1", "gloo", "cpu", "Successful")
    want = np.sort(np.linalg.eigvalsh(
        sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64)).toarray()))[-2:]
    np.testing.assert_allclose(np.sort(np.asarray(vals, float)), want, atol=1e-10)


if __name__ == "__main__":
    _worker(sys.argv[1])
