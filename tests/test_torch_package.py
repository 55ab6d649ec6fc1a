"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, and its entry points default to the GPU and raise without one."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu_torch as stt

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "spectra_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, spectra_tpu_torch, spectra_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'spectra_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "spectra_tpu"), (path, name)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    lap = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(50, 50)).tocsr()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseSymMatProd.from_full(lap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseGenMatProd.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseSymShiftSolve.create(lap, method="mg").set_shift(0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseSymShiftSolve.create(lap).set_shift(0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseSymMatProd.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseSymShiftSolve.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseCholesky.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseCholesky.create(lap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseRegularInverse.create(lap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SymShiftInvert.create(lap, lap).set_shift(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SymShiftInvert.create(lap.toarray(), lap.toarray()).set_shift(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseGenRealShiftSolve.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseGenComplexShiftSolve.create(np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseGenRealShiftSolve.create(lap).set_shift(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseGenRealShiftSolve.create(lap, method="bicgstab").set_shift(0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseGenComplexShiftSolve.create(lap).set_shift(0.5, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.RealEmbeddedGenMatProd.create(np.eye(4) + 1j * np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.RealEmbeddedGenMatProd.create(sps.eye(4, dtype=complex).tocsr())
    herm = np.eye(4) + 1j * np.triu(np.ones((4, 4)), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseHermMatProd.create(herm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.SparseHermMatProd.create(sps.csr_matrix(herm))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.DenseHermShiftSolve.create(herm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.RealEmbeddedHermMatProd.create(herm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.PartialSVDSolver(np.eye(6), ncomp=2, ncv=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stt.LOBPCGSolver(lap, np.ones((50, 2)))
    op = stt.SparseSymMatProd.from_full(lap, device="cpu")
    assert op.device.type == "cpu"
    s = stt.SymEigsSolver(op, nev=2, ncv=8)
    s.init()
    assert s.compute(stt.SortRule.LargestAlge) == 2
    assert s.eigenvectors().device.type == "cpu"
    g = stt.GenEigsSolver(stt.SparseGenMatProd.create(lap, device="cpu"), nev=2, ncv=8)
    g.init()
    assert g.compute(stt.SortRule.LargestMagn) == 2
    assert g.eigenvectors().device.type == "cpu" and g.eigenvectors().is_complex()


def test_public_surface():
    assert set(stt.__all__) == {
        "ChebSymEigsSolver", "CompInfo", "DiaHiLoMatrix", "SortRule",
        "SparseGenMatProd", "SparseSymMatProd", "SparseSymShiftSolve",
        "SymEigsShiftSolver", "SymEigsSolver", "maybe_hilo",
        "GEigsMode", "DenseSymMatProd", "DenseGenMatProd",
        "DenseSymShiftSolve", "DenseCholesky", "SparseCholesky",
        "SparseRegularInverse", "SymShiftInvert", "SymGEigsSolver",
        "SymGEigsShiftSolver", "GenEigsSolver", "GenEigsRealShiftSolver",
        "GenEigsComplexShiftSolver", "DenseGenRealShiftSolve",
        "DenseGenComplexShiftSolve", "SparseGenRealShiftSolve",
        "SparseGenComplexShiftSolve", "RealEmbeddedGenMatProd",
        "RotatedEmbeddedGenMatProd", "DenseHermMatProd", "SparseHermMatProd",
        "DenseHermShiftSolve", "RealEmbeddedHermMatProd", "HermEigsSolver",
        "JDSymEigsBase", "DavidsonSymEigsSolver", "PartialSVDSolver",
        "LOBPCGSolver", "__version__", "SPECTRA_TPU_MAJOR_VERSION",
        "SPECTRA_TPU_MINOR_VERSION", "SPECTRA_TPU_PATCH_VERSION",
    }
    assert all(hasattr(stt, name) for name in stt.__all__)
    # The lazy exports, as in the JAX package.
    for name in ("eigsh", "eigs", "svds", "NoConvergence", "io", "profiling"):
        assert hasattr(stt, name), name
    A = sps.random(20, 20, density=0.3, random_state=0, format="csr")
    op = stt.SparseGenMatProd.create(A, device="cpu")
    x = np.random.default_rng(0).normal(size=20)
    np.testing.assert_allclose(
        op.perform_op(torch.from_numpy(x)).numpy(), A @ x, atol=1e-13
    )
    assert (op.rows(), op.cols()) == (20, 20)
