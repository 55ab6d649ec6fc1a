"""spectra_tpu_torch: the PyTorch/CUDA port of spectra_tpu.

A second package beside the JAX reference ``spectra_tpu``, with the
same subpackage layout and public surface, for one NVIDIA H100. The
n-length work (SpMVs, basis projections, restart rotations) runs on
the card, the DIA SpMVs as hand-written CUDA kernels
(``csrc/dia_spmv.cu``, and ``csrc/dia_ds.cu`` for the double-single
hi/lo planes of large f64 stencils); shift-invert runs its inner solves
(multigrid, Chebyshev, MINRES, CG) and the dense Bunch-Kaufman
factorization on the card and SuperLU on the host. The generalized
problem ``A x = lambda B x`` runs in its five modes (``GEigsMode``).
General (non-symmetric) matrices, real or complex, run the implicitly
restarted Arnoldi method (``GenEigsSolver``, implicit or Krylov-Schur
restarts) and its real- and complex-shift inversions, by LU on the card,
SuperLU on the host or BiCGStab on the card. Complex Hermitian
matrices run the same Lanczos in complex arithmetic (``HermEigsSolver``),
or their real J-structured embedding. The Jacobi-Davidson family
(``DavidsonSymEigsSolver``) runs its fixed-buffer loop on the card, and
``contrib`` holds the partial SVD and LOBPCG.
The small (ncv, ncv) projected problem runs on the host in f64, and
small dense f64 problems go whole to a native Krylov-Schur driver on
the host (``csrc/dense_eigs.cpp``; ``SPECTRA_TPU_DENSE_DRIVER=torch``
keeps them on the card). Entry points take ``device=None``, which means the
GPU, and raise when there is none; pass ``device="cpu"`` to run the
plain PyTorch path on the CPU. Tensors default to float64 through the
operator's dtype; torch's global default dtype is never changed.

The scipy-style frontends ``eigsh``, ``eigs`` and ``svds`` (with
``NoConvergence``) and the submodules ``io`` and ``profiling`` are
exported lazily, as in the JAX package. ``set_precision("mixed")`` on
the plain symmetric drivers runs the restarted Lanczos in f32 and
refines in f64. Host sparse conversions and the multigrid hierarchy's
products run in the port's native library (``csrc/sparse_kernels.cpp``,
built by ``g++`` on first use).

The multi-device layer (``parallel``, ``distributed``, exported lazily)
row-partitions an operator and the Krylov vectors over one process per
device on ``torch.distributed``: halo-exchange stencil and ELL SpMVs,
the sharded multigrid, and the all-reduced inner products of every
driver.

This package imports torch, numpy and scipy, never jax or
``spectra_tpu``.
"""

from spectra_tpu_torch.contrib.lobpcg import LOBPCGSolver
from spectra_tpu_torch.contrib.partial_svd import PartialSVDSolver
from spectra_tpu_torch.matop.cholesky import DenseCholesky, SparseCholesky
from spectra_tpu_torch.matop.dense import (
    DenseGenMatProd,
    DenseHermMatProd,
    DenseSymMatProd,
)
from spectra_tpu_torch.matop.gen_embed import (
    RealEmbeddedGenMatProd,
    RotatedEmbeddedGenMatProd,
)
from spectra_tpu_torch.matop.herm_embed import RealEmbeddedHermMatProd
from spectra_tpu_torch.matop.regular_inverse import SparseRegularInverse
from spectra_tpu_torch.matop.shift_solve import (
    DenseGenComplexShiftSolve,
    DenseGenRealShiftSolve,
    DenseHermShiftSolve,
    DenseSymShiftSolve,
    SparseGenComplexShiftSolve,
    SparseGenRealShiftSolve,
    SparseSymShiftSolve,
)
from spectra_tpu_torch.matop.sparse import (
    SparseGenMatProd,
    SparseHermMatProd,
    SparseSymMatProd,
)
from spectra_tpu_torch.matop.sym_shift_invert import SymShiftInvert
from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.solvers.davidson import DavidsonSymEigsSolver
from spectra_tpu_torch.solvers.gen_eigs import GenEigsSolver
from spectra_tpu_torch.solvers.gen_eigs_shift import (
    GenEigsComplexShiftSolver,
    GenEigsRealShiftSolver,
)
from spectra_tpu_torch.solvers.herm_eigs import HermEigsSolver
from spectra_tpu_torch.solvers.jd_sym_eigs import JDSymEigsBase
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs_shift import SymEigsShiftSolver
from spectra_tpu_torch.solvers.sym_geigs import SymGEigsSolver
from spectra_tpu_torch.solvers.sym_geigs_shift import SymGEigsShiftSolver
from spectra_tpu_torch.sparse.formats import DiaHiLoMatrix, maybe_hilo
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.geigsmode import GEigsMode
from spectra_tpu_torch.util.selection import SortRule
from spectra_tpu_torch.util.version import (
    SPECTRA_TPU_MAJOR_VERSION,
    SPECTRA_TPU_MINOR_VERSION,
    SPECTRA_TPU_PATCH_VERSION,
    __version__,
)

__all__ = [
    "ChebSymEigsSolver",
    "CompInfo",
    "DavidsonSymEigsSolver",
    "DenseCholesky",
    "DenseGenComplexShiftSolve",
    "DenseGenMatProd",
    "DenseGenRealShiftSolve",
    "DenseHermMatProd",
    "DenseHermShiftSolve",
    "DenseSymMatProd",
    "DenseSymShiftSolve",
    "DiaHiLoMatrix",
    "GEigsMode",
    "GenEigsComplexShiftSolver",
    "GenEigsRealShiftSolver",
    "GenEigsSolver",
    "HermEigsSolver",
    "JDSymEigsBase",
    "LOBPCGSolver",
    "PartialSVDSolver",
    "RealEmbeddedGenMatProd",
    "RealEmbeddedHermMatProd",
    "RotatedEmbeddedGenMatProd",
    "SortRule",
    "SparseCholesky",
    "SparseGenComplexShiftSolve",
    "SparseGenMatProd",
    "SparseGenRealShiftSolve",
    "SparseHermMatProd",
    "SparseRegularInverse",
    "SparseSymMatProd",
    "SparseSymShiftSolve",
    "SymEigsShiftSolver",
    "SymEigsSolver",
    "SymGEigsShiftSolver",
    "SymGEigsSolver",
    "SymShiftInvert",
    "maybe_hilo",
    "__version__",
    "SPECTRA_TPU_MAJOR_VERSION",
    "SPECTRA_TPU_MINOR_VERSION",
    "SPECTRA_TPU_PATCH_VERSION",
]

_LAZY = {
    # scipy.sparse.linalg-compatible frontend
    "eigsh": "spectra_tpu_torch.api",
    "eigs": "spectra_tpu_torch.api",
    "svds": "spectra_tpu_torch.api",
    "NoConvergence": "spectra_tpu_torch.api",
}
_LAZY_MODULES = {
    "io": "spectra_tpu_torch.io",
    "profiling": "spectra_tpu_torch.util.profiling",
    "parallel": "spectra_tpu_torch.parallel",
    "distributed": "spectra_tpu_torch.distributed",
}


def __getattr__(name):
    # Lazy exports keep ``import spectra_tpu_torch`` light.
    import importlib

    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name in _LAZY_MODULES:
        return importlib.import_module(_LAZY_MODULES[name])
    raise AttributeError(f"module 'spectra_tpu_torch' has no attribute {name!r}")
