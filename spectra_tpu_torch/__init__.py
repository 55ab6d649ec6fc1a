"""spectra_tpu_torch: the PyTorch/CUDA port of spectra_tpu.

A second package beside the JAX reference ``spectra_tpu``, with the
same subpackage layout and public surface, for one NVIDIA H100. The
n-length work (SpMVs, basis projections, restart rotations) runs on
the card, the DIA SpMVs as hand-written CUDA kernels
(``csrc/dia_spmv.cu``, and ``csrc/dia_ds.cu`` for the double-single
hi/lo planes of large f64 stencils); shift-invert runs its inner solves
(multigrid, Chebyshev, MINRES, CG) on the card and SuperLU on the host.
The small (ncv, ncv) projected problem runs on
the host in f64. Entry points take ``device=None``, which means the
GPU, and raise when there is none; pass ``device="cpu"`` to run the
plain PyTorch path on the CPU. Tensors default to float64 through the
operator's dtype; torch's global default dtype is never changed.

This package imports torch, numpy and scipy, never jax or
``spectra_tpu``.
"""

from spectra_tpu_torch.matop.shift_solve import SparseSymShiftSolve
from spectra_tpu_torch.matop.sparse import SparseGenMatProd, SparseSymMatProd
from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs_shift import SymEigsShiftSolver
from spectra_tpu_torch.sparse.formats import DiaHiLoMatrix, maybe_hilo
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.selection import SortRule

__all__ = [
    "ChebSymEigsSolver",
    "CompInfo",
    "DiaHiLoMatrix",
    "SortRule",
    "SparseGenMatProd",
    "SparseSymMatProd",
    "SparseSymShiftSolve",
    "SymEigsShiftSolver",
    "SymEigsSolver",
    "maybe_hilo",
]
