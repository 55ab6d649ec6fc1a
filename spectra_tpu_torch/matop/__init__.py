"""Operators: sparse matrix products, the Krylov inner-product seam, the
Chebyshev filter and the sparse shift-solve."""

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
from spectra_tpu_torch.matop.shift_solve import SparseSymShiftSolve
from spectra_tpu_torch.matop.sparse import SparseGenMatProd, SparseSymMatProd

__all__ = [
    "ArnoldiOp",
    "SparseGenMatProd",
    "SparseSymMatProd",
    "SparseSymShiftSolve",
]
