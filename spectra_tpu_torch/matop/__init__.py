"""Operators: dense and sparse matrix products, the Krylov inner-product
seam, the Chebyshev filter, the shift-solves, and the Cholesky,
regular-inverse and shift-invert operators of generalized problems."""

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, IdentityBOp
from spectra_tpu_torch.matop.cholesky import DenseCholesky, SparseCholesky
from spectra_tpu_torch.matop.dense import DenseGenMatProd, DenseSymMatProd
from spectra_tpu_torch.matop.regular_inverse import SparseRegularInverse
from spectra_tpu_torch.matop.shift_solve import DenseSymShiftSolve, SparseSymShiftSolve
from spectra_tpu_torch.matop.sparse import SparseGenMatProd, SparseSymMatProd
from spectra_tpu_torch.matop.sym_shift_invert import SymShiftInvert

__all__ = [
    "ArnoldiOp",
    "DenseCholesky",
    "DenseGenMatProd",
    "DenseSymMatProd",
    "DenseSymShiftSolve",
    "IdentityBOp",
    "SparseCholesky",
    "SparseGenMatProd",
    "SparseRegularInverse",
    "SparseSymMatProd",
    "SparseSymShiftSolve",
    "SymShiftInvert",
]
