"""Operators: dense and sparse matrix products (symmetric, general and
Hermitian), the Krylov inner-product seam, the Chebyshev filter, the
shift-solves (symmetric, Hermitian and general), the real embeddings of
complex matrices, and the Cholesky, regular-inverse and shift-invert
operators of generalized problems."""

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, IdentityBOp
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

__all__ = [
    "ArnoldiOp",
    "DenseCholesky",
    "DenseGenComplexShiftSolve",
    "DenseGenMatProd",
    "DenseGenRealShiftSolve",
    "DenseHermMatProd",
    "DenseHermShiftSolve",
    "DenseSymMatProd",
    "DenseSymShiftSolve",
    "IdentityBOp",
    "RealEmbeddedGenMatProd",
    "RealEmbeddedHermMatProd",
    "RotatedEmbeddedGenMatProd",
    "SparseCholesky",
    "SparseGenComplexShiftSolve",
    "SparseGenMatProd",
    "SparseGenRealShiftSolve",
    "SparseHermMatProd",
    "SparseRegularInverse",
    "SparseSymMatProd",
    "SparseSymShiftSolve",
    "SymShiftInvert",
]
