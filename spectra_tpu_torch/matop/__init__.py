"""Operators: sparse matrix products, the Krylov inner-product seam and
the Chebyshev filter."""

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
from spectra_tpu_torch.matop.sparse import SparseGenMatProd, SparseSymMatProd

__all__ = ["ArnoldiOp", "SparseGenMatProd", "SparseSymMatProd"]
