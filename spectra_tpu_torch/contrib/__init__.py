"""Extras built on the core solvers (reference: contrib/): the partial
SVD and LOBPCG."""

from spectra_tpu_torch.contrib.lobpcg import LOBPCGSolver
from spectra_tpu_torch.contrib.partial_svd import PartialSVDSolver

__all__ = ["LOBPCGSolver", "PartialSVDSolver"]
