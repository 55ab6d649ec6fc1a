"""Eigensolver drivers."""

from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver

__all__ = ["ChebSymEigsSolver", "SymEigsSolver"]
