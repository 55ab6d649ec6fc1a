"""Eigensolver drivers."""

from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs_shift import SymEigsShiftSolver

__all__ = ["ChebSymEigsSolver", "SymEigsShiftSolver", "SymEigsSolver"]
