"""Eigensolver drivers."""

from spectra_tpu_torch.solvers.cheb_sym_eigs import ChebSymEigsSolver
from spectra_tpu_torch.solvers.gen_eigs import GenEigsSolver
from spectra_tpu_torch.solvers.gen_eigs_shift import (
    GenEigsComplexShiftSolver,
    GenEigsRealShiftSolver,
)
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.solvers.sym_eigs_shift import SymEigsShiftSolver
from spectra_tpu_torch.solvers.sym_geigs import SymGEigsSolver
from spectra_tpu_torch.solvers.sym_geigs_shift import SymGEigsShiftSolver

__all__ = [
    "ChebSymEigsSolver",
    "GenEigsComplexShiftSolver",
    "GenEigsRealShiftSolver",
    "GenEigsSolver",
    "SymEigsShiftSolver",
    "SymEigsSolver",
    "SymGEigsShiftSolver",
    "SymGEigsSolver",
]
