"""Eigensolver drivers."""

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

__all__ = [
    "ChebSymEigsSolver",
    "DavidsonSymEigsSolver",
    "GenEigsComplexShiftSolver",
    "GenEigsRealShiftSolver",
    "GenEigsSolver",
    "HermEigsSolver",
    "JDSymEigsBase",
    "SymEigsShiftSolver",
    "SymEigsSolver",
    "SymGEigsShiftSolver",
    "SymGEigsSolver",
]
