"""Jacobi-Davidson driver base for symmetric eigenproblems.

Port of :mod:`spectra_tpu.solvers.jd_sym_eigs` (reference:
include/Spectra/JDSymEigsBase.h:34-186). Every solve runs the one
iteration of :mod:`spectra_tpu_torch.solvers._jd_core`: the n-length
work on the operator's device, the small Rayleigh-Ritz on the host, the
best snapshot and a stagnation patience. Subclasses implement
``setup_initial_search_space(selection)`` and
``calculate_correction_vector()``, the reference's CRTP seam: the
latter reads the leading ``correction_size`` Ritz pairs from
``self._ritz_pairs`` and returns their correction block.
"""

import torch

from spectra_tpu_torch.linalg.ritz_pairs import RitzPairs
from spectra_tpu_torch.solvers._jd_core import jd_compute
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.selection import SortRule

_STATUS = {1: CompInfo.Successful, 2: CompInfo.NotConverging, 3: CompInfo.NumericalIssue}


class JDSymEigsBase:
    """Base class of the Jacobi-Davidson symmetric eigensolvers."""

    def __init__(self, op, nev: int, nvec_init: int | None = None,
                 nvec_max: int | None = None):
        n = op.cols()
        if nev < 1 or nev > n - 1:
            raise ValueError("nev must satisfy 1 <= nev <= n - 1, n is the size of matrix")
        self._op = op
        self._device = op.device
        self._nev = int(nev)
        self._max_search_space_size = int(nvec_max) if nvec_max else 10 * nev
        self._initial_search_space_size = int(nvec_init) if nvec_init else 2 * nev
        self._correction_size = int(nev)
        # reference: JDSymEigsBase.h initialize()
        if n < self._max_search_space_size:
            self._max_search_space_size = n
        if n < self._initial_search_space_size + self._correction_size:
            self._initial_search_space_size = n // 3
            self._correction_size = n // 3
        self._info = CompInfo.NotComputed
        self._niter = 0
        self._nops = 0
        self._ritz_pairs = None

    # -- knobs (reference: JDSymEigsBase.h:93-111) ----------------------
    def set_max_search_space_size(self, size: int):
        self._max_search_space_size = int(size)

    def set_correction_size(self, size: int):
        self._correction_size = int(size)

    def set_initial_search_space_size(self, size: int):
        self._initial_search_space_size = int(size)

    # -- accessors -------------------------------------------------------
    def info(self) -> CompInfo:
        return self._info

    def num_iterations(self) -> int:
        return self._niter

    def num_operations(self) -> int:
        """Operator column applications of the last compute."""
        return self._nops

    def eigenvalues(self):
        """The nev wanted Ritz values (numpy)."""
        return self._ritz_pairs.values[: self._nev].numpy()

    def eigenvectors(self) -> torch.Tensor:
        """The matching Ritz vectors (columns), on the operator's device."""
        return self._ritz_pairs.vectors[:, : self._nev]

    # -- CRTP seam -------------------------------------------------------
    def setup_initial_search_space(self, selection: SortRule):
        raise NotImplementedError

    def calculate_correction_vector(self):
        raise NotImplementedError

    # -- main loop (reference: JDSymEigsBase.h:141-185) -------------------
    def compute(self, selection: SortRule = SortRule.LargestMagn,
                maxit: int = 100, tol: float = 1e-10) -> int:
        initial_space = self.setup_initial_search_space(selection)
        return self.compute_with_guess(initial_space, selection, maxit, tol)

    def compute_with_guess(self, initial_space,
                           selection: SortRule = SortRule.LargestMagn,
                           maxit: int = 100, tol: float = 1e-10) -> int:
        """Run from ``initial_space``, an (n, k) orthonormal block (numpy or
        a tensor), moved to the operator's device. Over a row-sharded
        operator it is the whole block (each rank keeps its rows) or the
        rank's rows; the iteration then reduces over the mesh."""
        initial_space = torch.as_tensor(initial_space)
        mesh = getattr(self._op, "mesh", None)
        if mesh is not None and initial_space.shape[0] == self._op.rows():
            initial_space = mesh.local_rows(initial_space)
        initial_space = initial_space.to(self._device).contiguous()
        res = jd_compute(
            self._op, initial_space, int(maxit), float(tol),
            max_space=self._max_search_space_size,
            i0=self._initial_search_space_size, c=self._correction_size,
            nev=self._nev, selection=selection, correction_fn=self._correction,
        )
        self._niter, self._nops = res.niter, res.nops
        self._info = _STATUS.get(res.status, CompInfo.NotComputed)
        self._ritz_pairs = RitzPairs(
            values=res.values, vectors=res.vectors, residues=res.residues
        )
        return int(res.conv.sum())

    def _correction(self, pairs: RitzPairs):
        """The iteration's seam: the leading pairs (on the device) into
        ``self._ritz_pairs``, the subclass's correction out."""
        self._ritz_pairs = pairs
        return self.calculate_correction_vector()
