"""Davidson (diagonally preconditioned Jacobi-Davidson) eigensolver.

Port of :mod:`spectra_tpu.solvers.davidson` (reference:
include/Spectra/DavidsonSymEigsSolver.h:31-89): the Derived-Pair-Residue
(DPR) correction ``r / (rho - D)`` (:77-88) over an initial search space
of unit vectors at the extreme diagonal entries (:60-72), both built on
the operator's device. Effective for diagonally dominant matrices. A
vanishing denominator ``rho - D`` is not clamped: the correction goes
non-finite and the iteration ends with ``CompInfo.NumericalIssue``, as
in the JAX package.
"""

import torch

from spectra_tpu_torch.solvers.jd_sym_eigs import JDSymEigsBase
from spectra_tpu_torch.util.selection import SortRule, argsort


class DavidsonSymEigsSolver(JDSymEigsBase):
    """Davidson solver with the DPR correction.

    ``op`` must also expose ``diagonal()`` (every built-in product
    operator does), the counterpart of the reference caching ``op(i, i)``
    (DavidsonSymEigsSolver.h:45-49).
    """

    def __init__(self, op, nev: int, nvec_init: int | None = None,
                 nvec_max: int | None = None):
        super().__init__(op, nev, nvec_init, nvec_max)
        self._diagonal = op.diagonal()

    def setup_initial_search_space(self, selection: SortRule):
        """Unit vectors at the ``nvec_init`` extreme diagonal entries
        (reference: DavidsonSymEigsSolver.h:60-72), an (n, nvec_init)
        block on the device; over a row-sharded operator the extremes of
        the whole (gathered) diagonal, and the rank's rows of the
        block."""
        size = self._initial_search_space_size
        mesh = getattr(self._op, "mesh", None)
        diag = self._diagonal if mesh is None else mesh.all_gather(self._diagonal)
        ind = argsort(selection, diag)[:size]
        cols = torch.arange(size, device=self._device)
        first, end = 0, self._op.rows()
        if mesh is not None:
            first, end = mesh.row_range(end)
            mine = (ind >= first) & (ind < end)
            ind, cols = ind[mine], cols[mine]
        basis = torch.zeros(
            (end - first, size), dtype=self._diagonal.dtype, device=self._device
        )
        basis[ind - first, cols] = 1.0
        return basis

    def calculate_correction_vector(self):
        """The DPR correction ``r_k / (rho_k - D)`` of the leading Ritz
        pairs that the iteration hands over, ``correction_size`` of them
        (DavidsonSymEigsSolver.h:77-88), on the device."""
        pairs = self._ritz_pairs
        return pairs.residues / (pairs.values - self._diagonal[:, None])
