"""Complex Hermitian eigensolver.

Port of :mod:`spectra_tpu.solvers.herm_eigs` (reference:
include/Spectra/HermEigsSolver.h:122-148): implicitly restarted Lanczos
for complex Hermitian matrices, with real eigenvalues and complex
eigenvectors. The basis V and the products run in complex arithmetic on
the operator's device; the projection H is real (Hermitian Rayleigh
quotients are real), so the host's tridiagonal restart and Ritz
pipeline is the real solver's, unchanged.

Example
-------
>>> import spectra_tpu_torch as stt
>>> op = stt.DenseHermMatProd.create(A)          # on the GPU
>>> eigs = stt.HermEigsSolver(op, nev=10, ncv=20)
>>> eigs.init()
>>> nconv = eigs.compute(stt.SortRule.LargestAlge)
"""

from spectra_tpu_torch.solvers.base import HermEigsBase


class HermEigsSolver(HermEigsBase):
    """Implicitly restarted Lanczos for complex Hermitian problems.

    ``op`` is any complex operator with ``rows()``, ``cols()``,
    ``dtype``, ``device`` and ``perform_op(x)``, e.g.
    :class:`~spectra_tpu_torch.matop.dense.DenseHermMatProd` or
    :class:`~spectra_tpu_torch.matop.sparse.SparseHermMatProd`.
    """

    _mode = "lanczos"
