"""Standard real symmetric eigensolver.

Port of :mod:`spectra_tpu.solvers.sym_eigs` (reference:
include/Spectra/SymEigsSolver.h:134-160): implicitly restarted Lanczos
for k extremal eigenpairs of a real symmetric matrix available through
a matvec.

Example
-------
>>> import scipy.sparse as sps
>>> import spectra_tpu_torch as stt
>>> A = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(1000, 1000))
>>> op = stt.SparseSymMatProd.from_full(A)          # on the GPU
>>> eigs = stt.SymEigsSolver(op, nev=3, ncv=12)
>>> eigs.init()
>>> nconv = eigs.compute(stt.SortRule.LargestAlge)
>>> evalues = eigs.eigenvalues()
"""

from spectra_tpu_torch.solvers.base import HermEigsBase


class SymEigsSolver(HermEigsBase):
    """Implicitly restarted Lanczos for real symmetric problems.

    ``op`` is any operator with ``rows()``, ``cols()``, ``dtype``,
    ``device`` and ``perform_op(x)``, e.g.
    :class:`~spectra_tpu_torch.matop.sparse.SparseSymMatProd`.
    """

    _mode = "lanczos"
