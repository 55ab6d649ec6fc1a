"""General (non-symmetric) eigensolver, real and complex matrices.

Port of :mod:`spectra_tpu.solvers.gen_eigs` (reference:
include/Spectra/GenEigsSolver.h:159-186; complex matrices since the
reference's v1.2.0): implicitly restarted Arnoldi for k eigenvalues of
a general matrix available through a matvec. Eigenvalues and
eigenvectors are complex; for real matrices they come in conjugate
pairs.

Example
-------
>>> import numpy as np
>>> import spectra_tpu_torch as stt
>>> A = np.random.default_rng(0).normal(size=(100, 100))
>>> op = stt.DenseGenMatProd.create(A, device="cpu")
>>> eigs = stt.GenEigsSolver(op, nev=4, ncv=20)
>>> eigs.init()
>>> nconv = eigs.compute(stt.SortRule.LargestMagn)
"""

import numpy as np
import torch

from spectra_tpu_torch.solvers.gen_base import GenEigsBase
from spectra_tpu_torch.util.selection import SortRule, argsort_np


class GenEigsSolver(GenEigsBase):
    """Implicitly restarted Arnoldi for general eigenvalue problems.

    ``op`` is any operator with ``rows()``, ``cols()``, ``dtype``,
    ``device`` and ``perform_op(x)``, real or complex: e.g.
    :class:`~spectra_tpu_torch.matop.dense.DenseGenMatProd` or
    :class:`~spectra_tpu_torch.matop.sparse.SparseGenMatProd`.

    Handed a :class:`~spectra_tpu_torch.matop.gen_embed.RealEmbeddedGenMatProd`
    (the real 2n embedding of a complex C), the solve runs the real IRAM
    on the embedding and recovers the complex eigenpairs of C
    (:class:`EmbeddedGenEigsSolver`).
    """

    def __init__(self, op, nev: int, ncv: int, bop=None):
        from spectra_tpu_torch.matop.gen_embed import RealEmbeddedGenMatProd

        if isinstance(op, RealEmbeddedGenMatProd) and type(self) is GenEigsSolver:
            self.__class__ = EmbeddedGenEigsSolver
            EmbeddedGenEigsSolver.__init__(self, op, nev, ncv)
            return
        GenEigsBase.__init__(self, op, nev, ncv, bop=bop)


class EmbeddedGenEigsSolver(GenEigsSolver):
    """General complex eigenpairs through the real 2n embedding.

    Each eigenpair of C occupies two slots of the embedding's spectrum
    (its value and its conjugate's phantom), so the inner real solve
    asks for ``2 nev`` pairs; ``compute`` then filters the phantoms,
    removes duplicates and returns up to ``nev`` complex eigenpairs of C
    ordered by ``sorting``. ``eigenvectors()`` are on the operator's
    device.
    """

    def __init__(self, op, nev: int, ncv: int):
        self._embed = op
        self._user_nev = int(nev)
        n2 = op.rows()
        inner_nev = min(2 * nev, n2 - 2)
        inner_ncv = int(min(max(2 * ncv, inner_nev + 3), n2))
        GenEigsBase.__init__(self, op, inner_nev, inner_ncv)
        self._cvals = np.zeros(0, np.complex128)
        self._cvecs = np.zeros((op.n_orig, 0), np.complex128)

    def init(self, init_resid=None):
        if init_resid is not None:
            resid = (
                init_resid.cpu().numpy() if torch.is_tensor(init_resid)
                else np.asarray(init_resid)
            )
            if np.iscomplexobj(resid):
                # a complex length-n start -> its realification
                init_resid = np.concatenate([resid.real, resid.imag])
        super().init(init_resid)

    def compute(self, selection=None, maxit: int = 1000, tol: float = 1e-10,
                sorting=None) -> int:
        selection = SortRule.LargestMagn if selection is None else selection
        sorting = SortRule.LargestMagn if sorting is None else sorting
        if selection in (SortRule.LargestImag, SortRule.SmallestImag):
            # The imaginary-part rules degenerate on the embedding's
            # conjugate-symmetric spectrum. Rotate: Largest/SmallestREAL
            # on the realification of -iC (a free block swap), and map
            # lambda = i lambda' back.
            from spectra_tpu_torch.matop.gen_embed import RotatedEmbeddedGenMatProd

            inner_sel = (
                SortRule.LargestReal if selection == SortRule.LargestImag
                else SortRule.SmallestReal
            )
            rot = GenEigsBase(
                RotatedEmbeddedGenMatProd(embed=self._embed), self._nev, self._ncv
            )
            rot.init(self._v0)
            rot.compute(inner_sel, maxit, tol, inner_sel)
            self._niter = rot.num_iterations()
            self._nops = rot.num_operations()
            self._info = rot.info()
            vals = 1j * rot.eigenvalues()
            vecs = rot.eigenvectors()
        else:
            super().compute(selection, maxit, tol, sorting)
            vals = super().eigenvalues()
            vecs = super().eigenvectors()
        if self._mesh is not None:
            vecs = self._mesh.all_gather(vecs)
        cvals, cvecs = self._embed.map_ritz_pairs(vals, vecs.cpu().numpy())
        if len(cvals):
            order = argsort_np(sorting, cvals)
            cvals, cvecs = cvals[order], cvecs[:, order]
        self._cvals = cvals[: self._user_nev]
        self._cvecs = cvecs[:, : self._user_nev]
        return len(self._cvals)

    def eigenvalues(self) -> np.ndarray:
        return self._cvals

    def eigenvectors(self, nvec: int | None = None) -> torch.Tensor:
        """The complex eigenvectors (n, nvec) of C on the operator's
        device; over a row-sharded embedding, the rank's rows of n."""
        nvec = len(self._cvals) if nvec is None else min(nvec, len(self._cvals))
        vecs = torch.from_numpy(np.ascontiguousarray(self._cvecs[:, :nvec]))
        if self._mesh is not None:
            vecs = self._mesh.local_rows(vecs)
        return vecs.to(self._device)
