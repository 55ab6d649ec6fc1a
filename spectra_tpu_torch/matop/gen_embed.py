"""Real embedding of general complex operators.

Port of :mod:`spectra_tpu.matop.gen_embed`. The JAX package needs it
because some TPUs have no complex arithmetic; the card has, so a
complex matrix can go to :class:`~spectra_tpu_torch.solvers.gen_eigs.GenEigsSolver`
directly. The embedding stays as public surface:

    C = A + iB  ->  M = [[A, -B], [B, A]]   (real, 2n x 2n)

* spec(M) = spec(C) u conj(spec(C)).
* For an M-eigenpair ``(lam, w)`` with ``w = [p; q]``, ``z = p + iq``
  satisfies ``C z = lam z``, unless ``lam`` belongs only to the
  conjugate copy, and then ``z ~ 0`` (a *phantom*). With
  J = [[0, -I], [I, 0]] (multiplication by i, which commutes with M),
  ``w -> p + iq`` projects onto J's +i eigenspace, where M acts as C.
* So each eigenpair of C takes TWO slots of M's spectrum: k pairs of C
  come from a 2k-pair real solve, phantom filtering and J-orbit
  deduplication (Jw = iw maps to the same complex direction).

:class:`~spectra_tpu_torch.solvers.gen_eigs.GenEigsSolver` routes
here when handed a :class:`RealEmbeddedGenMatProd`. Constructors take
``device``; ``None`` means the GPU and raises when there is none.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.util.capabilities import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class RealEmbeddedGenMatProd:
    """The real 2n x 2n embedding of a general complex matrix.

    ``inner`` is the real operator: :class:`_DenseEmbeddedBlocks` (four
    real products, no 2n matrix) for dense input, or a
    :class:`~spectra_tpu_torch.matop.sparse.SparseGenMatProd` over the
    assembled real 2n sparse matrix for scipy sparse input.
    """

    inner: object
    n_orig: int

    @classmethod
    def create(cls, mat, device=None):
        from spectra_tpu_torch.matop.sparse import SparseGenMatProd

        if hasattr(mat, "tocsr"):  # scipy sparse
            import scipy.sparse as sps

            csr = mat.tocsr()
            n = csr.shape[0]
            Ar = csr.real.tocsr()
            Ai = (
                csr.imag.tocsr() if np.iscomplexobj(csr.data)
                else sps.csr_matrix((n, n))
            )
            M = sps.bmat([[Ar, -Ai], [Ai, Ar]], format="csr")
            return cls(inner=SparseGenMatProd.create(M, device=device), n_orig=n)
        full = mat.cpu().numpy() if torch.is_tensor(mat) else np.asarray(mat)
        device = resolve_device(device)
        return cls(
            inner=_DenseEmbeddedBlocks(
                R=torch.from_numpy(np.real(full).astype(np.float64)).to(device),
                S=torch.from_numpy(np.imag(full).astype(np.float64)).to(device),
            ),
            n_orig=full.shape[0],
        )

    @property
    def dtype(self):
        return self.inner.dtype  # real: the solver runs the real IRAM

    @property
    def device(self):
        return self.inner.device

    @property
    def mesh(self):
        """The row mesh of a row-sharded ``inner`` (over the 2n rows), else
        None: the solver then reduces over it and gathers its Ritz
        vectors before :meth:`map_ritz_pairs`."""
        return getattr(self.inner, "mesh", None)

    def rows(self) -> int:
        return 2 * self.n_orig

    def cols(self) -> int:
        return 2 * self.n_orig

    def perform_op(self, v):
        return self.inner.perform_op(v)

    def map_ritz_pairs(self, vals, vecs, phantom_rtol=1e-4, dedupe_overlap=0.99):
        """Embedded Ritz pairs -> eigenpairs of C, on the host.

        ``vals`` (m,) complex Ritz values of M, ``vecs`` (2n, m) complex
        unit Ritz vectors (numpy). Returns the surviving ``(cvals,
        cvecs)`` after phantom filtering (``||p + iq|| <= phantom_rtol *
        sqrt(2)`` drops) and duplicate removal (same value and same
        complex direction)."""
        n = self.n_orig
        vals, vecs = np.asarray(vals), np.asarray(vecs)
        z = vecs[:n, :] + 1j * vecs[n:, :]
        norms = np.linalg.norm(z, axis=0)
        keep = norms > phantom_rtol * np.sqrt(2.0)
        vals, z = vals[keep], z[:, keep] / norms[keep][None, :]
        out = []
        scale = max(1.0, float(np.abs(vals).max()) if len(vals) else 1.0)
        for i in range(len(vals)):
            if not any(
                abs(vals[i] - vj) <= 1e-7 * scale
                and abs(np.vdot(zj, z[:, i])) >= dedupe_overlap
                for vj, zj in out
            ):
                out.append((vals[i], z[:, i]))
        if not out:
            return np.zeros(0, np.complex128), np.zeros((n, 0), np.complex128)
        return (np.array([v for v, _ in out]),
                np.stack([zz for _, zz in out], axis=1))


@dataclasses.dataclass(frozen=True, eq=False)
class RotatedEmbeddedGenMatProd:
    """The realification of ``C' = -i C`` over an embedding:
    ``M' = (-J) M``, one block swap per product, no new matrix. C' has
    C's eigenvectors with ``lambda' = -i lambda``, so Largest/Smallest
    REAL on C' is Largest/Smallest IMAG on C: the rotation that makes
    the imaginary-part rules well-posed on the embedding's
    conjugate-symmetric spectrum."""

    embed: RealEmbeddedGenMatProd

    @property
    def dtype(self):
        return self.embed.dtype

    @property
    def device(self):
        return self.embed.device

    @property
    def mesh(self):
        return self.embed.mesh

    @property
    def n_orig(self) -> int:
        return self.embed.n_orig

    def rows(self) -> int:
        return self.embed.rows()

    def cols(self) -> int:
        return self.embed.cols()

    def perform_op(self, v):
        from spectra_tpu_torch.matop.internal_ops import whole_rows

        n = self.embed.n_orig
        # -J w = (w_bottom, -w_top); on a row mesh the halves are on other
        # ranks, so the swap runs on the gathered w
        return whole_rows(lambda w: torch.cat([w[..., n:], -w[..., :n]], dim=-1),
                          self.embed.perform_op(v), self.mesh)


@dataclasses.dataclass(frozen=True, eq=False)
class _DenseEmbeddedBlocks:
    """M v by four real products without the 2n matrix (the flops of
    one complex product)."""

    R: torch.Tensor  # (n, n) real part
    S: torch.Tensor  # (n, n) imaginary part

    @property
    def dtype(self):
        return self.R.dtype

    @property
    def device(self):
        return self.R.device

    def rows(self) -> int:
        return 2 * self.R.shape[0]

    def cols(self) -> int:
        return 2 * self.R.shape[0]

    def perform_op(self, v):
        n = self.R.shape[0]
        x, y = v[..., :n], v[..., n:]
        top = x @ self.R.mT - y @ self.S.mT
        bot = x @ self.S.mT + y @ self.R.mT
        return torch.cat([top, bot], dim=-1)
