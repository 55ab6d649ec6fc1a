"""Real embedding of complex Hermitian operators.

Port of :mod:`spectra_tpu.matop.herm_embed`. The JAX package needs it
because some TPUs have no complex arithmetic; the card has, so a
Hermitian matrix can go to
:class:`~spectra_tpu_torch.solvers.herm_eigs.HermEigsSolver` directly.
The embedding stays as public surface:

    A = R + iS Hermitian (R symmetric, S antisymmetric)  ->
    E = [[R, -S], [S, R]]  (real symmetric, 2n x 2n)

Each eigenvalue of A appears twice in E: for an A-eigenvector
``z = x + iy``, both ``(x, y)`` and ``(-y, x)`` are E-eigenvectors.
``j_map`` declares ``J(x, y) = (-y, x)``, the realified multiplication
by i, so that :meth:`ArnoldiOp.create` returns a
:class:`~spectra_tpu_torch.matop.arnoldi_op.JStructuredArnoldiOp`,
whose Lanczos factorization orthogonalizes against ``J V`` as well as
V. Without that projection rounding grows duplicate (phantom) Ritz
pairs, and a genuine multiplicity of A cannot be told from the
structural doubling. ``create`` takes ``device``; ``None`` means the
GPU and raises when there is none.
"""

import dataclasses

import torch

from spectra_tpu_torch.matop.dense import _as_tensor, _hermitize


@dataclasses.dataclass(frozen=True, eq=False)
class RealEmbeddedHermMatProd:
    """Real symmetric 2n x 2n embedding of a Hermitian matrix."""

    R: torch.Tensor  # (n, n) real part, symmetric
    S: torch.Tensor  # (n, n) imaginary part, antisymmetric

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        full = _hermitize(_as_tensor(mat, device), uplo)
        if not full.dtype.is_complex:
            return cls(R=full, S=torch.zeros_like(full))
        return cls(R=full.real.contiguous(), S=full.imag.contiguous())

    @property
    def dtype(self):
        return self.R.dtype

    @property
    def device(self):
        return self.R.device

    @property
    def n_orig(self) -> int:
        return self.R.shape[0]

    def rows(self) -> int:
        return 2 * self.R.shape[0]

    def cols(self) -> int:
        return 2 * self.R.shape[0]

    def perform_op(self, v):
        """E v without forming E: four real products on the halves."""
        n = self.R.shape[0]
        x, y = v[:n], v[n:]
        return torch.cat([self.R @ x - self.S @ y, self.S @ x + self.R @ y])

    def diagonal(self):
        d = torch.diagonal(self.R)
        return torch.cat([d, d])

    def j_map(self, v):
        """``J(x, y) = (-y, x)`` on the LAST axis: a vector (2n,) or a
        row-major basis block (m, 2n)."""
        n = self.R.shape[0]
        return torch.cat([-v[..., n:], v[..., :n]], dim=-1)

    def recover_eigenvectors(self, embedded_vecs):
        """Unit complex A-eigenvectors ``z = x + iy`` from the columns of
        E-eigenvectors (2n, k), on their device."""
        n = self.R.shape[0]
        V = torch.as_tensor(embedded_vecs)
        z = torch.complex(V[:n], V[n:])
        norms = torch.linalg.vector_norm(z, dim=0)
        return z / torch.where(norms > 0, norms, torch.ones_like(norms))
