"""Search space of the Jacobi-Davidson host loop.

Port of :mod:`spectra_tpu.linalg.search_space` (reference:
include/Spectra/LinAlg/SearchSpace.h:20-92): the orthonormal basis V
and ``W = A V`` on the operator's device. The operator touches only
the columns added since the last product (SearchSpace.h:57-63); a
restart collapses to the leading Ritz vectors (:70-74); an extension
appends correction vectors orthogonalized twice (:80-85). Over a
row-sharded operator V and W hold the rank's rows and the extension's
projections and QR run through ``mesh``.
"""

import torch

from spectra_tpu_torch.linalg import ritz_pairs as rp
from spectra_tpu_torch.linalg.orthogonalization import twice_is_enough


class SearchSpace:
    """The JD basis V (n, m) and product W, held between iterations."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.V = None  # (n, m) orthonormal basis
        self.W = None  # (n, m_op): the operator on the first m_op columns
        self.nops = 0  # operator column applications

    @property
    def size(self) -> int:
        return 0 if self.V is None else self.V.shape[1]

    def initialize_search_space(self, initial_space):
        self.V = initial_space
        self.W = None
        self.nops = 0

    def update_operator_basis_product(self, op):
        """``W <- [W, A V_new]``: only the new columns meet the operator."""
        n_done = 0 if self.W is None else self.W.shape[1]
        if n_done == self.size:
            return
        new = op.perform_op(self.V[:, n_done:])
        self.nops += new.shape[1]
        self.W = new if self.W is None else torch.cat([self.W, new], dim=1)

    def restart(self, pairs: rp.RitzPairs, new_size: int):
        """Collapse to the leading ``new_size`` Ritz vectors."""
        self.V = pairs.vectors[:, :new_size]
        self.W = self.W @ pairs.small_vectors[:, :new_size]

    def extend_basis(self, corrections):
        """Append the correction vectors, orthogonalized."""
        n_locked = self.size
        self.V = twice_is_enough(
            torch.cat([self.V, corrections], dim=1), n_locked, self.mesh
        )
