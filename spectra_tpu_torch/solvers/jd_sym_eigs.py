"""Jacobi-Davidson driver base for symmetric eigenproblems.

Port of :mod:`spectra_tpu.solvers.jd_sym_eigs` (reference:
include/Spectra/JDSymEigsBase.h:34-186). Two routes, chosen as in the
JAX package (:meth:`JDSymEigsBase._use_compiled`):

* the fixed-buffer loop of :mod:`spectra_tpu_torch.solvers._jd_core`,
  the JAX package's compiled route, taken by default;
* the host loop over a growing :class:`SearchSpace` (restart when the
  space exceeds its maximum, extend ``W = A V`` by the new columns,
  Rayleigh-Ritz, sort, converge on residual column norms, correct,
  extend), taken with ``SPECTRA_TPU_JD_DRIVER=host``, for ``BothEnds``,
  for a subclass without ``_correction_kernel`` and for a schedule wider
  than n. The two routes stop differently: only the first keeps the
  best snapshot and a stagnation patience.

The n-length work runs on the operator's device, the small
Rayleigh-Ritz on the host. Subclasses implement
``setup_initial_search_space(selection)`` and
``calculate_correction_vector()``, the reference's CRTP seam.
"""

import os

import torch

from spectra_tpu_torch.linalg import ritz_pairs as rp
from spectra_tpu_torch.linalg.search_space import SearchSpace
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.selection import SortRule

_STATUS = {1: CompInfo.Successful, 2: CompInfo.NotConverging, 3: CompInfo.NumericalIssue}


def _route() -> str:
    mode = os.environ.get("SPECTRA_TPU_JD_DRIVER", "auto")
    if mode not in ("auto", "host"):
        raise ValueError(f"SPECTRA_TPU_JD_DRIVER={mode!r}: use 'auto' or 'host'")
    return mode


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
        self._search_space = SearchSpace(getattr(op, "mesh", None))
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

    #: The correction as a function ``(vals_c, residues_c, aux)`` for the
    #: fixed-buffer route; None sends a subclass to the host loop.
    _correction_kernel = None

    def _correction_aux(self):
        return None

    # -- the fixed-buffer route (solvers/_jd_core.py) ---------------------
    def _use_compiled(self, selection: SortRule) -> bool:
        if _route() == "host":
            return False
        if type(self)._correction_kernel is None:
            return False
        if selection == SortRule.BothEnds:
            # the interleave permutation depends on the width: host loop
            return False
        i0, c, M = (
            self._initial_search_space_size,
            self._correction_size,
            self._max_search_space_size,
        )
        if i0 < self._nev or c < 1:
            return False
        top = i0
        while top <= M:
            top += c
        return top <= self._op.rows()

    def _compute_compiled(self, initial_space, selection, maxit, tol) -> int:
        from spectra_tpu_torch.solvers._jd_core import jd_compute

        res = jd_compute(
            self._op, initial_space, self._correction_aux(), int(maxit), float(tol),
            max_space=self._max_search_space_size,
            i0=self._initial_search_space_size, c=self._correction_size,
            nev=self._nev, selection=selection,
            correction_fn=type(self)._correction_kernel,
        )
        self._niter, self._nops = res.niter, res.nops
        self._info = _STATUS.get(res.status, CompInfo.NotComputed)
        self._ritz_pairs = rp.RitzPairs(
            values=res.values, small_vectors=None, vectors=res.vectors,
            residues=res.residues,
        )
        return int(res.conv.sum())

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
        rank's rows; either route then reduces over the mesh."""
        initial_space = torch.as_tensor(initial_space)
        mesh = getattr(self._op, "mesh", None)
        if mesh is not None and initial_space.shape[0] == self._op.rows():
            initial_space = mesh.local_rows(initial_space)
        initial_space = initial_space.to(self._device).contiguous()
        if self._use_compiled(selection):
            return self._compute_compiled(initial_space, selection, maxit, tol)
        ss = self._search_space
        ss.initialize_search_space(initial_space)
        self._niter = 0
        conv_flags = torch.zeros(self._nev, dtype=torch.bool)
        for it in range(maxit):
            with span("jd.iteration"):
                self._niter = it + 1
                if ss.size > self._max_search_space_size:
                    with span("jd.collapse"):
                        ss.restart(self._ritz_pairs, self._initial_search_space_size)
                with span("jd.apply"):
                    ss.update_operator_basis_product(self._op)
                self._nops = ss.nops
                with span("jd.rayleigh_ritz"):
                    pairs = rp.compute_eigen_pairs(ss.V, ss.W, mesh)
                    finite = bool(torch.isfinite(pairs.values).all())
                    if finite:
                        pairs = rp.sort(pairs, selection)
                if not finite:
                    self._info = CompInfo.NumericalIssue
                    break
                self._ritz_pairs = pairs
                with span("jd.residual"):
                    conv_flags, converged = rp.convergence(pairs, tol, self._nev, mesh)
                if converged:
                    self._info = CompInfo.Successful
                    break
                if it == maxit - 1:
                    self._info = CompInfo.NotConverging
                    break
                with span("jd.correction"):
                    corrections = self.calculate_correction_vector()
                with span("jd.orthogonalize"):
                    ss.extend_basis(corrections)
        return int(conv_flags.sum())
