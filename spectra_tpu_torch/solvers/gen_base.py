"""Driver base for the general (non-symmetric) eigensolvers.

Port of :mod:`spectra_tpu.solvers.gen_base` (reference: the GenEigsBase
driver shell, include/Spectra/GenEigsBase.h:150-612): the bounds
``1 <= nev <= n-2`` and ``nev+2 <= ncv <= n`` (GenEigsBase.h:419-423),
the deterministic start, the implicit and Krylov-Schur restarts, the
restart-chunked loop, the native dense route, and complex Ritz output.

The iteration is the host loop of
:mod:`spectra_tpu_torch.solvers._gen_core` (or
:mod:`~spectra_tpu_torch.solvers._gen_ks`): n-length tensors on the
operator's device, the (ncv, ncv) problem on the host. The JAX
package's second driver, a host loop for TPUs without complex
arithmetic (``SPECTRA_TPU_GEN_DRIVER``), has no counterpart: the card
has complex arithmetic and the port's one loop is already host-driven.

``eigenvalues()`` returns a numpy complex array; ``eigenvectors()`` a
complex tensor on the operator's device.
"""

import numpy as np
import torch

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
from spectra_tpu_torch.solvers._gen_core import (
    iram_compute,
    iram_finalize,
    iram_restarts,
    iram_start,
)
from spectra_tpu_torch.solvers.base import HermEigsBase
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.selection import SortRule


class GenEigsBase(HermEigsBase):
    """Base for the IRAM (Arnoldi) solver drivers; Ritz values complex."""

    _mode = "arnoldi"
    _ritz_transform = None

    def __init__(self, op, nev: int, ncv: int, bop=None):
        n = op.rows()
        if op.cols() != n:
            raise ValueError("matrix must be square")
        # reference: GenEigsBase.h:419-423
        if nev < 1 or nev > n - 2:
            raise ValueError("nev must satisfy 1 <= nev <= n - 2, n is the size of matrix")
        if ncv < nev + 2 or ncv > n:
            raise ValueError("ncv must satisfy nev + 2 <= ncv <= n, n is the size of matrix")
        # Does not call HermEigsBase.__init__ (as in the JAX package): the
        # bounds differ, and a complex operator is welcome here.
        self._op = op
        self._has_bop = bop is not None
        self._arnop = ArnoldiOp.create(op, bop)
        self._n = n
        self._mesh = self._arnop.mesh
        self._n_local = n if self._mesh is None else self._mesh.rows_per(n)
        self._nev = int(nev)
        self._ncv = int(ncv)
        self._dtype = op.dtype
        self._device = op.device
        self._info = CompInfo.NotComputed
        self._niter = 0
        self._nops = 0
        self._v0 = None
        self._v0_host = None
        self._result = None
        self._restart_chunk = None
        self._restart_method = "implicit"
        self._matvec_granularity = False
        self._carry = None
        self._resume_carry = None
        self._history = []
        self._locking_round = False

    def set_matvec_granularity(self, on: bool = True):
        """Bound each segment of the driver to one restart, with a
        ``convergence_history()`` entry after each. In the JAX package
        this replays the iteration as one device execution per operator
        application; here every Arnoldi step already reads ``||f||`` on
        the host, so the stepped driver runs the same primitive sequence:
        bitwise the same results and counts."""
        self._matvec_granularity = bool(on)

    def set_restart_method(self, method: str):
        """``"implicit"`` (default): ARPACK-style shifted-QR restarts,
        rule for rule the reference (GenEigsBase.h:44-140).
        ``"krylov_schur"``: Stewart's direct restart, an ordered real
        Schur form of the Rayleigh matrix and one basis truncation
        (:mod:`spectra_tpu_torch.solvers._gen_ks`); real dtypes only."""
        if method not in ("implicit", "krylov_schur"):
            raise ValueError("restart method must be 'implicit' or 'krylov_schur'")
        self._restart_method = method

    def compute(
        self,
        selection: SortRule = SortRule.LargestMagn,
        maxit: int = 1000,
        tol: float = 1e-10,
        sorting: SortRule = SortRule.LargestMagn,
    ) -> int:
        """Run the solver; returns the number of converged eigenvalues."""
        if self._v0 is None:
            self.init()
        from spectra_tpu_torch.matop.shift_solve import couple_inner_tolerance
        from spectra_tpu_torch.solvers import _native_dense

        self._arnop = couple_inner_tolerance(self._arnop, tol)
        if _native_dense.eligible(self, sym=False):
            res = _native_dense.compute(self, False, selection, maxit, tol, sorting)
            if res is not None:
                return self._finish_result(res)
        transform = type(self)._ritz_transform
        if self._restart_method == "krylov_schur":
            from spectra_tpu_torch.solvers._gen_ks import iram_compute_ks

            return self._finish_result(iram_compute_ks(
                self._arnop, self._v0, 0, int(maxit), float(tol),
                self._transform_aux(), nev=self._nev, ncv=self._ncv,
                selection=selection, sorting=sorting, transform=transform,
            ))
        fixed = dict(nev=self._nev, ncv=self._ncv, selection=selection)
        tol = float(tol)
        chunk = 1 if self._matvec_granularity else self._restart_chunk
        if chunk is None:
            return self._finish_result(iram_compute(
                self._arnop, self._v0, 0, int(maxit), tol,
                self._transform_aux(), sorting=sorting, transform=transform,
                **fixed,
            ))
        carry = iram_start(self._arnop, self._v0, 0, tol, **fixed)
        budget = 0
        self._history = []
        while budget < maxit:
            budget = min(budget + chunk, maxit)
            carry = iram_restarts(self._arnop, carry, tol, budget, **fixed)
            self._history.append(
                {"restarts": carry.restarts, "nconv": carry.nconv,
                 "f_norm": carry.state.beta}
            )
            if carry.nconv >= self._nev or carry.restarts < budget:
                break
        return self._finish_result(iram_finalize(
            carry, self._transform_aux(), nev=self._nev, sorting=sorting,
            transform=transform,
        ))

    def _finish_result(self, res) -> int:
        self._result = res
        self._niter = int(res.niter)
        self._nops = int(res.nops)
        if not np.all(np.isfinite(res.values)):
            self._info = CompInfo.NumericalIssue
            return 0
        self._info = (
            CompInfo.Successful if res.nconv >= self._nev else CompInfo.NotConverging
        )
        return min(self._nev, int(res.nconv))

    def eigenvalues(self) -> np.ndarray:
        """Converged eigenvalues (complex), in sorted order."""
        if self._result is None:
            return np.zeros((0,), np.complex128)
        res = self._result
        return res.values[res.conv]

    def eigenvectors(self, nvec: int | None = None) -> torch.Tensor:
        """Eigenvectors of the converged eigenvalues (complex columns), on
        the operator's device."""
        if self._result is None:
            cdtype = self._dtype if self._dtype.is_complex else self._dtype.to_complex()
            return torch.zeros((self._n_local, 0), dtype=cdtype, device=self._device)
        res = self._result
        small = res.vectors_small[:, res.conv]
        if nvec is not None:
            small = small[:, : min(nvec, small.shape[1])]
        V = res.V
        small = torch.from_numpy(np.ascontiguousarray(small))
        # V is (ncv, n) row-major; eigenvectors are columns of V^T S.
        if V.is_complex():
            return V.mT @ small.to(V.device, V.dtype)
        re = small.real.to(V.device, V.dtype)
        im = small.imag.to(V.device, V.dtype)
        return torch.complex(V.mT @ re, V.mT @ im)
