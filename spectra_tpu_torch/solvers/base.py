"""Driver base class for the symmetric IRLM solvers.

Port of :mod:`spectra_tpu.solvers.base` (reference:
include/Spectra/HermEigsBase.h:44-479): validation, the deterministic
starting vector, the restart-chunked driver, result extraction and the
Spectra-compatible accessors. The iteration itself is the host loop of
:mod:`spectra_tpu_torch.solvers._herm_core`: n-length tensors on the
operator's device, the small projected problem on the host in f64.

``eigenvalues()`` returns a numpy array, as in the JAX package;
``eigenvectors()`` returns a tensor on the operator's device.
"""

import numpy as np
import torch

from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp
from spectra_tpu_torch.solvers._herm_core import (
    irlm_compute,
    irlm_finalize,
    irlm_restarts,
    irlm_start,
)
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.dtypes import numpy_dtype
from spectra_tpu_torch.util.rng import SimpleRandom
from spectra_tpu_torch.util.selection import SortRule


def _waits(feature: str, item: int):
    return NotImplementedError(
        f"{feature} waits for its slice of the port: ROADMAP.md item {item}"
    )


class HermEigsBase:
    """Base for the symmetric IRLM solver drivers.

    Subclasses may set ``_ritz_transform`` (a static function
    ``(nu, aux) -> lambda``) and ``_transform_aux`` for an eigenvalue
    back-transform, the reference's ``sort_ritzpair`` override seam.
    """

    _mode = "lanczos"
    _ritz_transform = None

    def __init__(self, op, nev: int, ncv: int, bop=None):
        if op.dtype not in (torch.float32, torch.float64):
            raise _waits("a complex (Hermitian) operator", 14)
        self._op = op
        self._arnop = ArnoldiOp.create(op, bop)
        n = op.rows()
        if op.cols() != n:
            raise ValueError("matrix must be square")
        # reference: HermEigsBase.h:267-271
        if nev < 1 or nev > n - 1:
            raise ValueError("nev must satisfy 1 <= nev <= n - 1, n is the size of matrix")
        if ncv <= nev or ncv > n:
            raise ValueError("ncv must satisfy nev < ncv <= n, n is the size of matrix")
        self._n = n
        self._nev = int(nev)
        self._ncv = int(ncv)
        self._dtype = op.dtype
        self._device = op.device
        self._info = CompInfo.NotComputed
        self._niter = 0
        self._nops = 0
        self._v0 = None
        self._result = None
        self._restart_chunk = None
        self._carry = None
        self._history = []

    # -- options ---------------------------------------------------------
    def set_restart_method(self, method: str):
        """Only ``"implicit"`` (ARPACK-style shifted-QR restarts)."""
        if method == "thick":
            raise _waits("set_restart_method('thick')", 9)
        if method != "implicit":
            raise ValueError("restart method must be 'implicit' or 'thick'")

    def set_reorth(self, method: str):
        """Only ``"full"`` (always-on DGKS re-orthogonalization)."""
        if method == "selective":
            raise _waits("set_reorth('selective')", 9)
        if method != "full":
            raise ValueError("reorth method must be 'full' or 'selective'")

    def set_precision(self, mode: str):
        """Only ``"double"`` (everything in the operator dtype)."""
        if mode == "mixed":
            raise _waits("set_precision('mixed')", 16)
        if mode != "double":
            raise ValueError("precision must be 'double' or 'mixed'")

    def set_matvec_granularity(self, on: bool = True):
        raise _waits("set_matvec_granularity", 9)

    def save_checkpoint(self, path: str):
        raise _waits("save_checkpoint", 9)

    def load_checkpoint(self, path: str):
        raise _waits("load_checkpoint", 9)

    def compute_locked(self, *args, **kwargs):
        raise _waits("compute_locked", 9)

    def set_restart_chunk(self, chunk: int | None):
        """Run the restart loop in segments of at most ``chunk``
        restarts, recording ``convergence_history()`` between segments.
        Results are identical to the single-shot run."""
        self._restart_chunk = None if chunk is None else int(chunk)

    # -- initialization --------------------------------------------------
    def init(self, init_resid=None):
        """Set the initial residual vector (default: the deterministic
        Uniform(-0.5, 0.5) stream with seed 0, bit-identical to the
        reference's SimpleRandom). Accepts numpy arrays and tensors."""
        if init_resid is None:
            init_resid = SimpleRandom(0).random_vec(
                self._n, numpy_dtype(self._dtype)
            )
        v0 = torch.as_tensor(init_resid).to(self._device, self._dtype)
        if v0.shape != (self._n,):
            raise ValueError(f"initial residual must have shape ({self._n},)")
        if torch.linalg.vector_norm(v0).item() < np.finfo(np.float64).tiny * 10:
            raise ValueError("initial residual vector cannot be zero")
        self._v0 = v0
        self._info = CompInfo.NotComputed
        self._niter = 0
        self._nops = 0
        self._result = None

    # -- computation -----------------------------------------------------
    def compute(
        self,
        selection: SortRule = SortRule.LargestMagn,
        maxit: int = 1000,
        tol: float = 1e-10,
        sorting: SortRule = SortRule.LargestAlge,
    ) -> int:
        """Run the solver; returns the number of converged eigenvalues."""
        if self._v0 is None:
            self.init()
        from spectra_tpu_torch.matop.shift_solve import couple_inner_tolerance

        self._arnop = couple_inner_tolerance(self._arnop, tol)
        fixed = dict(
            nev=self._nev, ncv=self._ncv, selection=selection, mode=self._mode
        )
        tol = float(tol)
        if self._restart_chunk is None:
            res = irlm_compute(
                self._arnop, self._v0, 0, int(maxit), tol,
                self._transform_aux(), sorting=sorting,
                transform=type(self)._ritz_transform, **fixed,
            )
            return self._finish_result(res)
        carry = irlm_start(self._arnop, self._v0, 0, tol, **fixed)
        budget = 0
        self._history = []
        while budget < maxit:
            budget = min(budget + self._restart_chunk, maxit)
            carry = irlm_restarts(self._arnop, carry, tol, budget, **fixed)
            beta = carry.state.beta
            self._history.append(
                {"restarts": carry.restarts, "nconv": carry.nconv,
                 "f_norm": beta}
            )
            if carry.nconv >= self._nev or carry.restarts < budget:
                break
            if not np.isfinite(beta):
                break
        self._carry = carry
        res = irlm_finalize(
            carry, self._transform_aux(), nev=self._nev, sorting=sorting,
            transform=type(self)._ritz_transform,
        )
        return self._finish_result(res)

    def _finish_result(self, res) -> int:
        self._result = res
        self._niter = int(res.niter)
        self._nops = int(res.nops)
        if not torch.isfinite(res.values).all():
            self._info = CompInfo.NumericalIssue
            return 0
        self._info = (
            CompInfo.Successful if res.nconv >= self._nev
            else CompInfo.NotConverging
        )
        return min(self._nev, res.nconv)

    def _transform_aux(self):
        return None

    # -- accessors -------------------------------------------------------
    def info(self) -> CompInfo:
        return self._info

    def num_iterations(self) -> int:
        return self._niter

    def num_operations(self) -> int:
        return self._nops

    def convergence_history(self) -> list:
        """Per-segment (restarts, nconv, ||f||) trajectory; populated
        when running with ``set_restart_chunk``."""
        return list(self._history)

    def eigenvalues(self) -> np.ndarray:
        """Converged eigenvalues (real), in the requested sorting order."""
        out = numpy_dtype(self._dtype)
        if self._result is None:
            return np.zeros((0,), out)
        res = self._result
        return res.values[res.conv].numpy().astype(out)

    def eigenvectors(self, nvec: int | None = None) -> torch.Tensor:
        """Eigenvectors of the converged eigenvalues (columns), on the
        operator's device."""
        if self._result is None:
            return torch.zeros(
                (self._n, 0), dtype=self._dtype, device=self._device
            )
        res = self._result
        small = res.vectors_small[:, res.conv]
        if nvec is not None:
            small = small[:, : min(nvec, small.shape[1])]
        # V is (ncv, n) row-major; eigenvectors are columns of V^T S.
        return res.V.mT @ small.to(res.V.device, res.V.dtype)
