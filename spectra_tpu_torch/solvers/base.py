"""Driver base class for the symmetric IRLM solvers.

Port of :mod:`spectra_tpu.solvers.base` (reference:
include/Spectra/HermEigsBase.h:44-479): validation, the deterministic
starting vector, the restart-chunked and stepped drivers, checkpoints,
locking (``compute_locked``), result extraction and the
Spectra-compatible accessors. The iteration itself is the host loop of
:mod:`spectra_tpu_torch.solvers._herm_core`: n-length tensors on the
operator's device, the small projected problem on the host in f64.

``eigenvalues()`` returns a numpy array, as in the JAX package;
``eigenvectors()`` returns a tensor on the operator's device.
"""

import numpy as np
import torch

from spectra_tpu_torch.linalg.krylov import KrylovState
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, LockedArnoldiOp
from spectra_tpu_torch.ops.gemv import basis_apply_block
from spectra_tpu_torch.solvers._herm_core import (
    IRLMResult,
    _LoopCarry,
    irlm_compute,
    irlm_finalize,
    irlm_restarts,
    irlm_start,
)
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.dtypes import numpy_dtype
from spectra_tpu_torch.util.rng import SimpleRandom
from spectra_tpu_torch.util.selection import SortRule, argsort_np, sort_key_np


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
        self._restart_method = "implicit"
        self._reorth = "full"
        self._matvec_granularity = False
        self._carry = None
        self._resume_carry = None
        self._history = []
        self._locking_certified = False
        self._locking_rounds = []

    # -- options ---------------------------------------------------------
    def set_restart_method(self, method: str):
        """``"implicit"`` (default): ARPACK-style shifted-QR restarts,
        rule for rule the reference. ``"thick"``: thick restart
        (TRLan/Krylov-Schur), one host ``eigh`` and one basis rotation
        per restart instead of O(ncv) sequential Givens sweeps; the same
        convergence class."""
        if method not in ("implicit", "thick"):
            raise ValueError("restart method must be 'implicit' or 'thick'")
        self._restart_method = method

    def set_reorth(self, method: str):
        """``"full"`` (default): always-on DGKS re-orthogonalization, rule
        for rule the reference's Lanczos (Lanczos.h:62-187), two (ncv, n)
        projections per step. ``"selective"``: Simon's omega-recurrence
        partial re-orthogonalization; the projections are paid only when
        the O(ncv) host recurrence predicts a loss of orthogonality above
        ``sqrt(eps/ncv)``. Ignored (full re-orthogonalization) under
        thick restarts and in the deflated rounds of
        :meth:`compute_locked`, whose extra couplings the recurrence does
        not model (see ``_eff_mode``)."""
        if method not in ("full", "selective"):
            raise ValueError("reorth method must be 'full' or 'selective'")
        self._reorth = method

    def set_precision(self, mode: str):
        """Only ``"double"`` (everything in the operator dtype)."""
        if mode == "mixed":
            raise _waits("set_precision('mixed')", 16)
        if mode != "double":
            raise ValueError("precision must be 'double' or 'mixed'")

    def _eff_mode(self) -> str:
        """The factorization mode: selective re-orthogonalization only
        with implicit restarts on an undeflated operator. Thick restarts
        leave H an arrowhead, whose couplings the omega recurrence (it
        reads only the two diagonals of H) never sees: it would skip
        needed re-orthogonalizations. Deflated (locked) rounds fall back
        too: the recurrence does not model the deflation projections."""
        if (
            self._mode == "lanczos"
            and self._reorth == "selective"
            and self._restart_method != "thick"
            and not isinstance(self._arnop, LockedArnoldiOp)
        ):
            return "lanczos_selective"
        return self._mode

    def set_matvec_granularity(self, on: bool = True):
        """Bound each segment of the driver to one restart and record a
        ``convergence_history()`` entry after each. In the JAX package
        this replays the iteration as one device execution per operator
        application; here every factorization step already ends with a
        host read of ``||f||``, so the stepped driver is the segmented
        loop of :meth:`compute` with segments of one restart: the same
        primitive sequence, bitwise the same results and counts. It
        honors selective re-orthogonalization and a loaded
        checkpoint."""
        self._matvec_granularity = bool(on)

    def save_checkpoint(self, path: str):
        """Write the iteration state after the last segmented
        ``compute`` (V, H, f and the Ritz bookkeeping, by field name,
        with ``nev``/``ncv``) to the ``.npz`` file ``path``."""
        if self._carry is None:
            raise RuntimeError(
                "no iteration state to checkpoint: run compute() with "
                "set_restart_chunk() or set_matvec_granularity() first"
            )
        c = self._carry
        arrays = {f"state_{k}": v for k, v in c.state._asdict().items()}
        arrays.update((k, v) for k, v in c._asdict().items() if k != "state")
        np.savez(
            path, nev=self._nev, ncv=self._ncv,
            **{k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
               for k, v in arrays.items()},
        )

    def load_checkpoint(self, path: str):
        """Restore the state written by :meth:`save_checkpoint`; the next
        segmented ``compute`` (``set_restart_chunk`` or
        ``set_matvec_granularity``) continues from it. The basis and the
        residual go to the operator's device, the rest stays on the
        host."""
        with np.load(path) as data:
            if int(data["nev"]) != self._nev or int(data["ncv"]) != self._ncv:
                raise ValueError("checkpoint nev/ncv mismatch")
            fields = {k: data[k] for k in data.files}

        def host(name):
            return torch.from_numpy(fields[name])

        state = KrylovState(
            V=host("state_V").to(self._device),
            H=host("state_H"),
            f=host("state_f").to(self._device),
            **{k: fields[f"state_{k}"].item() for k in ("beta", "k", "nops", "seed")},
        )
        self._resume_carry = _LoopCarry(
            state=state,
            **{k: host(k) for k in ("ritz_val", "ritz_est", "ritz_vec", "conv")},
            nconv=int(fields["nconv"]), restarts=int(fields["restarts"]),
        )

    def set_restart_chunk(self, chunk: int | None):
        """Run the restart loop in segments of at most ``chunk``
        restarts, recording ``convergence_history()`` between segments,
        so that the state can be checkpointed. Results are identical to
        the single-shot run."""
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
            nev=self._nev, ncv=self._ncv, selection=selection,
            mode=self._eff_mode(), restart_method=self._restart_method,
        )
        tol = float(tol)
        chunk = 1 if self._matvec_granularity else self._restart_chunk
        if chunk is None and self._resume_carry is None:
            res = irlm_compute(
                self._arnop, self._v0, 0, int(maxit), tol,
                self._transform_aux(), sorting=sorting,
                transform=type(self)._ritz_transform, **fixed,
            )
            return self._finish_result(res)
        if self._resume_carry is not None:
            carry, self._resume_carry = self._resume_carry, None
        else:
            carry = irlm_start(self._arnop, self._v0, 0, tol, **fixed)
        chunk = chunk or maxit
        budget = 0
        self._history = []
        while budget < maxit:
            budget = min(budget + chunk, maxit)
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

    # -- locking / deflated continuation ---------------------------------
    def _internal_ritz_block(self):
        """The converged Ritz vectors of the last ``compute`` as a (q, n)
        row-major orthonormal block on the operator's device."""
        res = self._result
        small = res.vectors_small[:, res.conv]
        return basis_apply_block(res.V, small.to(res.V.device, res.V.dtype))

    def compute_locked(
        self,
        selection: SortRule = SortRule.LargestMagn,
        maxit: int = 1000,
        tol: float = 1e-10,
        sorting: SortRule = SortRule.LargestAlge,
        want: SortRule | None = None,
        max_rounds: int = 6,
        ncv_locked: int | None = None,
    ) -> int:
        """The nev most-wanted eigenpairs counted WITH multiplicity.

        A single restarted Krylov sequence resolves at most one
        direction per eigenplane in exact arithmetic; further copies of a
        degenerate eigenvalue emerge only through rounding, and restart
        compression routinely truncates them (ARPACK, Spectra and plain
        ``compute`` share the limitation; reference regression test
        test/Example1.cpp, issue #144). This driver locks each round's
        converged Ritz vectors (:class:`LockedArnoldiOp`) and re-runs the
        same solver from a fresh deterministic random vector
        (``SimpleRandom(77000 + round)``) in the orthogonal complement,
        where the remaining copies are simple eigenvalues. Rounds stop
        when a deflated run finds nothing more wanted than the current
        nev-th value, beyond the slack ``max(100 tol, 1e4 eps) * scale``
        (then the complement holds no missing member of the wanted set,
        up to the solver tolerance, and :meth:`certified` is True), or
        after ``max_rounds``.

        ``want`` ranks the FINAL (back-transformed) eigenvalues; default
        ``sorting``. E.g. the k smallest by shift-invert: selection
        LargestMagn (of nu), want and sorting SmallestAlge (of lambda).
        ``ncv_locked`` runs the deflated rounds with a smaller Krylov
        space than round 0; it must exceed nev.

        Between rounds the round's (ncv, n) basis is dropped before the
        next round builds its own; only the (q, n) locked blocks stay.
        """
        want = sorting if want is None else want
        if want == SortRule.BothEnds:
            # The frontier test compares scalar sort keys; the
            # interleaved both-ends order has no single boundary key.
            raise ValueError(
                "compute_locked does not support want=BothEnds; run "
                "two certifications (LargestAlge and SmallestAlge)"
            )
        if ncv_locked is not None and ncv_locked <= self._nev:
            raise ValueError("ncv_locked must exceed nev")
        if self._v0 is None:
            self.init()
        base_arnop, base_ncv, base_v0 = self._arnop, self._ncv, self._v0
        vals = None
        blocks = []  # one (q, n) block per round, never concatenated
        niter = nops = 0
        self._locking_certified = False
        self._locking_rounds = []
        try:
            for rnd in range(max_rounds):
                if rnd > 0:
                    if ncv_locked is not None:
                        self._ncv = int(ncv_locked)
                    self._arnop = LockedArnoldiOp(base_arnop, tuple(blocks))
                    self.init(SimpleRandom(77000 + rnd).random_vec(
                        self._n, numpy_dtype(self._dtype)
                    ))
                self.compute(selection, maxit, tol, sorting)
                niter += self._niter
                nops += self._nops
                new_vals = self.eigenvalues().astype(np.float64)
                self._locking_rounds.append(dict(
                    round=rnd, restarts=self._niter, operations=self._nops,
                    nconv=int(self._result.nconv), values=new_vals.tolist(),
                ))
                blk = self._internal_ritz_block() if len(new_vals) else None
                # Drop this round's basis and residual before the next
                # round allocates its own.
                self._carry = None
                self._result = self._result._replace(V=None, f=None)
                if rnd == 0:
                    vals = new_vals
                    if len(vals) == 0:
                        break
                    blocks.append(blk)
                    continue
                if len(new_vals) == 0:
                    break
                # Frontier test: nothing in the deflated complement is
                # more wanted than our nev-th value (ties at the boundary
                # are equally valid copies).
                key_old = np.sort(sort_key_np(want, vals))
                boundary = key_old[self._nev - 1] if len(vals) >= self._nev else np.inf
                key_new = sort_key_np(want, new_vals)
                scale = max(np.abs(key_old).max(), np.abs(key_new).max(), 1.0)
                slack = max(100.0 * tol, 1e4 * dtypes.eps(self._dtype)) * scale
                entered = key_new < boundary - slack
                vals = np.concatenate([vals, new_vals])
                blocks.append(blk)
                if not np.any(entered):
                    self._locking_certified = True
                    break
        finally:
            self._arnop, self._ncv, self._v0 = base_arnop, base_ncv, base_v0

        if vals is None or len(vals) == 0:
            self._result = None
            return 0
        # The wanted nev (with multiplicity) across all rounds, gathered
        # block by block into one (nev, n) block, in ``sorting`` order.
        take = argsort_np(want, vals)[: self._nev]
        wvals = vals[take]
        starts = np.cumsum([0] + [b.shape[0] for b in blocks])
        WX = torch.empty((len(take), self._n), dtype=self._dtype, device=self._device)
        for b, blk in enumerate(blocks):
            for dst, g in enumerate(take):
                if starts[b] <= g < starts[b + 1]:
                    WX[dst] = blk[int(g - starts[b])]
        del blocks
        order = argsort_np(sorting, wvals)
        q = len(wvals)
        res = IRLMResult(
            values=torch.from_numpy(wvals[order]),
            vectors_small=torch.eye(q, dtype=torch.float64)[:, order],
            conv=torch.ones(q, dtype=torch.bool),
            nconv=q, niter=niter, nops=nops,
            V=WX, f=torch.zeros(self._n, dtype=self._dtype, device=self._device),
        )
        return self._finish_result(res)

    def certified(self) -> bool:
        """True when the last :meth:`compute_locked` proved the wanted
        set complete under multiplicity (the frontier test passed)."""
        return self._locking_certified

    def locking_rounds(self) -> list:
        """Per-round restarts, operations, nconv and converged values of
        the last :meth:`compute_locked`."""
        return list(self._locking_rounds)

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
