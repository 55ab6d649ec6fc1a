"""Shift-solve operators: ``y = (A - sigma I)^{-1} x``.

Port of :mod:`spectra_tpu.matop.shift_solve` (reference:
include/Spectra/MatOp/DenseSymShiftSolve.h:33-110,
DenseGenRealShiftSolve.h:29-104, DenseGenComplexShiftSolve.h:30-118,
SparseSymShiftSolve.h, SparseGenRealShiftSolve.h,
SparseGenComplexShiftSolve.h:32-124). Following the reference's API,
an operator is created unshifted and ``set_shift`` builds the solver
for ``A - sigma I``, returning a new operator.

:class:`DenseSymShiftSolve` and :class:`DenseHermShiftSolve` factor the
dense matrix with the Bunch-Kaufman LDL^H of
:mod:`spectra_tpu_torch.linalg.bkldlt` on the matrix's device; each
``perform_op`` is two triangular solves there.
:class:`DenseGenRealShiftSolve` and :class:`DenseGenComplexShiftSolve`
factor by partial-pivot LU (``torch.linalg.lu_factor_ex``) on the
matrix's device, as the JAX package does with
``jax.scipy.linalg.lu_factor``; the complex-shift operator returns the
real part of a complex solve (the reference's real-part trick).

Methods of the sparse shift-solves (:class:`SparseSymShiftSolve`,
:class:`SparseGenRealShiftSolve`, :class:`SparseGenComplexShiftSolve`):

* ``"splu"``: one host SuperLU factorization of ``A - sigma I`` (scipy);
  each ``perform_op`` copies the right-hand side to the host, solves and
  copies the result back to its device (the JAX package bridges the
  same call with ``jax.pure_callback``).
* ``"cg"``: conjugate gradients in plain torch, with
  ``jax.scipy.sparse.linalg.cg``'s stopping rule (:func:`cg`).
* ``"bicgstab"``: BiCGStab in plain torch, with the recurrence and the
  stopping rule of ``jax.scipy.sparse.linalg.bicgstab``
  (:func:`bicgstab`); the solve of the general (non-symmetric) shifted
  systems on the device.
* ``"minres"``: :mod:`spectra_tpu_torch.linalg.minres`, optionally
  preconditioned (``precond="jacobi"``/``"cheb"``,
  :mod:`spectra_tpu_torch.matop.precond`). On a grid stencil it first
  tries the multigrid upgrade, as in the JAX package.
* ``"cheb"``: the Chebyshev semi-iteration for SPD shifted systems
  (:mod:`spectra_tpu_torch.linalg.cheb_solve`), its interval estimated
  and learned once at build time.
* ``"mg"``: geometric multigrid (:mod:`spectra_tpu_torch.linalg.multigrid`),
  trial-validated at build time, MINRES when it does not validate.
* ``"auto"``: ``"splu"`` (the port can always reach the host).

"cg", "minres", "cheb" and "mg" need a symmetric shifted matrix, so the
general shift-solves take "splu" and "bicgstab" only.

The iterative methods keep their matrix on the device (DIA, hi/lo DIA or
ELL, :func:`dia_device_from_scipy`; a complex matrix is ELL), couple
their tolerance to the outer one (:func:`couple_inner_tolerance`), and
NaN-poison a solve whose backward error is too large
(:func:`_poison_if_unconverged`).
"""

import dataclasses
import time
import warnings

import numpy as np
import torch

from spectra_tpu_torch.linalg import bkldlt
from spectra_tpu_torch.matop.arnoldi_op import ArnoldiOp, LockedArnoldiOp
from spectra_tpu_torch.matop.dense import _as_tensor, _hermitize, _symmetrize
from spectra_tpu_torch.ops.gemv import vec_dot, vec_norm
from spectra_tpu_torch.sparse.formats import symmetrize_scipy
from spectra_tpu_torch.util.capabilities import resolve_device
from spectra_tpu_torch.util.dtypes import eps as dtype_eps


class ShiftFactorizationError(RuntimeError):
    """``A - sigma I`` (or ``A - sigma B``) is singular (the reference
    throws std::invalid_argument, SymShiftInvert.h:225-226)."""


@dataclasses.dataclass(frozen=True, eq=False)
class DenseSymShiftSolve:
    """``(A - sigma I)^{-1} x`` for dense real symmetric A by BKLDLT
    (reference: DenseSymShiftSolve.h:13,51,86). ``create(mat, uplo,
    device=...)``; ``set_shift`` factors on the matrix's device."""

    mat: torch.Tensor
    factors: object = None  # BKFactors, or None before set_shift

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        return cls(mat=_symmetrize(_as_tensor(mat, device), uplo))

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def rows(self) -> int:
        return self.mat.shape[0]

    def cols(self) -> int:
        return self.mat.shape[1]

    def set_shift(self, sigma):
        fac = bkldlt.factorize(self.mat, sigma)
        if not fac.ok:
            raise ShiftFactorizationError(
                "factorization failed: sigma is an eigenvalue of the "
                "matrix, or the matrix has a non-finite entry"
            )
        return dataclasses.replace(self, factors=fac)

    def perform_op(self, x):
        return bkldlt.solve(self.factors, x)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseHermShiftSolve(DenseSymShiftSolve):
    """``(A - sigma I)^{-1} x`` for dense complex Hermitian A (sigma
    real) by the Hermitian BKLDLT; ``create(mat, uplo, device=...)``."""

    @classmethod
    def create(cls, mat, uplo: str = "L", device=None):
        return cls(mat=_hermitize(_as_tensor(mat, device), uplo))


def _lu_factor(M):
    """Partial-pivot LU of M on its device; a zero or non-finite pivot
    raises :class:`ShiftFactorizationError`."""
    lu, piv, _ = torch.linalg.lu_factor_ex(M)
    if bool((lu.diagonal() == 0).any() | ~torch.isfinite(lu).all()):
        raise ShiftFactorizationError(
            "factorization failed: sigma is an eigenvalue of the matrix"
        )
    return lu, piv


def _lu_solve(lu, piv, x):
    """``M^{-1} x`` for a vector or a block of columns ``x``."""
    if x.ndim == 1:
        return torch.linalg.lu_solve(lu, piv, x.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.lu_solve(lu, piv, x)


class _DenseLUShiftBase:
    """The dense matrix, its LU factors after ``set_shift``, and the
    operator accessors of the two dense general shift-solves."""

    @classmethod
    def create(cls, mat, device=None):
        return cls(mat=_as_tensor(mat, device))

    @property
    def dtype(self):
        return self.mat.dtype  # real for the complex shift: Re(solve)

    @property
    def device(self):
        return self.mat.device

    def rows(self) -> int:
        return self.mat.shape[0]

    def cols(self) -> int:
        return self.mat.shape[1]


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGenRealShiftSolve(_DenseLUShiftBase):
    """``(A - sigma I)^{-1} x`` for a dense general A by partial-pivot LU
    on the matrix's device (reference: DenseGenRealShiftSolve.h:47).
    ``create(mat, device=...)``."""

    mat: torch.Tensor
    lu: object = None
    piv: object = None

    def set_shift(self, sigma):
        n = self.mat.shape[0]
        eye = torch.eye(n, dtype=self.mat.dtype, device=self.mat.device)
        lu, piv = _lu_factor(self.mat - sigma * eye)
        return DenseGenRealShiftSolve(mat=self.mat, lu=lu, piv=piv)

    def perform_op(self, x):
        return _lu_solve(self.lu, self.piv, x)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGenComplexShiftSolve(_DenseLUShiftBase):
    """``Re[(A - (sr + si i) I)^{-1} x]`` for a dense general real A: the
    real-part operator of the complex-shift solver (reference:
    DenseGenComplexShiftSolve.h:50-54,108), its complex LU on the
    matrix's device. ``create(mat, device=...)``."""

    mat: torch.Tensor
    lu: object = None
    piv: object = None

    def set_shift(self, sigmar, sigmai):
        n = self.mat.shape[0]
        cdtype = self.mat.dtype.to_complex()
        eye = torch.eye(n, dtype=cdtype, device=self.mat.device)
        lu, piv = _lu_factor(self.mat.to(cdtype) - complex(sigmar, sigmai) * eye)
        return DenseGenComplexShiftSolve(mat=self.mat, lu=lu, piv=piv)

    def perform_op(self, x):
        y = _lu_solve(self.lu, self.piv, x.to(self.lu.dtype))
        return y.real.contiguous()


#: Inner/outer tolerance coupling: the inner solve targets a relative
#: residual two decades below the outer eigenpair tolerance, floored at
#: 50 eps of the working dtype.
INNER_TOL_FACTOR = 1e-2
INNER_TOL_EPS_FLOOR = 50.0


def coupled_inner_rtol(outer_tol: float, work_dtype) -> float:
    return max(INNER_TOL_EPS_FLOOR * dtype_eps(work_dtype),
               INNER_TOL_FACTOR * float(outer_tol))


def couple_inner_tolerance(obj, outer_tol: float):
    """``obj`` (an operator, or an :class:`ArnoldiOp` or
    :class:`LockedArnoldiOp` around one) with every iterative shift-solve
    inside it whose inner tolerance the user did not pin rebuilt with
    :func:`coupled_inner_rtol` of ``outer_tol``. Composed operators (the
    generalized modes') are searched through their dataclass fields;
    an operator with nothing to couple is returned as it is. The solver
    drivers call it on every ``compute``, locked rounds included: a
    stale loose coupling from an earlier ``compute(tol=coarse)`` would
    converge on a perturbed operator and report ``Successful`` with
    wrong eigenvalues."""
    if isinstance(obj, LockedArnoldiOp):
        inner = couple_inner_tolerance(obj.inner, outer_tol)
        return obj if inner is obj.inner else LockedArnoldiOp(inner, obj.locked)
    if isinstance(obj, ArnoldiOp):
        op = couple_inner_tolerance(obj.op, outer_tol)
        bop = couple_inner_tolerance(obj.bop, outer_tol)
        return obj if op is obj.op and bop is obj.bop else type(obj)(op, bop)
    if isinstance(obj, SparseShiftSolveBase):
        if obj.method != "splu" and not obj.inner_rtol_user:
            return dataclasses.replace(
                obj, inner_rtol=coupled_inner_rtol(outer_tol, obj.shifted.dtype)
            )
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for field in dataclasses.fields(obj):
            value = getattr(obj, field.name)
            new = couple_inner_tolerance(value, outer_tol)
            if new is not value:
                changes[field.name] = new
        if changes:
            return dataclasses.replace(obj, **changes)
    return obj


def _poison_if_unconverged(mv, y, b, op_norm: float, accept_bw=1e-10,
                           mesh=None):
    """``y``, or NaNs where the solve's backward error
    ``|b - A y| / (|A| |y| + |b|)`` exceeds ``accept_bw``, so a failed
    inner solve surfaces as ``CompInfo.NumericalIssue`` instead of wrong
    eigenpairs. ``op_norm`` is any upper bound on |A| (Gershgorin,
    computed once at build time). One SpMV, no host sync; on a row mesh
    the norms are all-reduced, so every rank keeps or poisons alike."""
    bnorm = vec_norm(b, mesh)
    resid = vec_norm(mv(y) - b, mesh)
    scale = op_norm * vec_norm(y, mesh) + torch.clamp(bnorm, min=1e-300)
    return torch.where(resid <= accept_bw * scale, y, torch.full_like(y, torch.nan))


def cg(matvec, b, tol=1e-5, maxiter=None):
    """Conjugate gradients from x0 = 0 with the stopping rule of
    ``jax.scipy.sparse.linalg.cg`` (``atol=0``): run while
    ``r.r > tol^2 b.b`` and fewer than ``maxiter`` (default 10 n) steps.
    A host loop: one scalar read per step."""
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    atol2 = tol * tol * float(vec_dot(b, b).real)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = vec_dot(r, r).real
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = matvec(p)
        alpha = gamma / vec_dot(p, Ap).real
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = vec_dot(r, r).real
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def bicgstab(matvec, b, tol=1e-5, maxiter=None):
    """BiCGStab from x0 = 0 with the recurrence and the stopping rule of
    ``jax.scipy.sparse.linalg.bicgstab`` (``atol=0``, no
    preconditioner): run while ``r.r > tol^2 b.b``, fewer than
    ``maxiter`` (default 10 n) steps, and no breakdown (``rho``,
    ``alpha`` or ``omega`` exactly 0 ends the loop after that step's
    update, as the JAX package's negative step count does). Each step
    applies the operator twice and reads ``r.r`` and the breakdown flag
    to the host in one read. Real or complex."""
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    atol2 = tol * tol * float(vec_dot(b, b).real)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = p = q = r
    alpha = omega = rho = torch.ones((), dtype=b.dtype, device=b.device)
    rs = float(vec_dot(r, r).real)
    k = 0
    while rs > atol2 and k < maxiter:
        rho_ = vec_dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        q = matvec(p)
        alpha_ = rho_ / vec_dot(rhat, q)
        s = r - alpha_ * q
        exit_early = vec_dot(s, s).real < atol2
        t = matvec(s)
        omega_ = vec_dot(t, s) / vec_dot(t, t)
        x = torch.where(exit_early, x + alpha_ * p, x + (alpha_ * p + omega_ * s))
        r = torch.where(exit_early, s, s - omega_ * t)
        rho, alpha, omega = rho_, alpha_, omega_
        broke = (omega_ == 0) | (alpha_ == 0) | (rho_ == 0)
        rr = vec_dot(r, r).real
        rs, stop = torch.stack([rr, broke.to(rr.dtype)]).tolist()
        if stop:
            break
        k += 1
    return x


class _HostLUSolver:
    """A scipy SuperLU factor; solves on the host and returns the result
    on the right-hand side's device."""

    __slots__ = ("splu", "n", "np_dtype")

    def __init__(self, splu, n, np_dtype):
        self.splu = splu
        self.n = n
        self.np_dtype = np_dtype

    def __call__(self, b):
        host = b.detach().cpu().numpy().astype(self.np_dtype, copy=False)
        return torch.from_numpy(self.splu.solve(host)).to(b.device)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseShiftSolveBase:
    """The sparse ``(A - sigma I)^{-1}`` operator.

    ``method="splu"``: ``solver`` holds the host factorization.
    ``method="cg"``/``"bicgstab"``/``"minres"``/``"cheb"``/``"mg"``:
    ``shifted`` holds the device matrix of ``A - sigma I`` and the solve
    is an inner iteration, its tolerance ``inner_rtol`` (``None`` until a
    driver couples it; ``inner_rtol_user`` when the user pinned it).
    ``out_real``: ``perform_op`` returns the real part of the (complex)
    solve, the complex-shift solver's operator.
    ``op_norm`` is the Gershgorin bound of ``shifted``, computed once.
    ``build_s`` holds the host seconds of the build's parts (``dia``:
    the device matrix, ``hierarchy`` and ``trial``: the multigrid
    hierarchy and its trial solves, ``interval``: the Chebyshev interval).
    """

    shifted: object  # device matrix of A - sigma I (None for splu)
    solver: object
    n: int
    method: str
    out_real: bool = False
    inner_rtol: object = None
    precond: str = "none"
    cheb_degree: int = 16
    cheb_interval: object = None  # (alpha, beta) floats, or None
    mg: object = None  # MGState when method == "mg"
    inner_rtol_user: bool = False
    op_norm: float = 0.0
    host_device: object = None  # the device of a splu operator's results
    build_s: object = None  # {part: seconds} of the build

    def with_inner_rtol(self, rtol: float):
        return dataclasses.replace(self, inner_rtol=float(rtol), inner_rtol_user=True)

    @property
    def dtype(self):
        if self.method == "splu":
            base = torch.from_numpy(np.zeros(0, self.solver.np_dtype)).dtype
        else:
            base = self.shifted.dtype
        return base.to_real() if self.out_real and base.is_complex else base

    @property
    def device(self):
        return self.host_device if self.method == "splu" else self.shifted.device

    @property
    def mesh(self):
        """The row mesh of a sharded ``shifted`` operator
        (:func:`~spectra_tpu_torch.parallel.sharded_stencil_shift_solve`),
        else None: the inner solve then reduces over it."""
        return getattr(self.shifted, "mesh", None)

    def rows(self) -> int:
        return self.n

    def cols(self) -> int:
        return self.n

    def perform_op(self, x):
        y = self.solver(x) if self.method == "splu" else self._iterative_solve(x)
        return y.real.contiguous() if self.out_real else y

    def _iterative_solve(self, x):
        mv = self.shifted.matvec
        work_dtype = self.shifted.dtype
        b = x.to(work_dtype)
        rtol = (
            self.inner_rtol
            if self.inner_rtol is not None
            else coupled_inner_rtol(1e-10, work_dtype)
        )
        maxiter = min(10 * self.n, 20000)
        mesh = self.mesh
        if self.method == "mg":
            # MGState or the row-sharded ShardedMGState
            y, _ = self.mg.solve(b, rtol=rtol, maxiter=100)
        elif self.method == "cheb":
            from spectra_tpu_torch.linalg.cheb_solve import chebyshev_solve

            alpha, beta = self.cheb_interval
            y, _ = chebyshev_solve(
                mv, b, alpha, beta, rtol=rtol, maxiter=min(20 * self.n, 40000),
                mesh=mesh,
            )
        elif self.method == "minres":
            from spectra_tpu_torch.linalg.minres import minres
            from spectra_tpu_torch.matop.precond import preconditioned_system

            if self.precond == "cheb" and self.cheb_interval is None:
                alpha, beta = 1e-4 * self.op_norm, self.op_norm
            elif self.precond == "cheb":
                alpha, beta = self.cheb_interval
            else:
                alpha = beta = None
            mv2, b2, recover = preconditioned_system(
                mv, b, self.precond,
                diag=self.shifted.diagonal() if self.precond == "jacobi" else None,
                alpha=alpha, beta=beta, degree=self.cheb_degree,
            )
            if self.precond == "cheb":
                # each transformed matvec costs cheb_degree SpMVs
                maxiter = max(maxiter // self.cheb_degree, 50)
            y, _ = minres(mv2, b2, rtol=rtol, maxiter=maxiter, mesh=mesh)
            y = recover(y)
        elif self.method == "cg":
            y = cg(mv, b, tol=rtol, maxiter=maxiter)
        elif self.method == "bicgstab":
            y = bicgstab(mv, b, tol=rtol, maxiter=maxiter)
        else:
            raise ValueError(f"unknown shift-solve method {self.method!r}")
        return _poison_if_unconverged(
            mv, y, b, self.op_norm, accept_bw=max(1e2 * rtol, 1e-10), mesh=mesh
        )


def _resolve_sparse_method(method: str, symmetric: bool = True) -> str:
    """``"auto"`` is the host SuperLU, as in the JAX package wherever
    its runtime has host callbacks; the port can always reach the host.
    A ``symmetric`` shifted matrix takes every method; a general one
    only ``"splu"`` and ``"bicgstab"``, since CG, MINRES, the Chebyshev
    iteration and the multigrid smoother assume symmetry."""
    if method == "auto":
        return "splu"
    allowed = (
        ("splu", "cg", "bicgstab", "minres", "cheb", "mg") if symmetric
        else ("splu", "bicgstab")
    )
    if method not in allowed:
        raise ValueError(
            f"method {method!r}: use 'auto' or one of {', '.join(allowed)}"
        )
    return method


def _build_sparse_shift(csr, sigma, method, precond="none", inner_rtol=None,
                        cheb_degree=16, cheb_interval=None, grid_dims=None,
                        device=None, out_real=False, symmetric=True):
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    method = _resolve_sparse_method(method, symmetric)
    device = resolve_device(device)
    n = csr.shape[0]
    shifted = (csr - sigma * sps.eye(n, dtype=csr.dtype, format="csr")).tocsr()
    if method == "splu":
        try:
            lu = spla.splu(shifted.tocsc())
        except RuntimeError as err:
            raise ShiftFactorizationError(
                f"sparse factorization failed: {err}"
            ) from err
        return SparseShiftSolveBase(
            shifted=None, solver=_HostLUSolver(lu, n, shifted.dtype), n=n,
            method="splu", out_real=out_real, host_device=device,
        )
    return build_shifted_iterative(
        shifted, method, precond=precond, inner_rtol=inner_rtol,
        cheb_degree=cheb_degree, cheb_interval=cheb_interval,
        grid_dims=grid_dims, device=device, out_real=out_real,
    )


def _maybe_build_mg(shifted_csr, device_mat, op_norm, grid_dims=None,
                    op_fields=None, times=None):
    """Build and trial-validate a multigrid hierarchy for
    ``shifted_csr``. Returns a validated ``MGState`` or None (not a grid
    stencil, or the trial solve did not reach a direct-solve-grade
    backward error, e.g. sigma inside the spectrum).

    The finest level is the operator's own device matrix ``device_mat``
    where that is DIA. The trial runs ``perform_op`` of a candidate
    operator with the default-coupled inner tolerance on
    ``SimpleRandom(1)``, and checks the backward error on the host CSR.
    ``times`` (a dict) accumulates the seconds of the ``hierarchy``
    builds and the ``trial`` solves.
    """
    from spectra_tpu_torch.linalg.multigrid import MGBuildError, build_mg
    from spectra_tpu_torch.sparse.formats import DiaHiLoMatrix, DiaMatrix
    from spectra_tpu_torch.util.rng import SimpleRandom

    n = shifted_csr.shape[0]
    b_host = SimpleRandom(1).random_vec(n, shifted_csr.dtype)
    b = torch.from_numpy(b_host).to(device_mat.device)
    scale0 = float(np.abs(shifted_csr).sum(axis=1).max())
    bnorm = float(np.linalg.norm(b_host))
    fields = dict(op_fields or {})
    fields["inner_rtol"] = coupled_inner_rtol(1e-10, device_mat.dtype)
    fields["inner_rtol_user"] = False
    level0 = device_mat if isinstance(device_mat, (DiaMatrix, DiaHiLoMatrix)) else None
    times = {} if times is None else times

    def tally(part, t0):
        times[part] = times.get(part, 0.0) + time.perf_counter() - t0

    def trial_ok(mg):
        t0 = time.perf_counter()
        cand = SparseShiftSolveBase(
            shifted=device_mat, solver=None, n=n, method="mg", mg=mg,
            op_norm=op_norm, **fields,
        )
        y = cand.perform_op(b).cpu().numpy()
        ok = bool(np.all(np.isfinite(y)))
        if ok:
            resid = float(np.linalg.norm(shifted_csr @ y - b_host))
            ok = resid <= 1e-11 * (scale0 * float(np.linalg.norm(y)) + bnorm)
        tally("trial", t0)
        return ok

    def build(boundary):
        t0 = time.perf_counter()
        try:
            return build_mg(
                shifted_csr, dims=grid_dims, boundary=boundary,
                device=device_mat.device, level0=level0,
            )
        finally:
            tally("hierarchy", t0)

    try:
        mg = build("auto")
    except MGBuildError:
        return None
    if trial_ok(mg):
        return mg
    # The boundary-weight heuristic can misclassify mixed operators; the
    # flipped variant is one rebuild away, and the trial decides.
    try:
        mg2 = build("const" if mg.boundary == "clip" else "clip")
    except MGBuildError:
        return None
    if trial_ok(mg2):
        return mg2
    return None


def build_shifted_iterative(shifted, method, precond="none", inner_rtol=None,
                            cheb_degree=16, cheb_interval=None,
                            grid_dims=None, device=None, out_real=False):
    """Iterative ``shifted^{-1}`` operator over a pre-shifted host CSR:
    device format routing, multigrid upgrade, Chebyshev interval
    learning, tolerance coupling and NaN poisoning."""
    from spectra_tpu_torch.matop.precond import gershgorin_upper
    from spectra_tpu_torch.sparse.formats import (
        dia_device_from_scipy,
        dia_suitability,
        ell_from_scipy,
    )

    device = resolve_device(device)
    n = shifted.shape[0]
    t0 = time.perf_counter()
    if dia_suitability(shifted):
        device_mat = dia_device_from_scipy(shifted, device=device)
    else:
        device_mat = ell_from_scipy(shifted, device=device)
    # Once, here: on a DiaHiLoMatrix every bound read builds f64 rows.
    op_norm = gershgorin_upper(device_mat)
    times = {"dia": time.perf_counter() - t0}
    op_fields = dict(
        precond=precond, cheb_degree=cheb_degree,
        cheb_interval=cheb_interval,
    )
    mg_state = None
    if method in ("mg", "minres"):
        mg_state = _maybe_build_mg(
            shifted, device_mat, op_norm, grid_dims, op_fields, times
        )
        if mg_state is not None:
            method = "mg"
        elif method == "mg":
            warnings.warn(
                "method='mg' requested but the shifted matrix is not a "
                "validated grid stencil (not grid-structured, or the "
                "trial V-cycle did not contract, e.g. indefinite shift); "
                "falling back to MINRES.",
                stacklevel=3,
            )
            method = "minres"
    if method == "cheb" and cheb_interval is None:
        from spectra_tpu_torch.linalg.cheb_solve import (
            chebyshev_solve_state,
            estimate_spd_interval,
        )
        from spectra_tpu_torch.util.rng import SimpleRandom

        t0 = time.perf_counter()
        alpha0, beta0 = estimate_spd_interval(shifted)
        # Learn the adaptive lower bound once, so that no inner solve
        # re-pays the stall-detect discovery.
        b = torch.from_numpy(SimpleRandom(1).random_vec(n, shifted.dtype))
        _, _, alpha_learned = chebyshev_solve_state(
            device_mat.matvec, b.to(device), alpha0, beta0, rtol=1e-10,
            maxiter=min(20 * n, 40000),
        )
        cheb_interval = (float(alpha_learned), beta0)
        times["interval"] = time.perf_counter() - t0
    return SparseShiftSolveBase(
        shifted=device_mat, solver=None, n=n, method=method, out_real=out_real,
        inner_rtol=inner_rtol, precond=precond, cheb_degree=cheb_degree,
        cheb_interval=cheb_interval, inner_rtol_user=inner_rtol is not None,
        mg=mg_state, op_norm=op_norm, build_s=times,
    )


class SparseSymShiftSolve:
    """``(A - sigma I)^{-1} x`` for sparse real symmetric A (reference:
    SparseSymShiftSolve.h:51,85-102). ``create(csr, uplo, method,
    device=...)``; the iterative knobs (ignored by ``"splu"``) are
    ``precond``, ``inner_rtol`` (None couples it to the outer tol),
    ``cheb_degree``, ``cheb_interval`` and ``grid_dims`` (for
    ``"mg"``)."""

    def __init__(self, csr, uplo: str = "L", method: str = "auto",
                 precond: str = "none", inner_rtol=None, cheb_degree: int = 16,
                 cheb_interval=None, grid_dims=None, device=None):
        self._csr = symmetrize_scipy(csr, uplo, conjugate=False)
        self._method = method
        self._device = device
        self._iter_opts = dict(
            precond=precond,
            inner_rtol=inner_rtol,
            cheb_degree=cheb_degree,
            cheb_interval=cheb_interval,
            grid_dims=grid_dims,
        )
        # (alpha, beta, sigma) of the last Chebyshev interval learned by
        # set_shift, reused across shifts by exact translation.
        self._learned_interval = None

    @property
    def dtype(self):
        return torch.from_numpy(np.zeros(0, self._csr.dtype)).dtype

    def rows(self) -> int:
        return self._csr.shape[0]

    def cols(self) -> int:
        return self._csr.shape[1]

    @classmethod
    def create(cls, csr, uplo: str = "L", method: str = "auto", **kwargs):
        return cls(csr, uplo, method, **kwargs)

    def set_shift(self, sigma):
        """The ``(A - sigma I)^{-1}`` operator for this shift.

        A learned Chebyshev interval is reused across shifts by exact
        translation, ``eig(A - s' I) = eig(A - s I) - (s' - s)``, while
        its lower edge keeps a margin above zero
        (``alpha - d > 1e-3 (beta - d)``); otherwise the interval is
        learned anew. A user-pinned ``cheb_interval`` is never
        overridden."""
        opts = dict(self._iter_opts)
        if opts.get("cheb_interval") is None and self._learned_interval:
            a0, b0, s0 = self._learned_interval
            d = float(np.real(sigma)) - s0
            if a0 - d > 1e-3 * (b0 - d):
                opts["cheb_interval"] = (a0 - d, b0 - d)
        op = _build_sparse_shift(
            self._csr, sigma, self._method, device=self._device, **opts
        )
        if (
            self._iter_opts.get("cheb_interval") is None
            and op.method == "cheb"
            and op.cheb_interval is not None
        ):
            a, b = op.cheb_interval
            self._learned_interval = (float(a), float(b), float(np.real(sigma)))
        return op


class SparseGenRealShiftSolve:
    """``(A - sigma I)^{-1} x`` for a sparse general real A (reference:
    SparseGenRealShiftSolve.h:49). ``create(csr, method, device=...)``
    with ``method`` ``"auto"``/``"splu"`` (host SuperLU) or
    ``"bicgstab"`` (BiCGStab on the device, the DIA kernel for a banded
    matrix)."""

    def __init__(self, csr, method: str = "auto", device=None):
        self._csr = csr.tocsr()
        self._method = method
        self._device = device

    @property
    def dtype(self):
        return torch.from_numpy(np.zeros(0, self._csr.dtype)).dtype

    def rows(self) -> int:
        return self._csr.shape[0]

    def cols(self) -> int:
        return self._csr.shape[1]

    @classmethod
    def create(cls, csr, method: str = "auto", device=None):
        return cls(csr, method, device)

    def set_shift(self, sigma):
        return _build_sparse_shift(
            self._csr, sigma, self._method, device=self._device, symmetric=False
        )


class SparseGenComplexShiftSolve(SparseGenRealShiftSolve):
    """``Re[(A - (sr + si i) I)^{-1} x]`` for a sparse general real A
    (reference: SparseGenComplexShiftSolve.h:52-56,114): the complex
    shifted matrix is factored by a complex SuperLU on the host, or
    solved by BiCGStab on the device (ELL storage); the result is real,
    on the operand's device."""

    def set_shift(self, sigmar, sigmai):
        csr_c = self._csr.astype(np.result_type(self._csr.dtype, np.complex64))
        return _build_sparse_shift(
            csr_c, complex(sigmar, sigmai), self._method, device=self._device,
            out_real=True, symmetric=False,
        )
