"""Core of the implicitly restarted Lanczos method (IRLM).

Port of :mod:`spectra_tpu.solvers._herm_core`. The JAX package runs the
whole restarted iteration as one jitted ``lax.while_loop``; here it is
a host loop over device tensors: factorize to ncv steps, extract Ritz
pairs from the projection H, count converged pairs with the ARPACK
test, adjust nev, apply implicit shifted-QR restarts, and repeat until
convergence or maxit.

Where the work runs: the n-length work (the factorization's SpMVs,
projections and the restart rotation of V) runs on the operator's
device. The small (ncv, ncv) projected problem (tridiagonal eigen,
shift sweep, Ritz selection, convergence test) runs on the host in
f64, for a complex Hermitian operator too: its Lanczos projection is
real (:func:`krylov.init` with ``hermitian=True``), and each restart
casts the real rotation to the basis's dtype once. That is the replicated small dense subproblem of the design
(SURVEY.md), not a fallback: it is hundreds of tiny dependent
operations per restart, which would each be a launch on the card.

Numerical rules mirror the reference exactly:
  * convergence: ``|ritz_est| * ||f|| < tol * max(eps^{2/3}, |theta|)``
    (reference: include/Spectra/HermEigsBase.h:158-175), with eps of
    the operator's dtype;
  * nev adjustment replicates dsaup2.f lines 677-684
    (HermEigsBase.h:178-202);
  * restart applies the unwanted Ritz values as implicit shifts,
    largest magnitude first, via shifted tridiagonal QR
    (HermEigsBase.h:105-155).

As in the JAX package, when maxit is exhausted the convergence of the
final restart is still tested, which can only turn a NotConverging into
a Successful.

``restart_method="thick"`` replaces the shifted-QR restart by the thick
restart (TRLan / Krylov-Schur): one host eigen-decomposition of H and
one basis rotation, after which H is an arrowhead.
"""

from typing import NamedTuple

import torch

from spectra_tpu_torch.linalg import krylov
from spectra_tpu_torch.linalg.jacobi import eigh_accurate
from spectra_tpu_torch.linalg.tridiag import (
    apply_yq,
    tridiag_eigen,
    tridiag_qr,
    tridiag_qtq,
    tridiag_to_dense,
)
from spectra_tpu_torch.ops.gemv import basis_apply_block
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.selection import SortRule, argsort


class IRLMResult(NamedTuple):
    values: torch.Tensor  # (nev,) CPU f64, sorted Ritz values
    vectors_small: torch.Tensor  # (ncv, nev) CPU f64, Ritz vectors in V
    conv: torch.Tensor  # (nev,) bool convergence flags, sorted order
    nconv: int
    niter: int
    nops: int
    V: torch.Tensor  # (ncv, n) final Krylov basis, on the device
    f: torch.Tensor  # (n,) final residual, on the device


def _retrieve_ritzpair(H, selection: SortRule, nev: int, full_h: bool = False):
    """Ritz values/vectors of the projection, wanted first (reference:
    HermEigsBase.h:205-224). With implicit restarts H is tridiagonal;
    with thick restarts it carries the arrowhead coupling, so ``full_h``
    decomposes the whole symmetric matrix (a dense host ``eigh``)."""
    if full_h:
        evals, evecs = eigh_accurate(0.5 * (H + H.T))
    else:
        evals, evecs = tridiag_eigen(H.diagonal(), H.diagonal(-1))
    ind = argsort(selection, evals)
    return evals[ind], evecs[-1, ind], evecs[:, ind[:nev]]


def _num_converged(ritz_val, ritz_est, beta: float, tol: float, nev: int,
                   dtype):
    thresh = tol * torch.clamp(ritz_val[:nev].abs(), min=dtypes.eps23(dtype))
    conv = ritz_est[:nev].abs() * beta < thresh
    return conv, int(conv.sum())


def _nev_adjusted(nconv: int, ritz_est, nev: int, ncv: int, dtype) -> int:
    near_0 = dtypes.near_zero(dtype)
    nev_new = nev + int((ritz_est[nev:ncv].abs() < near_0).sum())
    # dsaup2.f 677-684
    nev_new += min(nconv, (ncv - nev_new) // 2)
    if nev_new == 1 and ncv >= 6:
        nev_new = ncv // 2
    elif nev_new == 1 and ncv > 2:
        nev_new = 2
    return min(nev_new, ncv - 1)


def _shift_sweep(H, ritz_val, k_new: int, ncv: int):
    """The replicated small half of the implicit restart: apply the
    ncv - k_new unwanted Ritz values as shifts (largest magnitude
    first) to the tridiagonal H, accumulating the rotation Q."""
    # Unwanted = positions >= k_new in the selection order; sort them by
    # magnitude descending. Wanted positions sort last.
    with span("irlm.shifts"):
        pos = torch.arange(ncv)
        key = torch.where(pos >= k_new, ritz_val.abs(), -torch.inf)
        shifts = ritz_val[torch.argsort(-key, stable=True)].tolist()
        Q = torch.eye(ncv, dtype=torch.float64)
        for mu in shifts[: ncv - k_new]:
            d, e = H.diagonal(), H.diagonal(-1)
            c, s, e_defl = tridiag_qr(d, e, mu)
            Q = apply_yq(Q, c, s)
            H = tridiag_to_dense(*tridiag_qtq(d, e_defl, c, s))
        return H, Q


def _restart_compress(arnop, state, ritz_val, k_new: int, ncv: int):
    """Shift-and-compress half of the implicit restart."""
    H_new, Q = _shift_sweep(state.H, ritz_val, k_new, ncv)
    with span("irlm.compress"):
        return krylov.compress(arnop, state, Q, H_new, k_new)


def _restart(arnop, state, ritz_val, k_new: int, ncv: int, mode: str):
    """Implicitly restart: apply the ncv - k unwanted Ritz values as
    shifts (largest |shift| first), compress to k steps, re-expand."""
    state = _restart_compress(arnop, state, ritz_val, k_new, ncv)
    return krylov.factorize_from(arnop, state, k_new, mode)


def _restart_thick(arnop, state, k_new: int, mode: str, selection: SortRule):
    """Thick restart (TRLan, Wu & Simon 2000 / Krylov-Schur): collapse
    the factorization to the k_new wanted Ritz vectors directly, then
    re-expand. The restarted projection is the symmetric arrowhead
    ``[[diag(theta), s], [s^T, a]]`` with ``s = beta * Y[m-1, kept]``;
    the first step after the restart runs in full-projection mode to
    build the arrow column, after which the three-term recurrence
    resumes."""
    state = _restart_thick_compress(arnop, state, k_new, selection)
    return krylov.factorize_from(arnop, state, state.k, mode)


def _restart_thick_compress(arnop, state, k_new: int, selection: SortRule):
    """Collapse-and-arrow half of the thick restart: one host ``eigh`` of
    H, one rotation ``V <- V Y`` with the dropped columns of Y zeroed
    (two (ncv, n) buffers at the peak, not three), and the
    full-projection step that rebuilds the arrow column numerically
    (``h_j = v_j^T A v_k = s_j`` analytically, DGKS-corrected): one
    operator application."""
    H = state.H
    with span("irlm.shifts"):
        evals, Y = eigh_accurate(torch.triu(H) + torch.triu(H, 1).T)
        ind = argsort(selection, evals)
        Ym = Y[:, ind]
        Ym[:, k_new:] = 0.0
        V_new = basis_apply_block(state.V, Ym.to(state.V.device, state.V.dtype))
    H_new = torch.zeros_like(H)
    H_new.diagonal()[:k_new] = evals[ind[:k_new]]
    state = state._replace(V=V_new, H=H_new, k=k_new)
    state = krylov.step_once(arnop, state, k_new, "arnoldi")
    state.H[k_new, :] = state.H[:, k_new].clone()
    return state._replace(k=k_new + 1)


class _LoopCarry(NamedTuple):
    """Resumable iteration state between restart segments."""

    state: krylov.KrylovState
    ritz_val: torch.Tensor
    ritz_est: torch.Tensor
    ritz_vec: torch.Tensor
    conv: torch.Tensor
    nconv: int
    restarts: int


def _extract(state, tol: float, restarts: int, nev: int,
             selection: SortRule, restart_method: str) -> _LoopCarry:
    with span("irlm.ritz"):
        ritz_val, ritz_est, ritz_vec = _retrieve_ritzpair(
            state.H, selection, nev, full_h=restart_method == "thick"
        )
        conv, nconv = _num_converged(
            ritz_val, ritz_est, state.beta, tol, nev, state.V.dtype
        )
    return _LoopCarry(
        state, ritz_val, ritz_est, ritz_vec, conv, nconv, restarts
    )


def irlm_start(arnop, v0, seed: int, tol: float, *, nev: int, ncv: int,
               selection: SortRule, mode: str,
               restart_method: str = "implicit") -> _LoopCarry:
    """Initial ncv-step factorization + first Ritz extraction."""
    with span("irlm.start"):
        state = krylov.init(arnop, v0, ncv, seed, hermitian=True)
        state = krylov.factorize_from(arnop, state, 1, mode)
        return _extract(state, tol, 0, nev, selection, restart_method)


def irlm_restarts(arnop, carry: _LoopCarry, tol: float, restart_budget: int,
                  *, nev: int, ncv: int, selection: SortRule, mode: str,
                  restart_method: str = "implicit") -> _LoopCarry:
    """Run restarts until convergence or until the total restart count
    reaches ``restart_budget``. The carry crosses segments exactly, so
    chunked and single-shot runs are identical."""
    c = carry
    while c.nconv < nev and c.restarts < restart_budget:
        with span("irlm.restart"):
            k_new = _nev_adjusted(c.nconv, c.ritz_est, nev, ncv, arnop.dtype)
            if restart_method == "thick":
                state = _restart_thick(arnop, c.state, k_new, mode, selection)
            else:
                state = _restart(arnop, c.state, c.ritz_val, k_new, ncv, mode)
            c = _extract(state, tol, c.restarts + 1, nev, selection, restart_method)
    return c


def irlm_finalize(carry: _LoopCarry, transform_aux=None, *, nev: int,
                  sorting: SortRule, transform=None) -> IRLMResult:
    """Back-transform (``transform(values, transform_aux)``, e.g. the
    shift-invert ``1/nu + sigma``) and sort the first nev Ritz pairs by
    ``sorting``."""
    with span("irlm.finalize"):
        vals = carry.ritz_val[:nev]
        if transform is not None:
            vals = transform(vals, transform_aux)
        ind = argsort(sorting, vals)
    return IRLMResult(
        values=vals[ind],
        vectors_small=carry.ritz_vec[:, ind],
        conv=carry.conv[ind],
        nconv=carry.nconv,
        niter=carry.restarts + 1,
        nops=carry.state.nops,
        V=carry.state.V,
        f=carry.state.f,
    )


def irlm_compute(arnop, v0, seed: int, maxit: int, tol: float,
                 transform_aux=None, *, nev: int, ncv: int,
                 selection: SortRule, sorting: SortRule,
                 mode: str = "lanczos", transform=None,
                 restart_method: str = "implicit") -> IRLMResult:
    """Single-shot IRLM: start + restarts + finalize."""
    fixed = dict(nev=nev, ncv=ncv, selection=selection, mode=mode,
                 restart_method=restart_method)
    carry = irlm_start(arnop, v0, seed, tol, **fixed)
    carry = irlm_restarts(arnop, carry, tol, maxit, **fixed)
    return irlm_finalize(
        carry, transform_aux, nev=nev, sorting=sorting, transform=transform
    )
