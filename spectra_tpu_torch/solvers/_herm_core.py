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
f64. That is the replicated small dense subproblem of the design
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
"""

from typing import NamedTuple

import torch

from spectra_tpu_torch.linalg import krylov
from spectra_tpu_torch.linalg.tridiag import (
    apply_yq,
    tridiag_eigen,
    tridiag_qr,
    tridiag_qtq,
    tridiag_to_dense,
)
from spectra_tpu_torch.util import dtypes
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


def _retrieve_ritzpair(H, selection: SortRule, nev: int):
    """Ritz values/vectors of the tridiagonal projection, wanted first
    (reference: HermEigsBase.h:205-224)."""
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
    return krylov.compress(arnop, state, Q, H_new, k_new)


def _restart(arnop, state, ritz_val, k_new: int, ncv: int, mode: str):
    """Implicitly restart: apply the ncv - k unwanted Ritz values as
    shifts (largest |shift| first), compress to k steps, re-expand."""
    state = _restart_compress(arnop, state, ritz_val, k_new, ncv)
    return krylov.factorize_from(arnop, state, k_new, mode)


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
             selection: SortRule) -> _LoopCarry:
    ritz_val, ritz_est, ritz_vec = _retrieve_ritzpair(state.H, selection, nev)
    conv, nconv = _num_converged(
        ritz_val, ritz_est, state.beta, tol, nev, state.V.dtype
    )
    return _LoopCarry(
        state, ritz_val, ritz_est, ritz_vec, conv, nconv, restarts
    )


def irlm_start(arnop, v0, seed: int, tol: float, *, nev: int, ncv: int,
               selection: SortRule, mode: str) -> _LoopCarry:
    """Initial ncv-step factorization + first Ritz extraction."""
    state = krylov.init(arnop, v0, ncv, seed)
    state = krylov.factorize_from(arnop, state, 1, mode)
    return _extract(state, tol, 0, nev, selection)


def irlm_restarts(arnop, carry: _LoopCarry, tol: float, restart_budget: int,
                  *, nev: int, ncv: int, selection: SortRule,
                  mode: str) -> _LoopCarry:
    """Run implicit restarts until convergence or until the total
    restart count reaches ``restart_budget``. The carry crosses
    segments exactly, so chunked and single-shot runs are identical."""
    c = carry
    while c.nconv < nev and c.restarts < restart_budget:
        k_new = _nev_adjusted(c.nconv, c.ritz_est, nev, ncv, arnop.dtype)
        state = _restart(arnop, c.state, c.ritz_val, k_new, ncv, mode)
        c = _extract(state, tol, c.restarts + 1, nev, selection)
    return c


def irlm_finalize(carry: _LoopCarry, transform_aux=None, *, nev: int,
                  sorting: SortRule, transform=None) -> IRLMResult:
    """Back-transform (``transform(values, transform_aux)``, e.g. the
    shift-invert ``1/nu + sigma``) and sort the first nev Ritz pairs by
    ``sorting``."""
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
                 mode: str = "lanczos", transform=None) -> IRLMResult:
    """Single-shot IRLM: start + restarts + finalize."""
    carry = irlm_start(
        arnop, v0, seed, tol, nev=nev, ncv=ncv, selection=selection, mode=mode
    )
    carry = irlm_restarts(
        arnop, carry, tol, maxit, nev=nev, ncv=ncv, selection=selection,
        mode=mode,
    )
    return irlm_finalize(
        carry, transform_aux, nev=nev, sorting=sorting, transform=transform
    )
