"""Core of the implicitly restarted Arnoldi method (IRAM).

Port of :mod:`spectra_tpu.solvers._gen_core`, the non-symmetric sibling
of :mod:`spectra_tpu_torch.solvers._herm_core`: factorize -> Ritz
extraction -> convergence test -> implicit restarts, for real matrices
(H real Hessenberg, complex Ritz values in conjugate pairs) and complex
ones (H complex Hessenberg).

The JAX package has two drivers: a compiled ``lax.while_loop``
(``_gen_core.py``) and a host loop for TPUs without complex arithmetic
(``_gen_host.py``). The port has one, a host loop over device tensors
shaped like the symmetric one: the n-length work (the Arnoldi steps'
operator applications and projections, the rotation ``V <- V Q``) runs
on the operator's device; the (ncv, ncv) problem (``eig(H)``, the Ritz
selection, the convergence test, the nev adjustment and the shift
sweeps that build Q) runs on the host in f64 or c128 numpy, the
replicated small problem of the design. Its host-side rules are
``_gen_host.py``'s (``_host_ritz``, ``_host_nev_adjusted``), its sweep
logic ``_gen_core.py``'s.

Numerical rules mirror the reference exactly:
  * convergence ``|ritz_est| * ||f|| < tol * max(eps^{2/3}, |theta|)``
    with eps of the operator's dtype (reference:
    include/Spectra/GenEigsBase.h:225-242);
  * the nev adjustment replicates dnaup2.f 660-674 plus the
    keep-conjugate-pair rule (GenEigsBase.h:245-277);
  * restarts apply the unwanted Ritz values as implicit shifts in
    selection order: an exact conjugate pair becomes one Francis
    double shift, a real shift one Hessenberg QR sweep; for complex
    matrices every shift is a complex QR sweep (GenEigsBase.h:44-140).

As in the symmetric core, when maxit is exhausted the convergence of
the last restart is still tested. A non-finite H (a NaN-poisoned inner
solve) ends the iteration with NaN values, so the driver reports
``CompInfo.NumericalIssue``; the JAX package's LAPACK bridge raises on
it instead.
"""

from typing import NamedTuple

import numpy as np
import torch

from spectra_tpu_torch.linalg import krylov
from spectra_tpu_torch.linalg.hessenberg import double_shift_qr, hessenberg_qr
from spectra_tpu_torch.linalg.hessenberg_eigen import hessenberg_eigen
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.selection import SortRule, argsort_np


class IRAMResult(NamedTuple):
    values: np.ndarray  # (nev,) complex, back-transformed and sorted
    vectors_small: np.ndarray  # (ncv, nev) complex Ritz vectors in V
    conv: np.ndarray  # (nev,) bool, sorted order
    nconv: int
    niter: int
    nops: int
    V: torch.Tensor  # (ncv, n) row-major, on the device
    f: torch.Tensor  # (n,) on the device


def _retrieve_ritzpair(H, selection: SortRule, nev: int):
    """Ritz values, estimates and vectors of H, wanted first (reference:
    GenEigsBase.h:205-224). A non-finite H (a NaN-poisoned inner solve)
    gives NaN Ritz values, which end the iteration."""
    if not np.isfinite(H).all():
        nan = np.full(H.shape, np.nan, np.result_type(H.dtype, np.complex64))
        return nan[0], nan[-1], nan[:, :nev]
    evals, evecs = hessenberg_eigen(H)
    ind = argsort_np(selection, evals)
    return evals[ind], evecs[-1, ind], evecs[:, ind[:nev]]


def _num_converged(ritz_val, ritz_est, beta: float, tol: float, nev: int,
                   dtype):
    thresh = tol * np.maximum(dtypes.eps23(dtype), np.abs(ritz_val[:nev]))
    conv = np.abs(ritz_est[:nev]) * beta < thresh
    return conv, int(conv.sum())


def _is_conj_pair(a, b) -> bool:
    """Exact-conjugacy test: LAPACK pairs are exactly conjugate
    (reference: GenEigsBase.h:55-56)."""
    return bool(a.imag != 0 and a == np.conj(b))


def _nev_adjusted(nconv: int, ritz_val, ritz_est, nev: int, ncv: int,
                  dtype) -> int:
    nev_new = nev + int(np.sum(np.abs(ritz_est[nev:ncv]) < dtypes.near_zero(dtype)))
    # dnaup2.f 660-674
    nev_new += min(nconv, (ncv - nev_new) // 2)
    if nev_new == 1 and ncv >= 6:
        nev_new = ncv // 2
    elif nev_new == 1 and ncv > 3:
        nev_new = 2
    nev_new = min(nev_new, ncv - 2)
    # Keep conjugate pairs together (GenEigsBase.h:268-274).
    return nev_new + int(_is_conj_pair(ritz_val[nev_new - 1], ritz_val[nev_new]))


def _shift_sweep_real(H, ritz_val, k_new: int, ncv: int):
    """Apply the shifts ``ritz_val[k_new:]`` to the real H: an exact
    conjugate pair is one Francis double shift, a real shift one QR
    sweep. Returns ``(H_new, Q)``."""
    Q = np.eye(ncv)
    i = k_new
    while i < ncv:
        mu = ritz_val[i]
        if i + 1 < ncv and _is_conj_pair(mu, ritz_val[i + 1]):
            H, Qi = double_shift_qr(H, 2.0 * mu.real, (mu * np.conj(mu)).real)
            i += 2
        else:
            H, Qi = hessenberg_qr(H, mu.real)
            i += 1
        Q = Q @ Qi
    return H, Q


def _shift_sweep_complex(H, ritz_val, k_new: int, ncv: int):
    """Apply every shift ``ritz_val[k_new:]`` by complex Hessenberg QR
    (complex matrices, reference: GenEigsBase.h:112-140)."""
    Q = np.eye(ncv, dtype=np.complex128)
    for i in range(k_new, ncv):
        H, Qi = hessenberg_qr(H, ritz_val[i])
        Q = Q @ Qi
    return H, Q


def _compress_expand(arnop, state, H_new, Q, k_new: int):
    state = krylov.compress(
        arnop, state, torch.from_numpy(Q), torch.from_numpy(H_new), k_new
    )
    return krylov.factorize_from(arnop, state, k_new, "arnoldi")


def _restart_real(arnop, state, ritz_val, k_new: int, ncv: int):
    """Apply the shifts ``ritz_val[k_new:]`` to a real-H factorization,
    compress to ``k_new`` steps and re-expand."""
    H_new, Q = _shift_sweep_real(state.H.numpy(), ritz_val, k_new, ncv)
    return _compress_expand(arnop, state, H_new, Q, k_new)


def _restart_complex(arnop, state, ritz_val, k_new: int, ncv: int):
    """Apply every shift by complex Hessenberg QR, compress and
    re-expand."""
    H_new, Q = _shift_sweep_complex(state.H.numpy(), ritz_val, k_new, ncv)
    return _compress_expand(arnop, state, H_new, Q, k_new)


class _LoopCarry(NamedTuple):
    """Resumable iteration state between restart segments."""

    state: krylov.KrylovState
    ritz_val: np.ndarray
    ritz_est: np.ndarray
    ritz_vec: np.ndarray
    conv: np.ndarray
    nconv: int
    restarts: int


def _extract(state, tol: float, restarts: int, nev: int,
             selection: SortRule, dtype) -> _LoopCarry:
    ritz_val, ritz_est, ritz_vec = _retrieve_ritzpair(
        state.H.numpy(), selection, nev
    )
    conv, nconv = _num_converged(ritz_val, ritz_est, state.beta, tol, nev, dtype)
    return _LoopCarry(state, ritz_val, ritz_est, ritz_vec, conv, nconv, restarts)


def iram_start(arnop, v0, seed: int, tol: float, *, nev: int, ncv: int,
               selection: SortRule) -> _LoopCarry:
    """Initial ncv-step Arnoldi factorization + first Ritz extraction."""
    state = krylov.init(arnop, v0, ncv, seed)
    state = krylov.factorize_from(arnop, state, 1, "arnoldi")
    return _extract(state, tol, 0, nev, selection, arnop.dtype)


def iram_restarts(arnop, carry: _LoopCarry, tol: float, restart_budget: int,
                  *, nev: int, ncv: int, selection: SortRule) -> _LoopCarry:
    """Implicit restarts until convergence or until the total restart
    count reaches ``restart_budget``; chunked and single-shot runs are
    identical."""
    restart = _restart_complex if arnop.dtype.is_complex else _restart_real
    c = carry
    while (c.nconv < nev and c.restarts < restart_budget
           and np.isfinite(c.ritz_val).all()):
        k_new = _nev_adjusted(c.nconv, c.ritz_val, c.ritz_est, nev, ncv, arnop.dtype)
        state = restart(arnop, c.state, c.ritz_val, k_new, ncv)
        c = _extract(state, tol, c.restarts + 1, nev, selection, arnop.dtype)
    return c


def iram_finalize(carry: _LoopCarry, transform_aux=None, *, nev: int,
                  sorting: SortRule, transform=None) -> IRAMResult:
    """Back-transform (``transform(values, transform_aux, ritz_vec,
    state)``) and sort the first nev Ritz pairs by ``sorting``."""
    vals = carry.ritz_val[:nev]
    if transform is not None:
        # NaN values (a poisoned inner solve) stay NaN: NumericalIssue
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = np.asarray(transform(vals, transform_aux, carry.ritz_vec, carry.state))
    ind = argsort_np(sorting, vals)
    return IRAMResult(
        values=vals[ind],
        vectors_small=carry.ritz_vec[:, ind],
        conv=carry.conv[ind],
        nconv=carry.nconv,
        niter=carry.restarts + 1,
        nops=carry.state.nops,
        V=carry.state.V,
        f=carry.state.f,
    )


def iram_compute(arnop, v0, seed: int, maxit: int, tol: float,
                 transform_aux=None, *, nev: int, ncv: int,
                 selection: SortRule, sorting: SortRule,
                 transform=None) -> IRAMResult:
    """Single-shot IRAM: start + restarts + finalize."""
    fixed = dict(nev=nev, ncv=ncv, selection=selection)
    carry = iram_start(arnop, v0, seed, tol, **fixed)
    carry = iram_restarts(arnop, carry, tol, maxit, **fixed)
    return iram_finalize(
        carry, transform_aux, nev=nev, sorting=sorting, transform=transform
    )
