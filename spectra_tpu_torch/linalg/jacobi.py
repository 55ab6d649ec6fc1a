"""Symmetric eigendecomposition: parallel cyclic Jacobi and the accurate route.

Port of :mod:`spectra_tpu.linalg.jacobi`. The JAX package needs Jacobi
because the TPU's emulated-f64 ``eigh`` delivers eigenvectors to about
1e-7 only; its ``eigh_accurate`` routes there on the TPU and to the
backend's ``eigh`` everywhere else. The port's small projected problems
run on the host in f64, so :func:`eigh_accurate` is LAPACK's ``eigh`` on
the host, as the JAX package's is on the CPU. :func:`jacobi_eigh` is
kept for parity, in plain torch on the input's device: rounds of m/2
disjoint rotations in a round-robin tournament order, swept until the
off-diagonal norm reaches ``4 eps ||A||_F`` (Golub & Van Loan 8.4).
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _round_robin(m: int) -> np.ndarray:
    """Tournament schedule: (m-1) rounds of m/2 disjoint pairs covering
    every (p, q) pair exactly once (m even)."""
    players = list(range(m))
    rounds = []
    rest = players[1:]
    for _ in range(m - 1):
        cur = [players[0]] + rest
        pairs = [
            tuple(sorted((cur[i], cur[m - 1 - i]))) for i in range(m // 2)
        ]
        rounds.append(sorted(pairs))
        rest = rest[-1:] + rest[:-1]
    return np.asarray(rounds, dtype=np.int32)  # (m-1, m/2, 2)


def _apply_round(A, V, P, Q):
    """One parallel rotation set: annihilate ``A[p, q]`` for the disjoint
    pairs (P, Q); ``A <- J^T A J``, ``V <- V J``."""
    app = A[P, P]
    aqq = A[Q, Q]
    apq = A[P, Q]
    # Pivots at the local eps floor are skipped (threshold Jacobi), which
    # also bounds |tau| <= 1/eps so tau^2 cannot overflow.
    eps = torch.finfo(A.dtype).eps
    live = apq.abs() > 0.5 * eps * (app.abs() + aqq.abs())
    denom = torch.where(live, 2.0 * apq, torch.ones_like(apq))
    tau = torch.where(live, (aqq - app) / denom, torch.zeros_like(apq))
    # sign(tau) is +-1, never 0: equal diagonal entries with a live pivot
    # need the full 45-degree rotation.
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(live, c, torch.ones_like(c))
    s = torch.where(live, s, torch.zeros_like(s))

    Ap, Aq = A[P, :], A[Q, :]
    A = A.clone()
    A[P, :] = c[:, None] * Ap - s[:, None] * Aq
    A[Q, :] = s[:, None] * Ap + c[:, None] * Aq
    Ap, Aq = A[:, P].clone(), A[:, Q].clone()
    A[:, P] = c[None, :] * Ap - s[None, :] * Aq
    A[:, Q] = s[None, :] * Ap + c[None, :] * Aq
    A[P, Q] = 0.0
    A[Q, P] = 0.0
    Vp, Vq = V[:, P], V[:, Q]
    V = V.clone()
    V[:, P] = c[None, :] * Vp - s[None, :] * Vq
    V[:, Q] = s[None, :] * Vp + c[None, :] * Vq
    return A, V


def jacobi_eigh(A, max_sweeps: int = 30):
    """Eigendecomposition of a real symmetric matrix by parallel cyclic
    Jacobi: ``(eigenvalues ascending, eigenvectors as columns)``, tensors
    on ``A``'s device."""
    A = torch.as_tensor(A)
    m = A.shape[0]
    if m == 1:
        return A[0, :1].real.clone(), torch.ones_like(A)
    mp = m + (m % 2)  # pad odd sizes with a decoupled zero row/col
    if mp != m:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    sched = torch.from_numpy(_round_robin(mp).astype(np.int64)).to(A.device)
    eps = torch.finfo(A.dtype).eps
    V = torch.eye(mp, dtype=A.dtype, device=A.device)
    off_mask = ~torch.eye(mp, dtype=torch.bool, device=A.device)

    def off_norm(M):
        # Sum the off-diagonal entries directly: fro^2 - diag^2 cancels.
        return float(torch.sqrt((M * M)[off_mask].sum()))

    fro = max(float(torch.sqrt((A * A).sum())), eps)
    sweeps = 0
    while off_norm(A) > 4.0 * eps * fro and sweeps < max_sweeps:
        for r in range(mp - 1):
            A, V = _apply_round(A, V, sched[r, :, 0], sched[r, :, 1])
        sweeps += 1
    evals = torch.diagonal(A)[:m]
    V = V[:m, :m]
    order = torch.argsort(evals, stable=True)
    return evals[order], V[:, order]


def nan_eigenpairs(A):
    """What ``jnp.linalg.eigh`` gives for a matrix with a non-finite
    entry: NaN eigenvalues (real) and NaN eigenvectors (A's dtype), CPU
    tensors."""
    m = A.shape[-1]
    w = torch.full((m,), float("nan"), dtype=A.real.dtype)
    return w, torch.full((m, m), float("nan"), dtype=A.dtype)


def eigh_accurate(A):
    """``eigh`` of a symmetric (or Hermitian) matrix in f64 on the host,
    LAPACK's: ``(eigenvalues ascending, eigenvectors as columns)`` as CPU
    tensors. Accepts numpy arrays and tensors. A matrix with a
    non-finite entry gives NaN pairs (:func:`nan_eigenpairs`), as
    ``jnp.linalg.eigh`` does, so that the solvers end on it with
    ``NumericalIssue``; a finite matrix goes to ``torch.linalg.eigh``
    as it is, and a failure of LAPACK on it still raises."""
    A = torch.as_tensor(A).cpu()
    if not A.dtype.is_complex:
        A = A.to(torch.float64)
    if not torch.isfinite(A).all():
        return nan_eigenpairs(A)
    return torch.linalg.eigh(A)
