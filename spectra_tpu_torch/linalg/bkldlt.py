"""Bunch-Kaufman LDL^H factorization of symmetric/Hermitian matrices.

Port of :mod:`spectra_tpu.linalg.bkldlt` (reference:
include/Spectra/LinAlg/BKLDLT.h:69-710): factorizes
``P (A - sigma I) P^T = L D L^H`` with L unit lower triangular and D
block diagonal with 1x1/2x2 pivots chosen by Bunch-Kaufman partial
pivoting, then solves ``(A - sigma I) x = b`` by permute, triangular
solve, block-diagonal solve, adjoint triangular solve and unpermute.

The JAX package runs the factorization as one ``lax.while_loop`` whose
step is 1 or 2 by the data. Here it is a host loop over k on the
tensor's device: each step computes the pivot test's three comparisons
and the candidate row r on the device and reads them with one host
read, swaps rows and columns on the device, and updates only the
trailing block, with the JAX package's per-element arithmetic
``M - l conj(m)``. Pivots, ``perm`` and ``is2x2`` are therefore the
JAX package's. The solve is two unit-diagonal ``solve_triangular``
calls around the closed-form block-diagonal solve.

Real symmetric and complex Hermitian matrices (reference: Hermitian
support since v1.1.0, CHANGELOG.md:36).
"""

from typing import NamedTuple

import torch

_ALPHA = 0.6403882032022076  # (1 + sqrt(17)) / 8, the B-K constant


class BKFactors(NamedTuple):
    """The factorization ``P A P^T = L D L^H``, on A's device."""

    L: torch.Tensor  # (n, n) unit lower triangular
    d: torch.Tensor  # (n,) diagonal of D
    e: torch.Tensor  # (n,) subdiagonal of D: e[k] = D[k+1, k] for 2x2 pivots
    is2x2: torch.Tensor  # (n,) bool: True at the first index of a 2x2 pivot
    perm: torch.Tensor  # (n,) int64: row k of the pivoted matrix is A[perm[k]]
    ok: bool  # False if a pivot block was singular or not finite


def _swap(M, p: int, q: int, cols=slice(None)):
    """Exchange rows p and q of ``M[:, cols]`` (values moved, not
    recomputed)."""
    M[[p, q], cols] = M[[q, p], cols]


def _realify_diag(M):
    """Keep the Hermitian diagonal exactly real (LAPACK's zhetf2 reads
    DBLE(A(k,k))): rounding noise in its imaginary part would compound
    across the trailing updates."""
    if M.dtype.is_complex:
        torch.diagonal(M).imag.zero_()


def _pivot(M, k: int, n: int):
    """The Bunch-Kaufman pivot test at step k (BKLDLT.h:246-295): returns
    ``(use_1x1, swap_with_r, r)`` from one host read."""
    alpha = _ALPHA
    absakk = M[k, k].abs()
    col = M[k + 1:, k].abs()
    i = torch.argmax(col)  # the first of equal maxima, as jnp.argmax
    r = i + (k + 1)
    colmax = col[i]
    # rowmax = max |M[r, j]| over j >= k, j != r (M is kept full).
    row = M[r, k:].abs()
    j = torch.arange(k, n, device=M.device)
    rowmax = torch.where(j == r, -1.0, row).max().clamp(min=0.0)
    take_k_direct = absakk >= alpha * colmax
    take_k_rowtest = absakk * rowmax >= alpha * colmax * colmax
    take_r_1x1 = M[r, r].abs() >= alpha * rowmax
    direct, rowtest, r_1x1, r = torch.stack([
        take_k_direct.long(), take_k_rowtest.long(), take_r_1x1.long(), r
    ]).tolist()
    use_1x1 = bool(direct or rowtest or r_1x1)
    return use_1x1, bool(not direct and not rowtest and r_1x1), r


def factorize(A, shift=0.0) -> BKFactors:
    """Factorize ``A - shift I`` (A a full symmetric/Hermitian tensor),
    on A's device."""
    n = A.shape[0]
    dtype, device = A.dtype, A.device
    M = A.clone()
    torch.diagonal(M).sub_(shift)
    _realify_diag(M)
    L = torch.eye(n, dtype=dtype, device=device)
    d = torch.zeros(n, dtype=dtype, device=device)
    e = torch.zeros(n, dtype=dtype, device=device)
    is2x2 = [False] * n
    perm = list(range(n))
    ok = torch.ones((), dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    k = 0
    while k < n:
        # With no row below k, colmax is 0 and the 1x1 test passes.
        use_1x1, swap_with_r, r = (
            _pivot(M, k, n) if k + 1 < n else (True, False, k)
        )
        # the 2x2 pivot swaps row k+1 with r (BKLDLT.h:299-367)
        p = k if use_1x1 else k + 1
        q = (r if swap_with_r else p) if use_1x1 else r
        if p != q:
            _swap(M, p, q)
            _swap(M.mT, p, q)
            perm[p], perm[q] = perm[q], perm[p]
            # the columns of L written so far see the interchange too
            _swap(L, p, q, slice(0, k))
        if use_1x1:
            akk = M[k, k]
            sing = akk.abs() == 0.0
            mcol = M[k + 1:, k]
            lcol = mcol * torch.where(sing, zero, 1.0 / akk)
            M[k + 1:, k + 1:] -= torch.outer(lcol, mcol.conj())
            L[k + 1:, k] = lcol
            d[k] = akk
            step = 1
        else:
            a, b, c = M[k, k], M[k + 1, k], M[k + 1, k + 1]
            det = a * c - b * b.conj()
            sing = det.abs() == 0.0
            invdet = torch.where(sing, zero, 1.0 / det)
            # L2 = W inv(D2), inv(D2) = [[c, -conj(b)], [-b, a]] / det
            w1, w2 = M[k + 2:, k], M[k + 2:, k + 1]
            l1 = (w1 * c - w2 * b) * invdet
            l2 = (w2 * a - w1 * b.conj()) * invdet
            upd = torch.outer(l1, w1.conj()) + torch.outer(l2, w2.conj())
            M[k + 2:, k + 2:] -= upd
            L[k + 2:, k] = l1
            L[k + 2:, k + 1] = l2
            d[k], d[k + 1], e[k] = a, c, b
            is2x2[k] = True
            step = 2
        _realify_diag(M)
        ok &= ~sing
        k += step
    # A non-finite entry of A reaches a pivot through the trailing
    # updates; such factors would solve to NaN, or to finite garbage
    # for an infinite pivot.
    ok &= torch.isfinite(d).all() & torch.isfinite(e).all()
    return BKFactors(
        L=L, d=d, e=e,
        is2x2=torch.tensor(is2x2, dtype=torch.bool, device=device),
        perm=torch.tensor(perm, dtype=torch.int64, device=device),
        ok=bool(ok),
    )


def _block_diag_solve(fac: BKFactors, z):
    """Solve D w = z for the 1x1/2x2 block-diagonal D, for a block of
    columns z (n, m), with no loop.

    For a 2x2 block at (k, k+1) with D = [[a, conj(b)], [b, c]]:
      w[k]   = ( c z[k] - conj(b) z[k+1]) / det
      w[k+1] = (-b z[k] + a z[k+1]) / det
    (reference: BKLDLT.h:388-423 solves these with partial pivoting;
    the closed form is algebraically identical and branch-free).
    """
    d, e, is2 = fac.d, fac.e, fac.is2x2
    one = torch.ones(1, dtype=d.dtype, device=d.device)
    nil = torch.zeros(1, dtype=d.dtype, device=d.device)
    # second slot of each 2x2 block
    is2b = torch.cat([torch.zeros(1, dtype=torch.bool, device=d.device), is2[:-1]])
    only1 = (~(is2 | is2b))[:, None]
    zrow = torch.zeros_like(z[:1])
    z_next = torch.cat([z[1:], zrow])
    z_prev = torch.cat([zrow, z[:-1]])
    d_next = torch.cat([d[1:], one])
    d_prev = torch.cat([one, d[:-1]])
    e_prev = torch.cat([nil, e[:-1]])
    det = torch.where(is2, d * d_next - e * e.conj(), one)
    det_prev = torch.cat([one, det[:-1]])
    w_1x1 = z / torch.where(only1[:, 0], d, one)[:, None]
    w_2a = (d_next[:, None] * z - e.conj()[:, None] * z_next) / det[:, None]
    w_2b = (-e_prev[:, None] * z_prev + d_prev[:, None] * z) / det_prev[:, None]
    return torch.where(only1, w_1x1, torch.where(is2[:, None], w_2a, w_2b))


def solve(fac: BKFactors, b):
    """Solve ``(A - sigma I) x = b`` given the factorization, for a
    vector or a block of columns on the factors' device."""
    vec = b.ndim == 1
    B = (b[:, None] if vec else b).to(fac.L.dtype)
    Z = torch.linalg.solve_triangular(
        fac.L, B[fac.perm], upper=False, unitriangular=True
    )
    W = _block_diag_solve(fac, Z)
    Y = torch.linalg.solve_triangular(
        fac.L.mH, W, upper=True, unitriangular=True
    )
    X = torch.empty_like(Y)
    X[fac.perm] = Y
    return X[:, 0] if vec else X
