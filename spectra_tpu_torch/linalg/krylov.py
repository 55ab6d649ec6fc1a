"""Lanczos factorization: the hot loop of the symmetric solvers.

Port of the Lanczos mode of :mod:`spectra_tpu.linalg.krylov`. It keeps
the m-step factorization  A V = V H + f e_m^T  with V held ROW-MAJOR as
an (m, n) tensor (basis vector i in row V[i]), orthonormal, H the
m-by-m symmetric tridiagonal projection and f the residual.

Where the work runs: every n-length tensor (V, f and the operator's
data) stays on the operator's device. H, ``beta = ||f||`` and the
counters live on the host: H is a CPU f64 tensor, the replicated small
problem of the design, not a fallback. The JAX package's
``lax.while_loop``/``fori_loop`` driver becomes a host loop: each
data-dependent branch (the DGKS test, the breakdown test) reads one
scalar or one (m,) coefficient vector back with ``.item()``/``.cpu()``.
Unlike the functional reference, a step writes its new row of V and
its column of H in place.

The basis keeps the invariant that **rows >= k of V are exactly zero**,
so every projection is a full-width (m, n) product.

Numerical rules are carried over from the reference verbatim
(reference: include/Spectra/LinAlg/Lanczos.h:62-187, Arnoldi.h):
  * init forces v1 into range(A) and falls back to v0 when A v0 ~= 0;
  * the Cullum-Willoughby three-term recurrence plus an always-on DGKS
    re-orthogonalization loop (<= 5 corrections) with threshold
    ``ortho_err > eps * ||f||`` and a force-zero edge case at
    ``||f|| < eps * sqrt(n)``;
  * the near-breakdown test ``|<V_i, f/||f||>| > sqrt(eps)`` when
    ``||f|| < sqrt(eps)``;
  * breakdown triggers a random-restart ``_expand_basis`` (<= 5 random
    vectors, <= 3 corrections each, the first forced into range(A)).
    Its vectors come from a ``torch.Generator`` seeded from
    (seed, step, try), deterministic but not the JAX package's bits.

Selective re-orthogonalization and the split (stepped) pieces wait for
their slice (ROADMAP.md item 9).
"""

import math
from typing import NamedTuple

import torch

from spectra_tpu_torch.ops.gemv import basis_apply, basis_apply_block
from spectra_tpu_torch.util import dtypes
from spectra_tpu_torch.util.rng import uniform_m05_05


class KrylovState(NamedTuple):
    """The factorization state."""

    V: torch.Tensor  # (m, n) on the device, row-major; rows >= k zero
    H: torch.Tensor  # (m, m) CPU float64
    f: torch.Tensor  # (n,) on the device
    beta: float  # ||f||
    k: int  # current subspace dimension
    nops: int  # operator applications so far
    seed: int  # seeds the breakdown-restart generator


def _check_mode(mode: str) -> None:
    if mode == "lanczos":
        return
    if mode == "lanczos_selective":
        raise NotImplementedError(
            "selective re-orthogonalization waits for its slice: "
            "ROADMAP.md item 9"
        )
    raise NotImplementedError(
        f"mode {mode!r} (Arnoldi) waits for its slice: ROADMAP.md item 12"
    )


def _maxabs(coeffs) -> float:
    return max(abs(c) for c in coeffs)


def init(arnop, v0, m: int, seed: int = 0) -> KrylovState:
    """Build the 1-step factorization from the starting vector ``v0``.

    The caller must ensure ``||v0|| > 0`` (checked in the solver
    driver, mirroring the reference's invalid_argument).
    """
    n = v0.shape[0]
    dtype = v0.dtype
    eps = dtypes.eps(dtype)
    near_0 = dtypes.near_zero(dtype)

    # Force v into the range of A; if A v0 ~= 0, v0 itself is an
    # eigenvector for eigenvalue 0 and is used directly.
    v = arnop.perform_op(v0)
    vnorm = arnop.norm(v)
    if vnorm.item() < near_0:
        v = v0 / arnop.norm(v0)
    else:
        v = v / vnorm

    w = arnop.perform_op(v)
    h00 = arnop.inner_product(v, w)
    f = w - h00 * v

    # If v is already an eigenvector, f is pure rounding noise: force it
    # to zero so the next factorization step restarts cleanly.
    h00_h = h00.item()
    if f.abs().max().item() < eps * abs(h00_h):
        f = torch.zeros_like(f)
        beta = 0.0
    else:
        beta = arnop.norm(f).item()

    V = torch.zeros((m, n), dtype=dtype, device=v0.device)
    V[0] = v
    H = torch.zeros((m, m), dtype=torch.float64)
    H[0, 0] = h00_h
    return KrylovState(V=V, H=H, f=f, beta=beta, k=1, nops=2, seed=seed)


def _expand_basis(arnop, V, step: int, seed: int):
    """Find f != 0 with V^H f = 0 against the rows of V (rows past the
    current ones are zero by invariant).

    Returns (f, fnorm, extra_ops). Up to 5 random tries; the first is
    forced into range(A); each try gets <= 3 DGKS corrections.
    """
    n = V.shape[1]
    eps = dtypes.eps(V.dtype)
    Vp = arnop.ortho_basis(V)
    gen = torch.Generator(device=V.device)
    extra_ops = 0
    for it in range(5):
        gen.manual_seed((seed * 1_000_003 + step) * 8 + it)
        rand = uniform_m05_05(gen, n, V.dtype, V.device)
        if it == 0:
            f0 = arnop.perform_op(rand)
            extra_ops += 1
        else:
            f0 = arnop.deflate(rand)
        Vf = arnop.adjoint_product(Vp, f0)
        f = f0 - basis_apply(Vp, Vf)
        fnorm = arnop.norm(f).item()
        Vf = arnop.adjoint_product(Vp, f)
        ortho_err = Vf.abs().max().item()
        for _ in range(3):
            if ortho_err < eps * fnorm:
                break
            f = f - basis_apply(Vp, Vf)
            fnorm = arnop.norm(f).item()
            Vf = arnop.adjoint_product(Vp, f)
            ortho_err = Vf.abs().max().item()
        if ortho_err < eps * fnorm:
            break
    return f, fnorm, extra_ops


def _reorth_loop(arnop, V, f, beta: float, H, i: int):
    """DGKS iterative re-orthogonalization (<= 5 corrections).

    Updates f, beta and (in place) the H entries of column i per the
    reference rules. Returns (f, beta).
    """
    n = V.shape[1]
    eps = dtypes.eps(V.dtype)
    beta_thresh = eps * math.sqrt(n)

    Vp = arnop.ortho_basis(V)
    Vf = arnop.adjoint_product(Vp, f)
    coeffs = Vf.tolist()
    for _ in range(5):
        if not _maxabs(coeffs) > eps * beta:
            break
        if beta < beta_thresh:
            return torch.zeros_like(f), 0.0
        f = f - basis_apply(Vp, Vf)
        hsub = H[i - 1, i].item() + coeffs[i - 1]
        H[i - 1, i] = hsub
        H[i, i - 1] = hsub
        H[i, i] += coeffs[i]
        beta = arnop.norm(f).item()
        Vf = arnop.adjoint_product(Vp, f)
        coeffs = Vf.tolist()
    return f, beta


def _lanczos_coeffs(arnop, V, H, v, w, h_sub: float, i: int):
    """Three-term recurrence (Cullum & Willoughby ordering): alpha/beta
    coefficients, residual, H column write. No re-orthogonalization."""
    w = w - h_sub * V[i - 1]
    alpha = arnop.inner_product(v, w)
    f = w - alpha * v
    H[i, i - 1] = h_sub
    H[i - 1, i] = h_sub
    H[i, i] = alpha.item()
    return f, arnop.norm(f).item()


def _post_op(arnop, V, H, v, w, h_sub: float, i: int):
    """Everything after ``w = A v``: recurrence coefficients, residual,
    re-orthogonalization. Returns (f, beta); writes H in place."""
    f, beta = _lanczos_coeffs(arnop, V, H, v, w, h_sub, i)
    return _reorth_loop(arnop, V, f, beta, H, i)


def _pre_op(arnop, state: KrylovState, i: int):
    """Everything before ``w = A v``: breakdown detection (+ random
    expansion on breakdown) and basis extension, writing row i of V in
    place. Returns ``(v, h_sub, nops, restart)``."""
    V, _, f, beta, _, nops, seed = state
    eps_sqrt = math.sqrt(dtypes.eps(V.dtype))
    near_0 = dtypes.near_zero(V.dtype)

    restart = beta < near_0
    if not restart and beta < eps_sqrt:
        # Near-breakdown heuristic: when ||f|| is small, also test the
        # component of f/||f|| along the latest basis vector.
        v_cand = f / max(beta, near_0)
        viv = arnop.inner_product(V[i - 1], v_cand).item()
        restart = abs(viv) > eps_sqrt
    if restart:
        f, beta, extra = _expand_basis(arnop, V, i, seed)
        nops += extra

    v = f / max(beta, near_0)
    V[i] = v
    # H[i, i-1] is the unrestarted beta (0 after a restart).
    return v, 0.0 if restart else beta, nops, restart


def _step(arnop, state: KrylovState, i: int) -> KrylovState:
    """One factorization step: extend from i columns to i+1."""
    v, h_sub, nops, _ = _pre_op(arnop, state, i)
    w = arnop.perform_op(v)
    f, beta = _post_op(arnop, state.V, state.H, v, w, h_sub, i)
    return state._replace(f=f, beta=beta, k=i + 1, nops=nops + 1)


def step_once(arnop, state: KrylovState, i: int, mode: str) -> KrylovState:
    """Public single factorization step."""
    _check_mode(mode)
    return _step(arnop, state, int(i))


def factorize_from(arnop, state: KrylovState, from_k, mode: str) -> KrylovState:
    """Extend the factorization from ``from_k`` steps to the full m."""
    _check_mode(mode)
    m = state.V.shape[0]
    for i in range(max(int(from_k), 1), m):
        state = _step(arnop, state, i)
    return state._replace(k=m)


def compress(arnop, state: KrylovState, Q, H_new, k_new: int) -> KrylovState:
    """Apply the restart rotation: V <- V Q (truncated to k columns),
    H <- H_new, f <- f * Q[m-1, k-1] + (VQ)[:, k] * H_new[k, k-1].

    The dropped columns of Q are zeroed before the rotation, so the
    rotated basis comes out with exact zero rows past ``k_new`` and no
    third (m, n) buffer (reference: Arnoldi.h:321-340).
    """
    V, _, f, _, _, nops, seed = state
    m = V.shape[0]
    Qm = Q.clone()
    Qm[:, k_new:] = 0.0
    V_new = basis_apply_block(V, Qm.to(V.device, V.dtype))

    sigma = Q[m - 1, k_new - 1].item()
    vq_k = basis_apply(V, Q[:, k_new].to(V.device, V.dtype))
    f_new = f * sigma + vq_k * H_new[k_new, k_new - 1].item()
    beta_new = arnop.norm(f_new).item()

    H_masked = torch.zeros_like(H_new)
    H_masked[:k_new, :k_new] = H_new[:k_new, :k_new]
    return KrylovState(
        V=V_new, H=H_masked, f=f_new, beta=beta_new, k=k_new, nops=nops,
        seed=seed,
    )
