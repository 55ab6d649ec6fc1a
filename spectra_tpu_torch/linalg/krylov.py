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
    (seed, step, try), deterministic but not the JAX package's bits;
  * a deflated operator (``LockedArnoldiOp``) has every residual
    re-projected out of the locked block at birth (``_deflate_residual``).

Two further modes:
  * ``"lanczos_selective"``: Simon's omega-recurrence selective
    re-orthogonalization (:func:`_factorize_selective`). The recurrence
    is O(m) host arithmetic on the f64 H; only a triggered DGKS
    projection is n-length work on the device;
  * ``"arnoldi"`` for :func:`step_once` only: one full-projection step,
    which the thick restart uses to build its arrowhead column. The
    Arnoldi factorization of the general solvers waits for its slice
    (ROADMAP.md item 12).

The JAX package's ``split_*`` pieces, which cut a step into separately
compiled programs for its stepped driver, have no counterpart: this
loop already reads ``||f||`` on the host every step, so the stepped
driver runs this same code (``solvers/base.py``).
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


def _check_mode(mode: str, allowed=("lanczos", "lanczos_selective")) -> None:
    if mode in allowed:
        return
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


def _reorth_loop(arnop, V, f, beta: float, H, i: int, mode: str = "lanczos"):
    """DGKS iterative re-orthogonalization (<= 5 corrections).

    Updates f, beta and (in place) the H entries of column i per the
    reference rules: the tridiagonal entries in Lanczos mode, the whole
    column in Arnoldi mode. Returns (f, beta).
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
        if mode == "lanczos":
            hsub = H[i - 1, i].item() + coeffs[i - 1]
            H[i - 1, i] = hsub
            H[i, i - 1] = hsub
            H[i, i] += coeffs[i]
        else:
            # Full column correction h <- h + Vf (entries past i are zero
            # by the zero-row invariant of V).
            H[:, i] += Vf.to("cpu", torch.float64)
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


def _post_op(arnop, V, H, v, w, h_sub: float, i: int, mode: str = "lanczos"):
    """Everything after ``w = A v``: recurrence coefficients, residual,
    re-orthogonalization. Returns (f, beta); writes H in place."""
    if mode == "lanczos":
        f, beta = _lanczos_coeffs(arnop, V, H, v, w, h_sub, i)
        f, beta = _reorth_loop(arnop, V, f, beta, H, i)
    else:
        # Full Gram-Schmidt: h = V^T w over all current rows (the rows
        # past i are zero, so the full-width product is exact). The DGKS
        # loop is skipped when ||f|| > 0.717 ||h|| (Arnoldi.h:257).
        h = arnop.adjoint_product(V, w)
        f = w - basis_apply(V, h)
        h_host = h.to("cpu", torch.float64)
        H[:, i] = h_host
        H[i, i - 1] = h_sub
        beta = arnop.norm(f).item()
        if not beta > 0.717 * torch.linalg.vector_norm(h_host).item():
            f, beta = _reorth_loop(arnop, V, f, beta, H, i, mode)
    return _deflate_residual(arnop, f, beta)


def _deflate_residual(arnop, f, beta: float):
    """Deflated operators (``LockedArnoldiOp``): re-project the residual
    at birth so no basis vector carries locked-subspace components;
    ``arnop.deflate`` is the identity for every other operator. Without
    it, selections that prefer the deflated-to-zero end of the spectrum
    amplify rounding drift into span(locked) through the restart filter
    and converge to the deflation artifacts."""
    f2 = arnop.deflate(f)
    if f2 is f:
        return f, beta
    return f2, arnop.norm(f2).item()


def _pre_op(arnop, state: KrylovState, i: int, mode: str = "lanczos"):
    """Everything before ``w = A v``: breakdown detection (+ random
    expansion on breakdown) and basis extension, writing row i of V in
    place. Returns ``(v, h_sub, nops, restart)``."""
    V, _, f, beta, _, nops, seed = state
    eps_sqrt = math.sqrt(dtypes.eps(V.dtype))
    near_0 = dtypes.near_zero(V.dtype)

    restart = beta < near_0
    if mode == "lanczos" and not restart and beta < eps_sqrt:
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


def _step(arnop, state: KrylovState, i: int, mode: str = "lanczos") -> KrylovState:
    """One factorization step: extend from i columns to i+1."""
    v, h_sub, nops, _ = _pre_op(arnop, state, i, mode)
    w = arnop.perform_op(v)
    f, beta = _post_op(arnop, state.V, state.H, v, w, h_sub, i, mode)
    return state._replace(f=f, beta=beta, k=i + 1, nops=nops + 1)


def _step_selective(arnop, state: KrylovState, i: int, w_prev, w_cur,
                    force: bool):
    """One Lanczos step with selective re-orthogonalization (Simon 1984 /
    Parlett-Scott; the PROPACK recipe). The DGKS projection is paid only
    when the omega recurrence, an O(m) estimate of the orthogonality
    loss ``<v_{i+1}, v_j>`` driven by the computed alpha/beta
    coefficients, predicts loss above ``sqrt(eps/m)``; this keeps the
    basis semiorthogonal, enough for Ritz values accurate to machine
    precision (Simon, Math. Comp. 42 (1984) 115-142).

    Carries ``w_prev[j] ~ <v_{i-1}, v_j>`` and ``w_cur[j] ~ <v_i, v_j>``
    (host f64, length m); ``force`` re-orthogonalizes unconditionally
    (set on the first step after a restart, and on the step after any
    triggered re-orthogonalization: the Parlett-Scott pairwise rule).
    Returns ``(state, w_cur, w_new, force_next)``.
    """
    v, h_sub, nops, restarted = _pre_op(arnop, state, i)
    w = arnop.perform_op(v)
    f, beta, w_cur, w_new, force_next = _post_op_selective(
        arnop, state.V, state.H, v, w, h_sub, i, w_prev, w_cur, force,
        restarted,
    )
    state = state._replace(f=f, beta=beta, k=i + 1, nops=nops + 1)
    return state, w_cur, w_new, force_next


def _post_op_selective(arnop, V, H, v, w, h_sub: float, i: int, w_prev,
                       w_cur, force: bool, restarted: bool):
    """Everything after ``w = A v`` on the selective path: three-term
    recurrence, omega-recurrence estimate, conditional DGKS."""
    m, n = V.shape
    eps = dtypes.eps(V.dtype)
    near_0 = dtypes.near_zero(V.dtype)

    f, beta = _lanczos_coeffs(arnop, V, H, v, w, h_sub, i)

    # Trigger at sqrt(eps/m) (PROPACK's delta), not sqrt(eps): the m
    # accumulated omega-level components perturb Ritz values jointly,
    # so the per-column budget shrinks with the basis size.
    delta = math.sqrt(eps / m)

    # beta_i <v_{i+1}, v_j> = <v_i, A v_j> - alpha_i <v_i, v_j>
    #                         - beta_{i-1} <v_{i-1}, v_j>
    # with A v_j expanded by the three-term recurrence of column j.
    zero = torch.zeros(1, dtype=torch.float64)
    alpha_vec = H.diagonal()
    beta_vec = torch.cat([H.diagonal(-1), zero])  # couples v_j and v_{j+1}
    w_cur = w_cur.clone()
    w_cur[i] = 1.0
    alpha_i = H[i, i]
    beta_new = max(beta, near_0)

    up = torch.cat([w_cur[1:], zero])  # w_cur[j+1]
    dn = torch.cat([zero, w_cur[:-1]])  # w_cur[j-1]
    b_dn = torch.cat([zero, beta_vec[:-1]])
    w_new = (
        beta_vec * up + (alpha_vec - alpha_i) * w_cur + b_dn * dn
        - h_sub * w_prev
    ) / beta_new
    # Rounding-noise floor of the recurrence itself (PROPACK's theta).
    w_new = w_new + torch.sign(w_new) * (
        0.3 * eps * (beta_vec + beta_new) / beta_new
    )
    local = eps * math.sqrt(n)
    w_new[i:] = 0.0
    w_new[i] = local

    need = force or restarted or w_new.abs().max().item() > delta
    if need:
        f, beta = _reorth_loop(arnop, V, f, beta, H, i)
        w_new = torch.zeros(m, dtype=torch.float64)
        w_new[: i + 1] = local
    f, beta = _deflate_residual(arnop, f, beta)
    # Parlett-Scott: a triggered re-orthogonalization also forces one on
    # the following step (but a forced one does not cascade).
    return f, beta, w_cur, w_new, need and not force


def _factorize_selective(arnop, state: KrylovState, from_k: int) -> KrylovState:
    """:func:`factorize_from` with selective re-orthogonalization. The
    omega estimates live only inside this loop: the first step after
    every entry (init or restart compression, both of which invalidate
    the estimates) re-orthogonalizes unconditionally, and the entering
    basis is assumed semiorthogonal, the invariant this mode keeps."""
    m = state.V.shape[0]
    from_k = max(int(from_k), 1)
    seed = 0.25 * math.sqrt(dtypes.eps(state.V.dtype))
    w_prev = torch.zeros(m, dtype=torch.float64)
    w_prev[:from_k] = seed
    w_cur, force = w_prev.clone(), True
    for i in range(from_k, m):
        state, w_prev, w_cur, force = _step_selective(
            arnop, state, i, w_prev, w_cur, force
        )
    return state._replace(k=m)


def step_once(arnop, state: KrylovState, i: int, mode: str) -> KrylovState:
    """Public single factorization step (``"arnoldi"``: one
    full-projection step, as the thick restart builds its arrow
    column)."""
    _check_mode(mode, ("lanczos", "arnoldi"))
    return _step(arnop, state, int(i), mode)


def factorize_from(arnop, state: KrylovState, from_k, mode: str) -> KrylovState:
    """Extend the factorization from ``from_k`` steps to the full m."""
    _check_mode(mode)
    if mode == "lanczos_selective":
        return _factorize_selective(arnop, state, from_k)
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
