"""Lanczos and Arnoldi factorizations: the hot loop of the solvers.

Port of :mod:`spectra_tpu.linalg.krylov`. It keeps the m-step
factorization  A V = V H + f e_m^T  with V held ROW-MAJOR as an (m, n)
tensor (basis vector i in row V[i]), orthonormal, H the m-by-m
projection (symmetric tridiagonal for Lanczos, upper Hessenberg for
Arnoldi) and f the residual.

Where the work runs: every n-length tensor (V, f and the operator's
data) stays on the operator's device. H, ``beta = ||f||`` and the
counters live on the host: H is a CPU tensor, the replicated small
problem of the design, not a fallback. H is f64, and complex128 only
for the Arnoldi process on a complex operator: the Lanczos projection
of a Hermitian operator is real, so its entries are stored as their
real parts (``alpha = Re(v^H A v)``, ``beta = ||f||``), and the
restart pipeline of a complex Hermitian problem is the real one.
The JAX package's ``lax.while_loop``/``fori_loop`` driver becomes a
host loop: each data-dependent branch (the DGKS test, the breakdown
test) reads one scalar or one (m,) coefficient vector back with
``.item()``/``.cpu()``.
Unlike the functional reference, a step writes its new row of V and
its column of H in place.

The basis keeps the invariant that **rows >= k of V are exactly zero**,
so every projection is a full-width (m, n) product.

On a row mesh (an operator with a ``mesh``) V, f and every n-length
vector hold the rank's rows, n is the global size, and every value the
loop reads back is all-reduced by the :class:`ArnoldiOp`, so every rank
takes the same branches.

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
    re-projected out of the locked block at birth (``_deflate_residual``);
  * a structured operator (``has_structure``, the J-structured real
    embedding of a Hermitian matrix) orthogonalizes the start vector,
    every residual and every breakdown candidate against the wider
    ``arnop.ortho_basis(V)`` (``[V; J V]``), whose extra coefficients
    are not recorded in H; selective re-orthogonalization falls back to
    full there.

Two further modes:
  * ``"lanczos_selective"``: Simon's omega-recurrence selective
    re-orthogonalization (:func:`_factorize_selective`). The recurrence
    is O(m) host arithmetic on the f64 H; only a triggered DGKS
    projection is n-length work on the device;
  * ``"arnoldi"``: full Gram-Schmidt against every basis row, the DGKS
    loop skipped when ``||f|| > 0.717 ||h||`` (reference: Arnoldi.h:
    232-300). The general solvers factorize with it, and the thick
    restart builds its arrowhead column with one such step. A step
    reads its projection column and ``||f||`` to the host together,
    once.

:func:`compress` applies an implicit restart's rotation;
:func:`truncate_schur` the Krylov-Schur restart's truncation.

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
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.rng import uniform_m05_05


class KrylovState(NamedTuple):
    """The factorization state."""

    V: torch.Tensor  # (m, n) on the device, row-major; rows >= k zero
    H: torch.Tensor  # (m, m) CPU float64 (complex128 for a complex V)
    f: torch.Tensor  # (n,) on the device
    beta: float  # ||f||
    k: int  # current subspace dimension
    nops: int  # operator applications so far
    seed: int  # seeds the breakdown-restart generator


def _check_mode(mode: str, allowed) -> None:
    if mode not in allowed:
        raise ValueError(f"mode {mode!r}: use one of {', '.join(allowed)}")


def _host_dtype(dtype: torch.dtype, hermitian: bool) -> torch.dtype:
    """The dtype of H for basis dtype ``dtype``: c128 for the Arnoldi
    process on a complex basis, else f64."""
    return torch.complex128 if dtype.is_complex and not hermitian else torch.float64


def _h_entry(H, x):
    """``x`` as an entry (or column) of H: its real part where H is real,
    the projection of a Hermitian operator, whose imaginary parts are
    rounding."""
    return x if H.is_complex() else x.real


def _maxabs(coeffs) -> float:
    return max(abs(c) for c in coeffs)


def _structure_clean(arnop, v):
    """The start vector of a structured operator projected off its
    structural partners (``J v``) and renormalized: a rounding-level
    change, since v is J-orthogonal to itself analytically."""
    near_0 = dtypes.near_zero(v.dtype)
    sb = arnop.ortho_basis(v[None, :])[1:]
    v = v - basis_apply(sb, arnop.adjoint_product(sb, v))
    return v / max(arnop.norm(v).item(), near_0)


def init(arnop, v0, m: int, seed: int = 0, hermitian: bool = False) -> KrylovState:
    """Build the 1-step factorization from the starting vector ``v0``;
    ``hermitian`` (the Lanczos process) keeps H real for a complex
    operator.

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
    if arnop.has_structure:
        v = _structure_clean(arnop, v)

    w = arnop.perform_op(v)
    h00 = arnop.inner_product(v, w)
    f = w - h00 * v
    if arnop.has_structure:
        # Remove the structural (J-orbit) rounding components, so that
        # the next basis vector f/||f|| is structure-clean.
        jv = arnop.ortho_basis(v[None, :])[1:]
        f = f - basis_apply(jv, arnop.adjoint_product(jv, f))

    # If v is already an eigenvector, f is pure rounding noise: force it
    # to zero so the next factorization step restarts cleanly.
    h00_h = h00.item()
    if arnop.max_abs(f).item() < eps * abs(h00_h):
        f = torch.zeros_like(f)
        beta = 0.0
    else:
        beta = arnop.norm(f).item()

    V = torch.zeros((m, n), dtype=dtype, device=v0.device)
    V[0] = v
    H = torch.zeros((m, m), dtype=_host_dtype(dtype, hermitian))
    H[0, 0] = _h_entry(H, h00_h)
    return KrylovState(V=V, H=H, f=f, beta=beta, k=1, nops=2, seed=seed)


def _expand_basis(arnop, V, step: int, seed: int):
    """Find f != 0 with V^H f = 0 against the rows of V (rows past the
    current ones are zero by invariant).

    Returns (f, fnorm, extra_ops). Up to 5 random tries; the first is
    forced into range(A); each try gets <= 3 DGKS corrections. On a row
    mesh every rank draws the whole n-vector and keeps its rows, so a
    sharded run restarts where the single-device one does.
    """
    n = arnop.rows()
    eps = dtypes.eps(V.dtype)
    Vp = arnop.ortho_basis(V)
    gen = torch.Generator(device=V.device)
    extra_ops = 0
    for it in range(5):
        gen.manual_seed((seed * 1_000_003 + step) * 8 + it)
        rand = uniform_m05_05(gen, n, V.dtype, V.device)
        if arnop.mesh is not None:
            rand = arnop.mesh.local_rows(rand)
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
    column in Arnoldi mode. Only the leading V-coefficients enter H; a
    structured operator's extra ones are noise removal. Returns
    (f, beta).
    """
    with span("krylov.reorth"):
        m, n = V.shape[0], arnop.rows()
        eps = dtypes.eps(V.dtype)
        beta_thresh = eps * math.sqrt(n)

        Vp = arnop.ortho_basis(V)
        Vf = arnop.adjoint_product(Vp, f)
        Vf_host = Vf.cpu()
        coeffs = Vf_host.tolist()
        for _ in range(5):
            if not _maxabs(coeffs) > eps * beta:
                break
            if beta < beta_thresh:
                return torch.zeros_like(f), 0.0
            f = f - basis_apply(Vp, Vf)
            if mode == "lanczos":
                hsub = H[i - 1, i].item() + _h_entry(H, coeffs[i - 1])
                H[i - 1, i] = hsub
                H[i, i - 1] = hsub
                H[i, i] += _h_entry(H, coeffs[i])
            else:
                # Full column correction h <- h + Vf (entries past i are zero
                # by the zero-row invariant of V).
                H[:, i] += _h_entry(H, Vf_host[:m]).to(H.dtype)
            Vf, fnorm = arnop.adjoint_and_norm(Vp, f)
            Vf_host, beta = _read_with_norm(Vf, fnorm)
            coeffs = Vf_host.tolist()
        return f, beta


def _read_with_norm(x, norm):
    """``(x on the host, float(norm))`` in one device-to-host read (on a
    row mesh, after the one all-reduce of :meth:`ArnoldiOp.
    adjoint_and_norm`)."""
    host = torch.cat([x, norm.reshape(1).to(x.dtype)]).cpu()
    return host[:-1], host[-1].real.item()


def _lanczos_coeffs(arnop, V, H, v, w, h_sub: float, i: int):
    """Three-term recurrence (Cullum & Willoughby ordering): alpha/beta
    coefficients, residual, H column write. No re-orthogonalization."""
    w = w - h_sub * V[i - 1]
    alpha = arnop.inner_product(v, w)
    f = w - alpha * v
    H[i, i - 1] = h_sub
    H[i - 1, i] = h_sub
    H[i, i] = _h_entry(H, alpha.item())
    return f, arnop.norm(f).item()


def _post_op(arnop, V, H, v, w, h_sub: float, i: int, mode: str = "lanczos"):
    """Everything after ``w = A v``: recurrence coefficients, residual,
    re-orthogonalization. Returns (f, beta); writes H in place."""
    if mode == "lanczos":
        f, beta = _lanczos_coeffs(arnop, V, H, v, w, h_sub, i)
        f, beta = _reorth_loop(arnop, V, f, beta, H, i)
    else:
        # Full Gram-Schmidt: h = V^T w over all current rows (the rows
        # past i are zero, so the full-width product is exact), against
        # the widened basis of a structured operator, whose leading
        # V-coefficients alone enter H. The DGKS loop is skipped when
        # ||f|| > 0.717 ||h|| (Arnoldi.h:257).
        Vp = arnop.ortho_basis(V)
        h = arnop.adjoint_product(Vp, w)
        f = w - basis_apply(Vp, h)
        h_host, beta = _read_with_norm(h, arnop.norm(f))
        h_host = h_host[: V.shape[0]]
        H[:, i] = _h_entry(H, h_host).to(H.dtype)
        H[i, i - 1] = h_sub
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
    with span("krylov.step"):
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
    with span("krylov.step"):
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
    m, n = V.shape[0], arnop.rows()
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
    """Extend the factorization from ``from_k`` steps to the full m. A
    structured operator runs ``"lanczos_selective"`` as ``"lanczos"``:
    the omega recurrence does not model its extra projections."""
    _check_mode(mode, ("lanczos", "lanczos_selective", "arnoldi"))
    if mode == "lanczos_selective":
        if not arnop.has_structure:
            return _factorize_selective(arnop, state, from_k)
        mode = "lanczos"
    m = state.V.shape[0]
    for i in range(max(int(from_k), 1), m):
        state = _step(arnop, state, i, mode)
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


def truncate_schur(arnop, state: KrylovState, U, T_new, k_new: int) -> KrylovState:
    """Krylov-Schur truncation: V <- V U (the first ``k_new`` columns
    kept), H <- the leading k x k block of the ordered quasi-triangular
    T, the residual f UNCHANGED.

    Rotating into an ordered Schur basis leaves the residual invariant:
    ``A (V U_k) = (V U_k) T_k + f (e_m^T U_k)``. The spike row
    ``e_m^T U_k`` replaces the Arnoldi coupling ``beta e_k^T`` and is
    written into H's row ``k_new`` by the caller after re-expansion
    (the first step of :func:`factorize_from` overwrites
    ``H[k, k-1]``). Stewart's Krylov-Schur restart; the reference
    restarts only by shifted-QR sweeps (GenEigsBase.h:44-140)."""
    V, _, f, beta, _, nops, seed = state
    # Masked rotation (see compress): no third (m, n) buffer.
    Um = U.clone()
    Um[:, k_new:] = 0.0
    V_new = basis_apply_block(V, Um.to(V.device, V.dtype))
    H_masked = torch.zeros_like(state.H)
    H_masked[:k_new, :k_new] = T_new[:k_new, :k_new]
    return KrylovState(
        V=V_new, H=H_masked, f=f, beta=beta, k=k_new, nops=nops, seed=seed,
    )
