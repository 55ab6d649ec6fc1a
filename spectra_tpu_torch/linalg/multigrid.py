"""Geometric multigrid inner solver for grid-structured shift systems.

Port of :mod:`spectra_tpu.linalg.multigrid`, single device. For
operators that live on a regular 1-/2-/3-D grid, multigrid needs O(1)
V-cycles per digit, independent of n, where a Krylov inner solve needs
O(sqrt(kappa)) iterations.

* The hierarchy is built once on the host from the scipy CSR of the
  shifted matrix: Galerkin coarse operators ``A_c = P^T (A P)`` with the
  tensor-product linear prolongation, by the threaded Gustavson product
  of the port's native sparse toolkit (:func:`~spectra_tpu_torch.native.
  galerkin_rap`), and the smoother's ``lambda_max(D^-1 A)`` by a power
  iteration over its threaded CSR matvec, as in the JAX package. Each
  coarse entry is summed by one thread in a fixed order, so the
  hierarchy is bitwise the JAX package's on the same host. Each level
  goes to the device through :func:`dia_device_from_scipy`, so the large
  f64 levels on the card become hi/lo planes as in the JAX package.
* Grid transfers on the device are strided-slice tensor operations
  (restrict = [1/2, 1, 1/2] per axis, prolong its transpose); no stored
  transfer matrices.
* The V-cycle: Chebyshev-Jacobi smoothing (no reductions), a dense
  precomputed inverse at the coarsest level. :func:`mg_solve` is a host
  loop that reads one residual norm per cycle (the JAX ``while_loop``).

``CYCLES`` and ``SOLVES`` count the V-cycles and the calls of
:func:`mg_solve` and of the sharded ``mg_solve_sharded`` since import
(a caller may reset them to 0), so a run can derive the SpMVs its
solves made.
"""

import dataclasses
import math

import numpy as np
import torch

from spectra_tpu_torch.ops.gemv import vec_norm
from spectra_tpu_torch.util.capabilities import resolve_device

#: V-cycles run by :func:`mg_solve` (and the sharded solve) since import.
CYCLES = 0
#: Calls of :func:`mg_solve` (and the sharded solve) since import.
SOLVES = 0


class MGBuildError(RuntimeError):
    """The matrix is not (recognizably) a regular-grid stencil."""


# ---------------------------------------------------------------------------
# Grid inference (copied from the JAX package: pure Python)
# ---------------------------------------------------------------------------


def _decompose_offset(off, strides, radius):
    """Write ``off`` as sum_d c_d * strides[d] with |c_d| <= radius;
    strides descending. Returns the coefficient list or None."""
    cs = []
    rem = off
    for s in strides:
        c = int(round(rem / s))
        c = max(-radius, min(radius, c))
        best, best_rem = None, None
        for cand in (c - 1, c, c + 1):
            if abs(cand) > radius:
                continue
            r2 = rem - cand * s
            if best is None or abs(r2) < abs(best_rem):
                best, best_rem = cand, r2
        cs.append(best)
        rem = best_rem
    if rem != 0:
        return None
    return cs


def infer_grid_dims(offsets, n, radius: int = 2):
    """Infer row-major grid dimensions from DIA offsets such that every
    offset decomposes into per-axis steps of magnitude <= ``radius``
    (1-D, then 2-D, then 3-D). Returns the candidate with the smallest
    total stencil extent, or None."""
    offsets = sorted(set(int(o) for o in offsets))
    pos = [o for o in offsets if o > 0]
    candidates = []

    if not pos or max(pos) <= radius:
        candidates.append(((n,), sum(abs(o) for o in offsets)))

    strides_2d = set()
    for o in pos:
        for s in (o - 1, o, o + 1):
            if s > radius and n % s == 0 and n // s >= 2:
                strides_2d.add(s)
    for gx in sorted(strides_2d):
        gy = n // gx
        cost = 0
        ok = True
        for o in offsets:
            cs = _decompose_offset(o, (gx, 1), radius)
            if cs is None or abs(cs[1]) >= gx:
                ok = False
                break
            cost += abs(cs[0]) + abs(cs[1])
        if ok:
            candidates.append(((gy, gx), cost))

    strides_pairs = set()
    for s1 in sorted(strides_2d):
        for o in pos:
            for s2 in (o - 1, o, o + 1):
                if (
                    s2 > s1
                    and s2 % s1 == 0
                    and n % s2 == 0
                    and s2 // s1 >= 2
                    and n // s2 >= 2
                ):
                    strides_pairs.add((s1, s2))
    for s1, s2 in sorted(strides_pairs):
        gx, gy, gz = s1, s2 // s1, n // s2
        cost = 0
        ok = True
        for o in offsets:
            cs = _decompose_offset(o, (s2, s1, 1), radius)
            if cs is None or abs(cs[2]) >= gx or abs(cs[1]) >= gy:
                ok = False
                break
            cost += sum(abs(c) for c in cs)
        if ok:
            candidates.append(((gz, gy, gx), cost))

    if not candidates:
        return None
    # fewest axis-steps first; on ties fewer axes, then balanced dims
    candidates.sort(key=lambda c: (c[1], len(c[0]), max(c[0])))
    return candidates[0][0]


# ---------------------------------------------------------------------------
# Host transfer matrices (for the Galerkin products and the tests)
# ---------------------------------------------------------------------------


def prolong_1d_matrix(g: int, boundary: str = "clip"):
    """The 1-D linear-interpolation prolongation ``P`` (g x gc): coarse
    point i at fine point 2i, P[2i, i] = 1, P[2i+1, i] = P[2i+1, i+1] =
    1/2. For even g the boundary-clipped odd point weighs 1/2
    (``"clip"``, Dirichlet-type) or 1 (``"const"``, so ``P 1 = 1``)."""
    import scipy.sparse as sps

    gc = (g + 1) // 2
    rows, cols, vals = [], [], []
    for i in range(gc):
        rows.append(2 * i)
        cols.append(i)
        vals.append(1.0)
    for j in range(1, g, 2):
        i = (j - 1) // 2
        if i + 1 < gc:
            rows.extend([j, j])
            cols.extend([i, i + 1])
            vals.extend([0.5, 0.5])
        else:
            rows.append(j)
            cols.append(i)
            vals.append(1.0 if boundary == "const" else 0.5)
    return sps.csr_matrix((vals, (rows, cols)), shape=(g, gc))


def prolong_matrix(dims, boundary: str = "clip"):
    """Tensor-product prolongation ``P = P_0 (x) P_1 (x) ...`` for
    row-major ``dims``, assembled in one pass as a fixed-width (2^d per
    row) CSR, explicit zeros dropped at the end."""
    import scipy.sparse as sps

    C = np.zeros((1, 1), np.int64)
    V = np.ones((1, 1), np.float64)
    nr = nc = 1
    for g in dims:
        f = prolong_1d_matrix(g, boundary).tocsr()
        f.sort_indices()
        gc = f.shape[1]
        cnt = np.diff(f.indptr)
        if cnt.max() > 2:
            raise MGBuildError("prolongation factor wider than 2/row")
        c2 = np.empty((g, 2), np.int64)
        v2 = np.zeros((g, 2), np.float64)
        first = f.indices[f.indptr[:-1]]
        c2[:, 0] = first
        c2[:, 1] = first
        v2[:, 0] = f.data[f.indptr[:-1]]
        two = cnt == 2
        c2[two, 1] = f.indices[f.indptr[:-1][two] + 1]
        v2[two, 1] = f.data[f.indptr[:-1][two] + 1]
        w = C.shape[1]
        C = (C[:, None, :, None] * gc + c2[None, :, None, :]).reshape(
            nr * g, w * 2
        )
        V = (V[:, None, :, None] * v2[None, :, None, :]).reshape(
            nr * g, w * 2
        )
        nr *= g
        nc *= gc
    w = C.shape[1]
    indptr = np.arange(nr + 1, dtype=np.int64) * w
    P = sps.csr_matrix(
        (V.ravel(), C.ravel().astype(np.int32), indptr), shape=(nr, nc)
    )
    P.eliminate_zeros()
    return P


def coarse_dims(dims):
    return tuple((g + 1) // 2 for g in dims)


# ---------------------------------------------------------------------------
# Device transfers: strided tensor operations
# ---------------------------------------------------------------------------


def _restrict_axis_last(x, g: int, gc: int, boundary: str):
    """R = P^T along the last axis: uc[i] = u[2i] + (u[2i-1] + u[2i+1])/2;
    with ``"const"`` (even g) the clipped boundary point counts fully."""
    xp = torch.nn.functional.pad(x, (1, 1))
    center = xp[..., 1 : 2 * gc : 2]
    left = xp[..., 0 : 2 * gc : 2]
    right = xp[..., 2 : 2 * gc + 2 : 2]
    out = center + 0.5 * (left + right)
    if boundary == "const" and g % 2 == 0:
        out[..., -1] += 0.5 * x[..., -1]
    return out


def _prolong_axis_last(c, gc: int, g: int, boundary: str):
    """P along the last axis: y[2i] = c[i], y[2i+1] = (c[i] + c[i+1])/2;
    with ``"const"`` the clipped odd point takes c[gc-1] fully."""
    n_odd = g // 2
    if boundary == "const":
        cpad = torch.cat([c, c[..., -1:]], dim=-1)
    else:
        cpad = torch.nn.functional.pad(c, (0, 1))
    odd = 0.5 * (c + cpad[..., 1 : gc + 1])
    y = torch.zeros(c.shape[:-1] + (g,), dtype=c.dtype, device=c.device)
    y[..., 0::2] = c
    y[..., 1::2] = odd[..., :n_odd]
    return y


def _apply_per_axis(x_flat, dims_in, dims_out, axis_op, boundary):
    x = x_flat.reshape(dims_in)
    for ax in range(len(dims_in)):
        x = torch.movedim(x, ax, -1)
        x = axis_op(x, dims_in[ax], dims_out[ax], boundary)
        x = torch.movedim(x, -1, ax)
    return x.reshape(-1)


def restrict_nd(r_flat, dims_f, dims_c, boundary: str = "clip"):
    """Device restriction ``P^T r`` by per-axis strided slices."""
    return _apply_per_axis(r_flat, dims_f, dims_c, _restrict_axis_last, boundary)


def prolong_nd(e_flat, dims_c, dims_f, boundary: str = "clip"):
    """Device prolongation ``P e`` by per-axis strided updates."""
    return _apply_per_axis(e_flat, dims_c, dims_f, _prolong_axis_last, boundary)


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class MGState:
    """One built hierarchy. ``ops[l]`` is the level-l device operator
    (finest = the shifted matrix), ``inv_diags[l]`` its Jacobi scaling,
    ``lam_max[l]`` the (overestimated) largest eigenvalue of
    ``D^{-1} A_l`` (a Python float) for the Chebyshev-Jacobi smoother,
    ``coarse_inv`` the dense inverse of the coarsest operator.
    ``dims_per_level`` includes the coarsest level's dims."""

    ops: tuple
    inv_diags: tuple
    lam_max: tuple
    coarse_inv: torch.Tensor
    dims_per_level: tuple
    nu1: int = 2
    nu2: int = 2
    boundary: str = "clip"

    @property
    def n(self) -> int:
        return int(np.prod(self.dims_per_level[0]))

    def solve(self, b, rtol=1e-12, maxiter: int = 100, x0=None):
        """:func:`mg_solve` on this hierarchy."""
        return mg_solve(self, b, rtol, maxiter, x0)


def _lam_max_jacobi(csr, diag, iters: int = 12, seed: int = 7) -> float:
    """Overestimate of ``lambda_max(D^{-1} A)``: power iteration over
    the native threaded CSR matvec, plus 15 %."""
    from spectra_tpu_torch.native import csr_matvec_builder

    mv = csr_matvec_builder(csr)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=csr.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    inv_diag = 1.0 / diag
    for _ in range(iters):
        w = mv(v) * inv_diag
        lam = float(np.linalg.norm(w))
        if lam == 0 or not np.isfinite(lam):
            raise MGBuildError("D^{-1} A power iteration degenerated")
        v = w / lam
    return 1.15 * lam


def resolve_grid(shifted_csr, dims=None, max_diags: int = 40):
    """``(csr, dims, boundary)`` for a grid-stencil matrix: ``dims``
    inferred from the sparsity when not given, the transfer boundary
    mode from the row sums (near-zero everywhere: ``"const"``). Raises
    :class:`MGBuildError` when the matrix is not a grid stencil."""
    A = shifted_csr.tocsr()
    n = A.shape[0]
    if dims is None:
        coo = A.tocoo()
        offsets = np.unique(coo.col - coo.row)
        if len(offsets) > max_diags:
            raise MGBuildError(
                f"{len(offsets)} distinct diagonals — not a grid stencil"
            )
        dims = infer_grid_dims(offsets, n)
        if dims is None:
            raise MGBuildError("no grid shape matches the sparsity")
    dims = tuple(int(g) for g in dims)
    if int(np.prod(dims)) != n:
        raise MGBuildError(f"grid {dims} does not match n={n}")
    rowsum = np.abs(A @ np.ones(n))
    dmax = np.abs(A.diagonal()).max()
    boundary = "const" if rowsum.max() <= 0.1 * dmax else "clip"
    return A, dims, boundary


def build_level_chain(A, dims, boundary: str, max_coarse_n: int = 1024,
                      min_dim: int = 3, max_diags: int = 40):
    """Galerkin-coarsen ``A`` down to ``max_coarse_n``: returns
    ``(levels, coarse_inv, dims_per_level)``, each level a host dict
    ``{csr, inv_diag, lam, dims}``, ``coarse_inv`` the dense inverse of
    the coarsest operator."""
    levels = []
    dims_per_level = []
    level_csr, level_dims = A, dims
    # Coarsen at least once whenever the grid allows it.
    while min(level_dims) >= 2 * min_dim and (
        not levels or int(np.prod(level_dims)) > max_coarse_n
    ):
        coo = level_csr.tocoo()
        if len(np.unique(coo.col - coo.row)) > max_diags:
            raise MGBuildError("coarse operator stopped being banded")
        del coo
        diag = level_csr.diagonal()
        if np.any(diag == 0) or not np.all(np.isfinite(diag)):
            raise MGBuildError("zero/nonfinite diagonal — Jacobi smoother n/a")
        levels.append(
            {
                "csr": level_csr,
                "inv_diag": 1.0 / diag,
                "lam": _lam_max_jacobi(level_csr, diag),
                "dims": level_dims,
            }
        )
        dims_per_level.append(level_dims)
        P = prolong_matrix(level_dims, boundary)
        from spectra_tpu_torch.native import galerkin_rap

        level_csr = galerkin_rap(level_csr, P).tocsr()
        level_csr.sum_duplicates()
        # Drop numerically-zero fill so the coarse DIA stays tight.
        level_csr.data[np.abs(level_csr.data) < 1e-300] = 0.0
        level_csr.eliminate_zeros()
        level_dims = coarse_dims(level_dims)

    if not levels:
        raise MGBuildError(f"grid {dims} too small for a hierarchy")
    dims_per_level.append(level_dims)
    dense = np.asarray(level_csr.todense(), dtype=np.float64)
    if not np.all(np.isfinite(dense)):
        raise MGBuildError("nonfinite coarse operator")
    cond = np.linalg.cond(dense)
    if not np.isfinite(cond) or cond > 1e13:
        raise MGBuildError(f"coarsest level ill-conditioned (cond={cond:.2e})")
    coarse_inv = np.linalg.inv(dense)
    return levels, coarse_inv, dims_per_level


def mg_state_from_chain(levels, coarse_inv, dims_per_level, boundary, nu1=2,
                        nu2=2, dtype=None, device=None, level0=None):
    """Assemble an :class:`MGState` on ``device`` from a host chain.
    ``level0``, when given, is the caller's device operator of the
    finest level (the shifted matrix itself), used instead of a second
    copy."""
    from spectra_tpu_torch.sparse.formats import dia_device_from_scipy

    device = resolve_device(device)
    cast = (lambda a: a) if dtype is None else (lambda a: a.astype(dtype))

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ops = tuple(
        level0 if (lv == 0 and level0 is not None)
        else dia_device_from_scipy(levels[lv]["csr"], dtype=dtype, device=device)
        for lv in range(len(levels))
    )
    return MGState(
        ops=ops,
        inv_diags=tuple(to_dev(cast(lv["inv_diag"])) for lv in levels),
        lam_max=tuple(float(lv["lam"]) for lv in levels),
        coarse_inv=to_dev(
            cast(coarse_inv)
            if dtype is not None
            else coarse_inv.astype(levels[0]["csr"].dtype)
        ),
        dims_per_level=tuple(dims_per_level),
        nu1=int(nu1),
        nu2=int(nu2),
        boundary=boundary,
    )


def build_mg(shifted_csr, dims=None, max_coarse_n: int = 1024,
             min_dim: int = 3, nu1: int = 2, nu2: int = 2,
             max_diags: int = 40, dtype=None, boundary: str = "auto",
             device=None, level0=None):
    """Build an :class:`MGState` for a grid-stencil ``shifted_csr``
    (already ``A - sigma I``) on ``device`` (``None`` means the GPU).
    Raises :class:`MGBuildError` when no grid structure is found, when a
    coarse operator stops being banded, or when the coarsest matrix is
    numerically singular."""
    A, dims, auto_boundary = resolve_grid(shifted_csr, dims, max_diags)
    if boundary == "auto":
        boundary = auto_boundary
    levels, coarse_inv, dims_per_level = build_level_chain(
        A, dims, boundary, max_coarse_n, min_dim, max_diags
    )
    return mg_state_from_chain(
        levels, coarse_inv, dims_per_level, boundary, nu1, nu2, dtype,
        device, level0,
    )


# ---------------------------------------------------------------------------
# V-cycle and solve
# ---------------------------------------------------------------------------


def _smooth(op, inv_diag, lam, x, b, degree):
    """Degree-``degree`` Chebyshev-Jacobi smoother on ``[lam/4, lam]`` of
    ``D^{-1} A``: ``degree`` SpMVs and elementwise work, no reductions."""
    a = lam / 4.0
    theta = (lam + a) / 2.0
    delta = (lam - a) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    r = inv_diag * (b - op.matvec(x))
    d = r / theta
    for _ in range(degree - 1):
        x = x + d
        r = r - inv_diag * op.matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def v_cycle(mg: MGState, b, x):
    """One V(nu1, nu2) cycle over the levels. Level l makes
    ``nu1 + 1 + nu2`` SpMVs with ``mg.ops[l]``."""

    def go(lv, b, x):
        if lv == len(mg.ops):
            return mg.coarse_inv @ b
        op, inv_d, lam = mg.ops[lv], mg.inv_diags[lv], mg.lam_max[lv]
        x = _smooth(op, inv_d, lam, x, b, mg.nu1)
        r = b - op.matvec(x)
        dims, dims_c = mg.dims_per_level[lv], mg.dims_per_level[lv + 1]
        rc = restrict_nd(r, dims, dims_c, mg.boundary)
        ec = go(lv + 1, rc, torch.zeros_like(rc))
        x = x + prolong_nd(ec, dims_c, dims, mg.boundary)
        return _smooth(op, inv_d, lam, x, b, mg.nu2)

    return go(0, b, x)


def mg_solve(mg: MGState, b, rtol=1e-12, maxiter: int = 100, x0=None):
    """Stationary multigrid ``x += V(b - A x)`` to relative residual
    ``rtol``, as a host loop reading one norm per cycle. Stops early
    when a cycle (after the fourth) no longer takes 20 % off the
    residual. Returns ``(x, cycles)``. One solve makes
    ``1 + cycles`` SpMVs with ``mg.ops[0]`` besides the V-cycles'."""
    return stationary_solve(
        mg.ops[0], lambda r: v_cycle(mg, r, torch.zeros_like(r)), b, rtol,
        maxiter, x0,
    )


def stationary_solve(op, cycle, b, rtol, maxiter: int, x0=None, mesh=None):
    """The loop of :func:`mg_solve` for any cycle ``cycle(r)`` (an
    approximate ``A^{-1} r``) and operator ``op``; ``mesh`` all-reduces
    the norms of row-sharded vectors (the sharded multigrid)."""
    global CYCLES, SOLVES
    b = b.to(op.dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(op.dtype)
    bnorm = float(vec_norm(b, mesh))
    tol = rtol * max(bnorm, float(torch.finfo(op.dtype).tiny))
    r = b - op.matvec(x)
    rn, rn_prev = float(vec_norm(r, mesh)), math.inf
    k = 0
    # A healthy V(2,2) cycle contracts 5-10x; one that no longer shaves
    # 20 % is not contracting (sigma inside the spectrum), and the rest
    # of maxiter would not help.
    while rn > tol and k < maxiter and (rn < 0.8 * rn_prev or k < 4):
        x = x + cycle(r)
        r = b - op.matvec(x)
        rn, rn_prev = float(vec_norm(r, mesh)), rn
        k += 1
    CYCLES += k
    SOLVES += 1
    return x, k
