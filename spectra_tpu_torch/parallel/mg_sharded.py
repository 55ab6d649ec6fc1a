"""Row-sharded geometric multigrid: the distributed inner solve.

Port of :mod:`spectra_tpu.parallel.mg_sharded`. Vectors are
row-sharded with rank boundaries on planes of the FIRST grid axis.
Per level:

* smoothing is the single-device Chebyshev-Jacobi smoother
  (:func:`~spectra_tpu_torch.linalg.multigrid._smooth`) over the
  halo-exchange stencil SpMV (:class:`~spectra_tpu_torch.parallel.
  stencil_spmv.ShardedStencilMatProd`: one exchange and one K1 launch a
  product) and elementwise work on the rank's rows;
* the grid transfers along the unsharded axes are the single-device
  ones on the rank's planes; along the sharded axis each rank exchanges
  ONE boundary plane with a neighbour (:func:`make_restrict0`,
  :func:`make_prolong0`);
* coarsening halves the planes of a rank, so a level is shardable while
  ``g0 % ranks == 0`` with an even plane count a rank
  (:func:`shardable_levels`); below that the cycle switches to a
  REPLICATED tail hierarchy after one all-gather of the switch level's
  residual a V-cycle.

The sharded transfers apply the single-device weights, so the sharded
V-cycle computes the single-device iteration up to the order of sums.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.linalg.multigrid import (
    MGBuildError,
    MGState,
    _prolong_axis_last,
    _restrict_axis_last,
    _smooth,
    build_level_chain,
    mg_state_from_chain,
    resolve_grid,
    stationary_solve,
    v_cycle,
)
from spectra_tpu_torch.parallel.mesh import RowMesh, global_put
from spectra_tpu_torch.parallel.stencil_spmv import ShardedStencilMatProd, host_dia


def _local_other_axes(x, dims_from, dims_to, op_axis_last, boundary):
    """A 1-D transfer along every axis but the sharded axis 0 of the
    rank's block ``x`` (p, *dims_from[1:])."""
    for ax in range(1, len(dims_from)):
        x = torch.movedim(x, ax, -1)
        x = op_axis_last(x, dims_from[ax], dims_to[ax], boundary)
        x = torch.movedim(x, -1, ax)
    return x


def make_restrict0(mesh: RowMesh, axis: str, dims_f: tuple, dims_c: tuple,
                   boundary: str):
    """The sharded restriction, flat rank rows of the fine level to flat
    rank rows of the coarse one: the unsharded axes on the rank's
    planes, then axis 0 with the left neighbour's last plane (one
    exchange)."""
    p = dims_f[0] // mesh.size

    def restrict(x_flat):
        x = x_flat.reshape((p,) + tuple(dims_f[1:]))
        x = _local_other_axes(x, dims_f, dims_c, _restrict_axis_last, boundary)
        xp = mesh.halo(x, 1, 0)  # (p + 1, ...): the left plane first
        uc = xp[1:p:2] + 0.5 * (xp[0:p:2] + xp[2 : p + 1 : 2])
        if boundary == "const" and mesh.rank == mesh.size - 1:
            # the global last fine plane counts fully
            uc[-1] += 0.5 * x[-1]
        return uc.reshape(-1)

    return restrict


def make_prolong0(mesh: RowMesh, axis: str, dims_c: tuple, dims_f: tuple,
                  boundary: str):
    """The sharded prolongation, flat rank rows of the coarse level to
    flat rank rows of the fine one: axis 0 with the right neighbour's
    first plane (one exchange), then the unsharded axes."""
    pc = dims_c[0] // mesh.size

    def prolong(c_flat):
        c = c_flat.reshape((pc,) + tuple(dims_c[1:]))
        cnext = mesh.halo(c, 0, 1)[1:]  # c[1:] and the right plane
        if boundary == "const" and mesh.rank == mesh.size - 1:
            cnext[-1] = c[-1]
        odd = 0.5 * (c + cnext)
        y = torch.stack([c, odd], dim=1).reshape((2 * pc,) + c.shape[1:])
        y = _local_other_axes(
            y, (2 * pc,) + tuple(dims_c[1:]), (2 * pc,) + tuple(dims_f[1:]),
            _prolong_axis_last, boundary,
        )
        return y.reshape(-1)

    return prolong


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMGState:
    """A sharded hierarchy: ``s_ops[l]`` are halo-exchange stencil
    operators (vectors row-sharded), ``s_inv_diags[l]`` their rank's
    Jacobi scaling, ``s_lam[l]`` the smoother's bound (floats);
    ``bottom`` is the replicated tail, possibly of no level (then only
    the dense coarse inverse). ``dims_per_level`` covers the sharded
    levels and the switch level (``bottom.dims_per_level[0]``)."""

    s_ops: tuple
    s_inv_diags: tuple
    s_lam: tuple
    bottom: MGState
    dims_per_level: tuple
    boundary: str
    nu1: int
    nu2: int
    mesh: RowMesh
    axis: str = "rows"

    @property
    def n(self) -> int:
        return int(np.prod(self.dims_per_level[0]))

    def solve(self, b, rtol=1e-12, maxiter: int = 100, x0=None):
        """:func:`mg_solve_sharded` on this hierarchy."""
        return mg_solve_sharded(self, b, rtol, maxiter, x0)


def shardable_levels(dims_per_level, n_dev: int) -> int:
    """How many leading levels can be row-sharded: the first grid axis
    splits evenly with an even plane count a rank, so that the coarse
    rank boundaries stay aligned."""
    s = 0
    for dims in dims_per_level[:-1]:
        g0 = dims[0]
        if g0 % n_dev != 0 or (g0 // n_dev) % 2 != 0:
            break
        s += 1
    return s


def build_mg_sharded(
    shifted_csr,
    mesh: RowMesh,
    axis: str = "rows",
    dims=None,
    max_coarse_n: int = 1024,
    nu1: int = 2,
    nu2: int = 2,
    boundary: str = "auto",
):
    """A :class:`ShardedMGState` over ``mesh``: the hierarchy is built on
    every rank's host (the single-device chain), the sharded levels keep
    the rank's rows, the tail goes whole to the rank's device. Raises
    :class:`MGBuildError` when the matrix is not a grid stencil or its
    first grid axis does not split over the mesh."""
    A, dims, auto_boundary = resolve_grid(shifted_csr, dims)
    if boundary == "auto":
        boundary = auto_boundary
    levels, coarse_inv, dims_per_level = build_level_chain(
        A, dims, boundary, max_coarse_n=max_coarse_n
    )
    s = shardable_levels(dims_per_level, mesh.size)
    if s == 0:
        raise MGBuildError(
            f"grid axis 0 ({dims[0]}) does not split over {mesh.size} devices "
            "with even planes per shard"
        )
    s_ops, s_inv_diags, s_lam = [], [], []
    for lv in levels[:s]:
        s_ops.append(ShardedStencilMatProd.create(host_dia(lv["csr"]), mesh, axis))
        s_inv_diags.append(global_put(np.asarray(lv["inv_diag"]), mesh))
        s_lam.append(float(lv["lam"]))
    bottom = mg_state_from_chain(
        levels[s:], coarse_inv, dims_per_level[s:], boundary, nu1, nu2,
        dtype=levels[0]["csr"].dtype, device=mesh.device,
    )
    return ShardedMGState(
        s_ops=tuple(s_ops), s_inv_diags=tuple(s_inv_diags), s_lam=tuple(s_lam),
        bottom=bottom, dims_per_level=tuple(dims_per_level[: s + 1]),
        boundary=boundary, nu1=int(nu1), nu2=int(nu2), mesh=mesh, axis=axis,
    )


def v_cycle_sharded(smg: ShardedMGState, b, x):
    """One V(nu1, nu2) cycle: the sharded levels smooth and transfer with
    halo and one-plane exchanges; the tail runs replicated after one
    all-gather of the switch level's residual."""
    mesh = smg.mesh
    s = len(smg.s_ops)

    def go(lv, b, x):
        if lv == s:
            b_rep = mesh.all_gather(b)
            e = v_cycle(smg.bottom, b_rep, torch.zeros_like(b_rep))
            return mesh.local_rows(e)
        op = smg.s_ops[lv]
        inv_d, lam = smg.s_inv_diags[lv], smg.s_lam[lv]
        x = _smooth(op, inv_d, lam, x, b, smg.nu1)
        r = b - op.matvec(x)
        dims_f = smg.dims_per_level[lv]
        dims_c = (
            smg.dims_per_level[lv + 1]
            if lv + 1 < len(smg.dims_per_level)
            else smg.bottom.dims_per_level[0]
        )
        rc = make_restrict0(mesh, smg.axis, dims_f, dims_c, smg.boundary)(r)
        ec = go(lv + 1, rc, torch.zeros_like(rc))
        x = x + make_prolong0(mesh, smg.axis, dims_c, dims_f, smg.boundary)(ec)
        return _smooth(op, inv_d, lam, x, b, smg.nu2)

    return go(0, b, x)


def mg_solve_sharded(smg: ShardedMGState, b, rtol=1e-12, maxiter: int = 100,
                     x0=None):
    """The stationary sharded multigrid iteration, with the contract of
    :func:`~spectra_tpu_torch.linalg.multigrid.mg_solve`: one
    all-reduced norm a cycle, and the same stall test."""
    return stationary_solve(
        smg.s_ops[0], lambda r: v_cycle_sharded(smg, r, torch.zeros_like(r)),
        b, rtol, maxiter, x0, mesh=smg.mesh,
    )
