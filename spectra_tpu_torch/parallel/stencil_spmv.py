"""Halo-exchange stencil SpMV over a row mesh.

Port of :mod:`spectra_tpu.parallel.stencil_spmv`. A row-partitioned
banded matrix needs only ``lo`` x entries from the left neighbour and
``hi`` from the right (``lo = max(0, -min offsets)``, ``hi = max(0, max
offsets)``), not the all-gather of x that the generic lowering makes.
Each ``perform_op`` here makes ONE exchange (:meth:`RowMesh.halo`,
vector or block: the bottom ``lo`` rows go right, the top ``hi`` rows
left, the end ranks get zeros) and then multiplies the rank's rows over
the halo-extended x of ``lo + rows_per + hi`` rows:

* :class:`ShardedStencilMatProd`: one K1 launch (``ops/dia_spmv.py``)
  on the rank's (d, rows_per) diagonals, offsets shifted by ``lo``, a
  vector or a block;
* :class:`ShardedStencilHiLoMatProd`: the f64 halo split into hi/lo f32
  planes, one launch of K2's ``_ext`` entry (``ops/dia_ds.py::
  dia_spmv_ds_ext``) on the rank's hi/lo planes, the result combined to
  f64; a block gets one exchange and one launch per column.

The JAX package splits each product into an interior part and boundary
corrections so that XLA overlaps the ppermutes with the bulk compute;
the port exchanges first and multiplies once. The hi/lo planes carry no
per-shard chunk padding (the card has no lane alignment), so ``chunk``
is accepted for the JAX signature and ignored.

:func:`sharded_stencil_shift_solve` is the distributed shift-invert
operator: the sharded multigrid (:mod:`spectra_tpu_torch.parallel.
mg_sharded`) validated by a trial solve, else MINRES over the halo SpMV.
"""

import dataclasses
import time
import warnings

import torch

from spectra_tpu_torch.ops.dia_ds import (
    combine_f64,
    dia_spmv_ds_ext,
    hilo_suitable,
    split_f64,
)
from spectra_tpu_torch.ops.dia_spmv import dia_spmv
from spectra_tpu_torch.ops.gemv import vec_norm
from spectra_tpu_torch.parallel.mesh import Placement, RowMesh, global_put
from spectra_tpu_torch.sparse.formats import HILO_BYTES_THRESHOLD, DiaMatrix, plane_ld


def _extent(offsets):
    return max(0, -min(offsets)), max(0, max(offsets))


def _check_partition(n: int, offsets, mesh: RowMesh) -> int:
    """``rows_per``; raises as the JAX ``create`` does."""
    if n % mesh.size != 0:
        raise ValueError(
            "n must divide evenly over the mesh for the halo SpMV "
            f"({n} rows over {mesh.size} devices)"
        )
    rows_per = n // mesh.size
    if max(_extent(offsets)) > rows_per:
        raise ValueError("halo exceeds shard size; use fewer devices")
    return rows_per


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStencilMatProd:
    """MatProd over the halo-exchange stencil SpMV: the rank's rows of
    the row-aligned DIA diagonals, ``data`` (d, rows_per); one exchange
    and one K1 launch per ``perform_op``. The solvers' inner products
    all-reduce over ``mesh`` (:class:`~spectra_tpu_torch.matop.
    arnoldi_op.ArnoldiOp`)."""

    data: torch.Tensor  # (d, rows_per), this rank's rows
    offsets: tuple
    n_rows: int
    mesh: RowMesh
    axis: str = "rows"

    @classmethod
    def create(cls, dia: DiaMatrix, mesh: RowMesh, axis: str = "rows"):
        _check_partition(dia.n_rows, dia.offsets, mesh)
        return cls(
            data=global_put(dia.data, Placement(mesh, 1)),
            offsets=tuple(int(o) for o in dia.offsets), n_rows=dia.n_rows,
            mesh=mesh, axis=axis,
        )

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def rows(self) -> int:
        return self.n_rows

    def cols(self) -> int:
        return self.n_rows

    def perform_op(self, x):
        lo, hi = _extent(self.offsets)
        x_ext = self.mesh.halo(x, lo, hi)
        return dia_spmv(
            self.data, tuple(o + lo for o in self.offsets), x_ext, x_ext.shape[0]
        )

    # The inner solvers (MINRES, the multigrid smoother) consume
    # ``matvec``; the sharded SpMV serves both seams.
    matvec = perform_op

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.data.shape[1], dtype=self.dtype, device=self.device)

    def row_abs_max(self) -> float:
        """The largest row sum of |A| over every rank (Gershgorin)."""
        local = self.data.abs().sum(dim=0).max()
        return float(self.mesh.all_reduce(local, "max"))


def hilo_ext_product(data_hi, data_lo, offsets, n: int, x_ext):
    """``A x`` in f64 for hi/lo planes (d, >= n) over a halo-extended f64
    ``x_ext`` of ``lo + n + hi`` rows: split, one launch of K2's ``_ext``
    entry, combine; a block runs one launch per column."""
    if x_ext.ndim == 2:
        return torch.stack(
            [hilo_ext_product(data_hi, data_lo, offsets, n, x_ext[:, c].contiguous())
             for c in range(x_ext.shape[1])],
            dim=1,
        )
    xh, xl = split_f64(x_ext)
    yh, yl = dia_spmv_ds_ext(data_hi, data_lo, xh, xl, offsets=offsets, n=n)
    return combine_f64(yh, yl)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStencilHiLoMatProd:
    """Row-sharded stencil operator over K2's double-single kernel: the
    multi-device :class:`~spectra_tpu_torch.sparse.formats.DiaHiLoMatrix`.
    Each rank holds the hi/lo f32 planes of its rows (leading dimension
    ``rows_per`` rounded up to ``PLANE_ALIGN``, zeros beyond), and
    ``perform_op`` exchanges the f64 halo and makes one ``_ext`` launch
    a vector. ``chunk`` is the JAX signature's and unused."""

    data_hi: torch.Tensor  # (d, ld) f32, this rank's rows
    data_lo: torch.Tensor
    offsets: tuple
    n_rows: int
    mesh: RowMesh
    axis: str = "rows"
    chunk: int | None = None
    rows_per: int = 0

    @classmethod
    def create(cls, dia: DiaMatrix, mesh: RowMesh, axis: str = "rows",
               chunk: int | None = None):
        rows_per = _check_partition(dia.n_rows, dia.offsets, mesh)
        if not hilo_suitable(torch.float64, dia.n_rows, dia.n_cols, len(dia.offsets)):
            raise ValueError(
                "the hi/lo kernel takes a square DIA matrix with at most 64 diagonals"
            )
        local = global_put(dia.data, Placement(mesh, 1)).to(torch.float64)
        hi, lo = split_f64(local)
        return cls._from_local(hi, lo, dia.offsets, dia.n_rows, mesh, axis, chunk, rows_per)

    @classmethod
    def from_planes(cls, data_hi, data_lo, offsets, n_rows: int, mesh: RowMesh,
                    axis: str = "rows"):
        """From the global hi/lo planes (d, n) of every row (e.g. the JAX
        package's, stripped by :func:`spectra_tpu_torch.convert.
        hilo_shards_from_numpy`): each rank takes its rows' columns."""
        rows_per = _check_partition(n_rows, offsets, mesh)
        cols = Placement(mesh, 1)
        return cls._from_local(
            global_put(data_hi, cols), global_put(data_lo, cols), offsets,
            n_rows, mesh, axis, None, rows_per,
        )

    @classmethod
    def _from_local(cls, hi, lo, offsets, n_rows, mesh, axis, chunk, rows_per):
        d = hi.shape[0]
        planes = []
        for p in (hi, lo):
            padded = torch.zeros((d, plane_ld(rows_per)), dtype=torch.float32,
                                 device=mesh.device)
            padded[:, :rows_per] = p
            planes.append(padded)
        return cls(
            data_hi=planes[0], data_lo=planes[1],
            offsets=tuple(int(o) for o in offsets), n_rows=int(n_rows), mesh=mesh,
            axis=axis, chunk=chunk, rows_per=rows_per,
        )

    @property
    def dtype(self):
        return torch.float64

    @property
    def device(self):
        return self.data_hi.device

    def rows(self) -> int:
        return self.n_rows

    def cols(self) -> int:
        return self.n_rows

    def perform_op(self, x):
        lo, hi = _extent(self.offsets)
        x_ext = self.mesh.halo(x, lo, hi)
        return hilo_ext_product(
            self.data_hi, self.data_lo, self.offsets, self.rows_per, x_ext
        )

    matvec = perform_op

    def diagonal(self):
        """The rank's rows of the diagonal, rebuilt from the f32 planes
        (the JAX package's, ``stencil_spmv.py:458-468``)."""
        if 0 not in self.offsets:
            return torch.zeros(self.rows_per, dtype=torch.float64, device=self.device)
        k, rp = self.offsets.index(0), self.rows_per
        return combine_f64(self.data_hi[k, :rp], self.data_lo[k, :rp])

    def row_abs_max(self) -> float:
        rp = self.rows_per
        acc = torch.zeros(rp, dtype=torch.float64, device=self.device)
        for k in range(len(self.offsets)):
            acc = acc + combine_f64(self.data_hi[k, :rp], self.data_lo[k, :rp]).abs()
        return float(self.mesh.all_reduce(acc.max(), "max"))


def sharded_stencil_op(dia: DiaMatrix, mesh: RowMesh, axis: str = "rows",
                       hilo: str | bool = "auto"):
    """The row-sharded stencil operator, routed as the single-device
    path routes (``sparse.formats.hilo_route``): on CUDA, an f64 square
    stencil whose PER-SHARD working set ``(d + 2) * 8 * rows_per``
    reaches :data:`HILO_BYTES_THRESHOLD` takes the hi/lo kernel.
    ``hilo=True`` forces it, ``hilo=False`` pins the f64 class. An
    ineligible matrix gets the f64 class under ``hilo=True`` too, as in
    the JAX package."""
    d = len(dia.offsets)
    rows_per = dia.n_rows // max(1, mesh.size)
    eligible = hilo_suitable(dia.dtype, dia.n_rows, dia.n_cols, d)
    if hilo == "auto":
        hilo = (
            eligible and mesh.device.type == "cuda"
            and (d + 2) * 8 * rows_per >= HILO_BYTES_THRESHOLD
        )
    if hilo and eligible:
        return ShardedStencilHiLoMatProd.create(dia, mesh, axis)
    return ShardedStencilMatProd.create(dia, mesh, axis)


def host_dia(csr) -> DiaMatrix:
    """A row-aligned :class:`DiaMatrix` of a scipy matrix on the host
    (the native converter): the source every rank slices its rows
    from."""
    from spectra_tpu_torch.sparse.formats import _dia_host_arrays

    offsets, rows, n_rows, n_cols = _dia_host_arrays(csr)
    return DiaMatrix(data=torch.from_numpy(rows), offsets=offsets,
                     n_rows=n_rows, n_cols=n_cols)


def sharded_stencil_shift_solve(
    csr,
    sigma,
    mesh: RowMesh,
    axis: str = "rows",
    inner_rtol=None,
    precond: str = "none",
    cheb_degree: int = 16,
    cheb_interval=None,
    method: str = "auto",
    grid_dims=None,
    b_csr=None,
):
    """Distributed shift-invert operator: ``(A - sigma I)^{-1} x``, or
    ``(A - sigma B)^{-1} x`` with ``b_csr``, every vector of the inner
    iteration row-sharded.

    ``method="auto"`` (and ``"mg"``) first tries the sharded geometric
    multigrid, validated by a trial solve with a backward-error gate;
    without it, MINRES over the halo-exchange SpMV (with a warning under
    ``"mg"``). ``method="minres"`` pins MINRES. The shifted matrix's
    SpMV is routed by :func:`sharded_stencil_op`. Use from
    ``SymEigsShiftSolver.from_factored(op, ...)``; ``build_s`` holds the
    seconds of the build's parts (``dia``, ``hierarchy``, ``trial``).
    """
    import scipy.sparse as sps

    from spectra_tpu_torch.matop.shift_solve import SparseShiftSolveBase

    csr = csr.tocsr()
    n = csr.shape[0]
    metric = (
        b_csr.tocsr() if b_csr is not None
        else sps.eye(n, dtype=csr.dtype, format="csr")
    )
    shifted = (csr - sigma * metric).tocsr()
    t0 = time.perf_counter()
    op = sharded_stencil_op(host_dia(shifted), mesh, axis)
    op_norm = op.row_abs_max()
    times = {"dia": time.perf_counter() - t0}

    mg_state = None
    if method in ("auto", "mg"):
        mg_state = _maybe_build_mg_sharded(
            shifted, op, mesh, axis, grid_dims, op_norm, times
        )
        if mg_state is None and method == "mg":
            warnings.warn(
                "method='mg' requested but no validated sharded multigrid "
                "hierarchy could be built; falling back to MINRES.",
                stacklevel=2,
            )
    return SparseShiftSolveBase(
        shifted=op, solver=None, n=n,
        method="mg" if mg_state is not None else "minres", out_real=False,
        inner_rtol=inner_rtol, precond=precond, cheb_degree=cheb_degree,
        cheb_interval=cheb_interval, inner_rtol_user=inner_rtol is not None,
        mg=mg_state, op_norm=op_norm, build_s=times,
    )


def _maybe_build_mg_sharded(shifted, op, mesh, axis, grid_dims, op_norm, times):
    """The sharded hierarchy and one trial solve with a backward-error
    gate; None when the build or the gate fails."""
    from spectra_tpu_torch.linalg.multigrid import MGBuildError
    from spectra_tpu_torch.parallel.mg_sharded import build_mg_sharded
    from spectra_tpu_torch.util.rng import SimpleRandom

    t0 = time.perf_counter()
    try:
        smg = build_mg_sharded(shifted, mesh, axis, dims=grid_dims)
    except MGBuildError:
        return None
    finally:
        times["hierarchy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = global_put(SimpleRandom(1).random_vec(shifted.shape[0], shifted.dtype), mesh)
    y, _ = smg.solve(b, rtol=1e-12, maxiter=60)
    resid = vec_norm(op.matvec(y) - b, mesh)
    scale = op_norm * vec_norm(y, mesh) + vec_norm(b, mesh)
    ok = bool(resid <= 1e-11 * scale)
    times["trial"] = time.perf_counter() - t0
    return smg if ok else None
