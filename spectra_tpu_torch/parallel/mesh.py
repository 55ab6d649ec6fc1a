"""Row meshes, placement and the collectives of the multi-device layer.

Port of :mod:`spectra_tpu.parallel.mesh`. The JAX package places arrays
on a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives. PyTorch
has no GSPMD, so the port runs one process per device
(``torch.distributed``: NCCL on GPUs, gloo on CPUs) and every
communication is explicit:

* :class:`RowMesh` takes the place of the 1-D ``("rows",)`` mesh: the
  process group, this process's rank in it, its size and its device.
  Its collectives are the only ones the layer makes: :meth:`all_reduce`
  (the ``psum`` of an inner product), :meth:`all_gather` (GSPMD's
  gather of a row-sharded vector), and :meth:`exchange` / :meth:`halo`
  (``lax.ppermute``: one batch of ``dist.batch_isend_irecv``).
* :func:`row_sharded` and :func:`replicated` are placement descriptors,
  and :func:`global_put` places an array by one: each rank takes only
  its rows.
* :func:`shard_operator` and :func:`shard_problem` are the counterpart
  of GSPMD's placement of an operator: a :class:`RowShardedMatProd`
  holds the rank's rows and does what GSPMD's lowering does, one
  all-gather of x (O(n) bytes a rank) and the local rows' product. On
  DIA that product is K1 on the (d, rows_per) block with ``n_cols = n``.
  A rectangular operator keeps its shape (the partial SVD's input):
  its adjoint product sums the local rows' partials by one all-reduce.

Rows split evenly: ``n`` must divide over the mesh. Vectors keep the
rank's rows; the small replicated problem is identical on every rank
because every value it reads is all-reduced.

With the gloo backend and CUDA tensors (several ranks on one card), the
collectives stage their tensors through pinned host buffers: that is
gloo's transport, not a fallback, and :attr:`RowMesh.transport` says so.
Each mesh counts its collectives, the elements it sends and the host
seconds spent in them (:attr:`RowMesh.stats`).
"""

import dataclasses
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from spectra_tpu_torch.ops.dia_ds import combine_f64
from spectra_tpu_torch.sparse.formats import DiaHiLoMatrix, DiaMatrix, EllMatrix


def _new_stats() -> dict:
    """Counts of each collective, the elements this rank sent, and the
    host seconds spent in each kind and in all."""
    return dict(all_reduce=0, all_gather=0, exchange=0, sent_elements=0,
                seconds=0.0, all_reduce_s=0.0, all_gather_s=0.0, exchange_s=0.0)


def _gather_into(out, t, group):
    """``all_gather_single`` where this PyTorch has it (from 2.13 it
    deprecates ``all_gather_into_tensor``), else
    ``all_gather_into_tensor``: the same collective under either name."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """A 1-D mesh of ranks over the ``axis`` ("rows"): one process per
    device, ``rank`` of ``size`` in the process ``group``, which holds
    the first ``size`` ranks of the world (so a mesh rank is also the
    global rank). ``staged``: a gloo group on CUDA tensors, whose
    collectives go through host buffers. Build one with
    :func:`row_mesh`."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "rows"
    staged: bool = False
    stats: dict = dataclasses.field(default_factory=_new_stats)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def transport(self) -> str:
        return "pinned host buffers" if self.staged else "device tensors"

    def reset_stats(self) -> None:
        self.stats.update(_new_stats())

    def rows_per(self, n: int) -> int:
        if n % self.size != 0:
            raise ValueError(
                f"n must divide evenly over the mesh ({n} rows over "
                f"{self.size} ranks)"
            )
        return n // self.size

    def row_range(self, n: int):
        """``(first, end)`` of this rank's rows of ``n``."""
        rp = self.rows_per(n)
        return self.rank * rp, (self.rank + 1) * rp

    def local_rows(self, x, axis: int = 0):
        """This rank's rows (along ``axis``) of a global array."""
        r0, r1 = self.row_range(x.shape[axis])
        return x.narrow(axis, r0, r1 - r0)

    # -- collectives ---------------------------------------------------
    def _host(self, t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _tally(self, kind: str, t0: float, sent: int = 0) -> None:
        dt = time.perf_counter() - t0
        self.stats[kind] += 1
        self.stats["sent_elements"] += sent
        self.stats[kind + "_s"] += dt
        self.stats["seconds"] += dt

    def all_reduce(self, t, op: str = "sum"):
        """The sum (``op="max"``: the maximum) of ``t`` over the ranks, a
        new tensor, identical on every rank."""
        t0 = time.perf_counter()
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        out = t.detach().clone()
        buf = torch.view_as_real(out) if out.is_complex() else out
        if self.staged:
            host = self._host(buf)
            dist.all_reduce(host, red, group=self.group)
            buf.copy_(host)
        else:
            dist.all_reduce(buf, red, group=self.group)
        self._tally("all_reduce", t0, buf.numel())
        return out

    def all_gather(self, t):
        """The global array whose row blocks are every rank's ``t``, in
        rank order, on every rank."""
        t0 = time.perf_counter()
        t = t.contiguous()
        out = torch.empty(
            (self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device
        )
        src = torch.view_as_real(t) if t.is_complex() else t
        dst = torch.view_as_real(out) if out.is_complex() else out
        if self.staged:
            host = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
            _gather_into(host, self._host(src), self.group)
            dst.copy_(host)
        else:
            _gather_into(dst, src, self.group)
        self._tally("all_gather", t0, src.numel())
        return out

    def exchange(self, sends, recvs) -> None:
        """One batch of point-to-point messages (``lax.ppermute``):
        ``sends`` are ``(tensor, peer, tag)``, ``recvs`` ``(buffer,
        peer, tag)`` with peers as ranks of this mesh; returns when the
        buffers hold the messages."""
        if not sends and not recvs:
            return
        t0 = time.perf_counter()
        ops, landed = [], []
        for tensor, peer, tag in sends:
            src = self._host(tensor) if self.staged else tensor.contiguous()
            ops.append(dist.P2POp(dist.isend, src, peer, self.group, tag))
        for buf, peer, tag in recvs:
            dst = (
                torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                if self.staged else buf
            )
            ops.append(dist.P2POp(dist.irecv, dst, peer, self.group, tag))
            landed.append((buf, dst))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self.staged:
            for buf, dst in landed:
                buf.copy_(dst)
        self._tally("exchange", t0, sum(t.numel() for t, _, _ in sends))

    def halo(self, x, lo: int, hi: int):
        """``x`` (rows first) extended by ``lo`` rows before and ``hi``
        rows after: the left neighbour's bottom ``lo`` rows and the right
        neighbour's top ``hi`` rows, zeros at the ends of the mesh. One
        exchange: each rank sends its bottom rows right and its top rows
        left."""
        tail = x.shape[1:]
        left = x.new_zeros((lo, *tail))
        right = x.new_zeros((hi, *tail))
        r, last = self.rank, self.size - 1
        sends, recvs = [], []
        if lo > 0:
            if r < last:
                sends.append((x[x.shape[0] - lo:], r + 1, 0))
            if r > 0:
                recvs.append((left, r - 1, 0))
        if hi > 0:
            if r > 0:
                sends.append((x[:hi], r - 1, 1))
            if r < last:
                recvs.append((right, r + 1, 1))
        self.exchange(sends, recvs)
        return torch.cat([left, x, right])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_SUBGROUPS: dict = {}


def row_mesh(n_devices: int | None = None, device=None):
    """A :class:`RowMesh` over the first ``n_devices`` ranks of the
    process group (default: all of them), on this process's device
    (``device=None`` means the one :func:`spectra_tpu_torch.distributed.
    initialize` chose, else the GPU of the local rank).

    Without an initialized process group this starts a one-rank group
    itself (NCCL on the GPU, gloo on the CPU), as the JAX ``row_mesh()``
    works without ``jax.distributed``. A mesh over fewer ranks than the
    group is a new subgroup: every rank must call this, as
    ``dist.new_group`` requires, and the ranks outside it get ``None``.
    """
    from spectra_tpu_torch import distributed

    if not dist.is_initialized():
        distributed.initialize(
            init_method=f"tcp://127.0.0.1:{_free_port()}", num_processes=1,
            process_id=0, device=device,
        )
    world = dist.get_world_size()
    k = world if n_devices is None else int(n_devices)
    if not 1 <= k <= world:
        raise ValueError(f"n_devices={k}: the process group has {world} ranks")
    if k == world:
        group = dist.group.WORLD
    else:
        if k not in _SUBGROUPS:
            _SUBGROUPS[k] = dist.new_group(list(range(k)))
        group = _SUBGROUPS[k]
    if dist.get_rank() >= k:
        return None
    dev = distributed.process_device(device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group runs on CUDA devices only")
    # gloo's transport reads host memory: it aborts on CUDA tensors
    return RowMesh(
        group=group, rank=dist.get_rank(group), size=k, device=dev,
        staged=backend == "gloo" and dev.type == "cuda",
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Where an array lives on a mesh: split along ``axis`` over the
    ranks, or whole on every rank (``axis=None``)."""

    mesh: RowMesh
    axis: int | None = 0


def row_sharded(mesh: RowMesh, *trailing_dims: int) -> Placement:
    """Axis 0 split over the mesh, the trailing axes whole."""
    return Placement(mesh, 0)


def replicated(mesh: RowMesh) -> Placement:
    return Placement(mesh, None)


def global_put(array, placement):
    """This rank's part of ``array`` (anything sliceable: a numpy array,
    a memmap, a tensor) under ``placement`` (a :class:`Placement`, or a
    :class:`RowMesh` for :func:`row_sharded`), as a tensor on the mesh's
    device. Only the rank's rows are read, so a 100M-row operator never
    has to fit whole on one rank."""
    if isinstance(placement, RowMesh):
        placement = Placement(placement, 0)
    mesh, axis = placement.mesh, placement.axis
    part = array
    if axis is not None:
        r0, r1 = mesh.row_range(array.shape[axis])
        index = [slice(None)] * len(array.shape)
        index[axis] = slice(r0, r1)
        part = array[tuple(index)]
    if torch.is_tensor(part):
        return part.to(mesh.device, copy=True).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(part))).to(mesh.device)


def _window(full, first: int, rows: int, lo: int, hi: int):
    """Rows ``[first - lo, first + rows + hi)`` of ``full``, zeros where
    they fall outside it."""
    n = full.shape[0]
    a, b = max(0, first - lo), min(n, first + rows + hi)
    tail = full.shape[1:]
    return torch.cat([
        full.new_zeros((a - (first - lo), *tail)),
        full[a:b],
        full.new_zeros((first + rows + hi - b, *tail)),
    ])


@dataclasses.dataclass(frozen=True, eq=False)
class _HiLoRows:
    """Rows ``[first, first + rows)`` of a :class:`DiaHiLoMatrix`: their
    hi/lo planes and offsets; the product runs K2's ``_ext`` entry on
    the rows' window of the gathered x."""

    data_hi: torch.Tensor
    data_lo: torch.Tensor
    offsets: tuple
    first: int
    rows: int

    @property
    def dtype(self):
        return torch.float64

    def to_dia(self, n_cols: int, dtype=torch.float64) -> DiaMatrix:
        """The rows as a :class:`DiaMatrix` of the planes' sum in
        ``dtype`` (offsets shifted by ``first``, over ``n_cols``
        columns): a full copy of the rows' diagonals."""
        return DiaMatrix(
            data=combine_f64(self.data_hi, self.data_lo).to(dtype),
            offsets=tuple(o + self.first for o in self.offsets),
            n_rows=self.rows, n_cols=n_cols,
        )

    def product(self, full):
        from spectra_tpu_torch.parallel.stencil_spmv import hilo_ext_product

        lo, hi = max(0, -min(self.offsets)), max(0, max(self.offsets))
        x_ext = _window(full, self.first, self.rows, lo, hi)
        return hilo_ext_product(
            self.data_hi, self.data_lo, self.offsets, self.rows, x_ext
        )


@dataclasses.dataclass(frozen=True, eq=False)
class RowShardedMatProd:
    """The rank's rows of an ``n_rows`` x ``n_cols`` operator, multiplied
    as GSPMD lowers a row-sharded product: one all-gather of x (the
    rank's share of ``n_cols``), then the local rows. ``local`` is a
    :class:`DiaMatrix` of the rows with the offsets shifted by the first
    row (K1 over the gathered x), an :class:`EllMatrix` of the rows, a
    ``_HiLoRows`` (K2's ``_ext`` entry; square only) or a dense tensor
    of the rows.

    ``perform_trans_op`` and ``perform_adjoint_op`` take the rank's
    share of ``n_rows``: the local rows' transpose (adjoint) times it is
    a partial product of length ``n_cols``, summed over the ranks by one
    all-reduce, of which the rank keeps its share."""

    local: object
    diag: torch.Tensor  # the rank's rows of A[i, i] (zero where i >= n_cols)
    n_rows: int
    n_cols: int
    mesh: RowMesh

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.mesh.device

    def rows(self) -> int:
        return self.n_rows

    def cols(self) -> int:
        return self.n_cols

    def perform_op(self, x):
        full = self.mesh.all_gather(x)
        local = self.local
        if torch.is_tensor(local):
            return local @ full
        if isinstance(local, _HiLoRows):
            return local.product(full)
        return local.matvec(full) if x.ndim == 1 else local.matmat(full)

    matvec = perform_op

    def perform_adjoint_op(self, y):
        """``A^H y``: the rank's share of ``n_cols``, from the local rows'
        adjoint times ``y`` (a vector or a block), a partial product of
        ``n_cols`` rows summed over the ranks."""
        from spectra_tpu_torch.matop.sparse import SparseGenMatProd

        local = self.local
        if torch.is_tensor(local):
            part = local.mH @ y
        else:
            if isinstance(local, _HiLoRows):
                local = local.to_dia(self.n_cols)
            part = SparseGenMatProd(ell=local).perform_adjoint_op(y)
        return self.mesh.local_rows(self.mesh.all_reduce(part))

    def perform_trans_op(self, y):
        """``A^T y``: the rank's share of ``n_cols``."""
        if self.dtype.is_complex:
            return self.perform_adjoint_op(y.conj()).conj_physical()
        return self.perform_adjoint_op(y)

    def diagonal(self):
        return self.diag


def shard_operator(op, mesh: RowMesh):
    """The rank's rows of an operator (a sparse or dense product
    operator, square or rectangular, or a bare DIA, hi/lo or ELL matrix)
    as a :class:`RowShardedMatProd`; any other operator is returned as it
    is, as the JAX package leaves a leaf it cannot place. Both ``n_rows``
    and ``n_cols`` must divide over the mesh."""
    store = op if isinstance(op, (EllMatrix, DiaMatrix, DiaHiLoMatrix)) else getattr(op, "ell", None)
    if store is None:
        mat = getattr(op, "mat", None)
        if mat is None or mat.shape[0] != op.rows():
            return op
        m, n = mat.shape
        mesh.rows_per(n)
        diag = torch.as_tensor(mat.diagonal())
        if m > n:
            diag = torch.cat([diag, diag.new_zeros(m - n)])
        return RowShardedMatProd(
            local=global_put(mat, mesh), diag=global_put(diag, mesh),
            n_rows=m, n_cols=n, mesh=mesh,
        )
    n = store.n_rows
    mesh.rows_per(store.n_cols)
    first, end = mesh.row_range(n)
    cols = Placement(mesh, 1)
    if isinstance(store, DiaMatrix):
        local = DiaMatrix(
            data=global_put(store.data, cols),
            offsets=tuple(o + first for o in store.offsets),
            n_rows=end - first, n_cols=store.n_cols,
        )
    elif isinstance(store, DiaHiLoMatrix):
        local = _HiLoRows(
            data_hi=global_put(store.data_hi[:, :n], cols),
            data_lo=global_put(store.data_lo[:, :n], cols),
            offsets=store.offsets, first=first, rows=end - first,
        )
    else:
        local = EllMatrix(
            cols=global_put(store.cols, mesh), vals=global_put(store.vals, mesh),
            n_rows=end - first, n_cols=store.n_cols,
        )
    return RowShardedMatProd(
        local=local, diag=global_put(store.diagonal(), mesh), n_rows=n,
        n_cols=store.n_cols, mesh=mesh,
    )


def shard_problem(op, v0, mesh: RowMesh):
    """Shard an (operator, starting-vector) pair over a row mesh: the
    rank's rows of both."""
    return shard_operator(op, mesh), global_put(v0, mesh)


def partition_report(csr, n_parts: int) -> dict:
    """Communication volume of an equal row partition of a scipy CSR
    matrix (the native halo census): per-partition halo sizes (distinct
    remote x entries a shard reads per SpMV), the halo bytes per SpMV at
    f64, the all-gather bytes GSPMD would move instead, and whether the
    halo-exchange stencil path applies (a banded matrix)."""
    from spectra_tpu_torch import native
    from spectra_tpu_torch.sparse.formats import dia_suitability

    csr = csr.tocsr()
    n = csr.shape[0]
    halos = native.rowpart_halo(
        n, csr.indptr.astype("int64"), csr.indices.astype("int64"), n_parts
    )
    item = 8  # f64 bytes
    return {
        "n_parts": n_parts,
        "rows_per_part": -(-n // n_parts),
        "halo_per_part": [int(h) for h in halos],
        "halo_bytes_per_spmv": int(halos.sum()) * item,
        "allgather_bytes_per_spmv": int(n) * item * n_parts,
        "stencil_path_applicable": bool(dia_suitability(csr)),
    }
