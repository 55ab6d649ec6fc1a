"""Halo-exchange SpMV for general sparsity over a row mesh.

Port of :mod:`spectra_tpu.parallel.halo_spmv`. A row-partitioned SpMV
needs only the halo: the distinct remote x entries its rows reference.

* :func:`plan_halo_partition` (host numpy, copied from the JAX package)
  builds a :class:`HaloPlan` once per matrix: for each signed shard
  distance with traffic, the padded lists of local indices each shard
  sends; the interior as an ELL block on local column ids; the remote
  entries as a compact COO list (row, position in the halo, value).
* :class:`ShardedEllMatProd` multiplies the interior in plain torch (the
  JAX package computes it in XLA, not in Pallas), makes one message per
  active distance (rank ``s`` sends its gather to ``s - d``; one batch
  of ``dist.batch_isend_irecv``, the counterpart of ``lax.ppermute``),
  and scatter-adds the boundary entries. A block pays one exchange per
  distance, not one per column.
"""

import dataclasses

import numpy as np
import torch

from spectra_tpu_torch.parallel.mesh import RowMesh, global_put
from spectra_tpu_torch.sparse.formats import EllMatrix


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-side partition plan (numpy; built once per matrix)."""

    n: int
    n_parts: int
    rows_per: int
    dists: tuple  # active signed shard distances (owner - dest)
    halo_sizes: tuple  # H_d per distance (padded max over shard pairs)
    send_idx: tuple  # per distance: (n_parts, H_d) int32 local indices
    cols_local: np.ndarray  # (n, L) int32 local column ids
    vals_local: np.ndarray  # (n, L) interior values
    b_rows: np.ndarray  # (n_parts, R) int32 local boundary rows
    b_pos: np.ndarray  # (n_parts, R) int32 positions into the halo
    b_vals: np.ndarray  # (n_parts, R) boundary values

    @property
    def halo_entries_per_device(self) -> int:
        """x entries moved per device per SpMV (padded)."""
        return int(sum(self.halo_sizes))

    def comm_report(self, itemsize: int = 8) -> dict:
        """Bytes moved per device per SpMV against the all-gather."""
        return {
            "halo_bytes": self.halo_entries_per_device * itemsize,
            "allgather_bytes": (self.n - self.rows_per) * itemsize,
            "n_distances": len(self.dists),
        }


def plan_halo_partition(csr, n_parts: int, dtype=None) -> HaloPlan:
    """The halo plan of an equal row partition of a scipy CSR matrix
    into ``n_parts`` shards. Every per-(shard, distance) gather is padded
    to the largest at that distance; pad slots gather the sender's local
    x[0] and no boundary entry references them."""
    csr = csr.tocsr()
    csr.sum_duplicates()
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("halo SpMV requires a square matrix")
    if n % n_parts != 0:
        raise ValueError(
            f"n must divide evenly over the shards ({n} rows over "
            f"{n_parts})"
        )
    rows_per = n // n_parts
    indptr = csr.indptr.astype(np.int64)
    indices = csr.indices.astype(np.int64)
    data = csr.data if dtype is None else csr.data.astype(dtype)

    nnz_per_row = np.diff(indptr)
    row_of = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    dest = row_of // rows_per
    owner = indices // rows_per
    remote = owner != dest

    # distinct remote columns per (dest, owner) pair
    rkey = dest[remote] * np.int64(n) + indices[remote]
    uniq = np.unique(rkey)
    u_dest = uniq // n
    u_col = uniq % n
    u_owner = u_col // rows_per
    u_delta = u_owner - u_dest

    dists = tuple(int(d) for d in np.unique(u_delta)) if uniq.size else ()

    # Rank of each unique column within its (dest, distance) group:
    # `uniq` is sorted by (dest, col), so the groups are contiguous runs.
    grp = u_dest * np.int64(2 * n_parts + 1) + (u_delta + n_parts)
    if uniq.size:
        change = np.r_[True, grp[1:] != grp[:-1]]
        grp_start = np.flatnonzero(change)
        grp_sizes = np.diff(np.r_[grp_start, len(grp)])
        rank = np.arange(len(grp)) - np.repeat(grp_start, grp_sizes)
    else:
        grp_start = np.zeros(0, dtype=np.int64)
        grp_sizes = np.zeros(0, dtype=np.int64)
        rank = np.zeros(0, dtype=np.int64)

    halo_sizes = []
    send_idx = []
    off_of_dist = {}
    offset = 0
    for d in dists:
        sel = u_delta[grp_start] == d
        H = max(int(grp_sizes[sel].max()) if sel.any() else 1, 1)
        off_of_dist[d] = offset
        offset += H
        halo_sizes.append(H)
        # Owner s ships to dest s - d the columns it owns that the dest
        # needs, in ascending column order (matching `rank`).
        sidx = np.zeros((n_parts, H), dtype=np.int32)
        mask = u_delta == d
        s_owner = u_owner[mask]
        sidx[s_owner, rank[mask]] = (u_col[mask] - s_owner * rows_per).astype(np.int32)
        send_idx.append(sidx)

    if uniq.size:
        dist_off = np.array([off_of_dist[int(d)] for d in u_delta])
        pos_of_unique = dist_off + rank
        entry_pos = pos_of_unique[np.searchsorted(uniq, rkey)]
    else:
        entry_pos = np.zeros(0, dtype=np.int64)

    # compact boundary COO per shard
    r_rows = row_of[remote]
    r_dest = dest[remote]
    r_vals = data[remote]
    counts = np.bincount(r_dest, minlength=n_parts)
    R = max(int(counts.max()) if counts.size else 0, 1)
    b_rows = np.zeros((n_parts, R), dtype=np.int32)
    b_pos = np.zeros((n_parts, R), dtype=np.int32)
    b_vals = np.zeros((n_parts, R), dtype=data.dtype)
    order = np.argsort(r_dest, kind="stable")
    starts = np.r_[0, np.cumsum(counts)]
    slot = np.arange(len(order)) - np.repeat(starts[:-1], counts)
    sd = r_dest[order]
    b_rows[sd, slot] = (r_rows[order] - sd * rows_per).astype(np.int32)
    b_pos[sd, slot] = entry_pos[order].astype(np.int32)
    b_vals[sd, slot] = r_vals[order]

    # interior ELL with local column ids
    from spectra_tpu_torch.sparse.formats import _ell_arrays_from_csr

    keep = ~remote
    local_nnz_per_row = np.bincount(row_of[keep], minlength=n)
    l_indptr = np.r_[0, np.cumsum(local_nnz_per_row)]
    cols_local, vals_local = _ell_arrays_from_csr(
        l_indptr,
        (indices[keep] - dest[keep] * rows_per).astype(np.int64),
        data[keep],
        n,
    )

    return HaloPlan(
        n=n, n_parts=n_parts, rows_per=rows_per, dists=dists,
        halo_sizes=tuple(halo_sizes), send_idx=tuple(send_idx),
        cols_local=cols_local.astype(np.int32), vals_local=vals_local,
        b_rows=b_rows, b_pos=b_pos, b_vals=b_vals,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedEllMatProd:
    """General-sparsity MatProd with O(halo) exchange: the rank's rows of
    a :class:`HaloPlan` on the mesh's device. Block inputs pay one
    exchange per distance, not one per column."""

    interior: EllMatrix  # the rank's rows, local column ids
    b_rows: torch.Tensor  # (R,) local boundary rows
    b_pos: torch.Tensor  # (R,) positions into the concatenated halo
    b_vals: torch.Tensor  # (R,)
    sends: tuple  # per distance: (H_d,) local indices this rank sends
    halo_sizes: tuple
    diag: torch.Tensor  # (rows_per,)
    dists: tuple
    n_rows: int
    mesh: RowMesh
    axis: str = "rows"

    @classmethod
    def create(cls, mat, mesh: RowMesh, axis: str = "rows", dtype=None):
        """Partition a scipy sparse matrix over ``mesh``."""
        csr = mat.tocsr()
        plan = plan_halo_partition(csr, mesh.size, dtype=dtype)
        diag = np.asarray(csr.diagonal())
        if dtype is not None:
            diag = diag.astype(dtype)
        return cls.from_plan(plan, diag, mesh, axis)

    @classmethod
    def from_plan(cls, plan: HaloPlan, diag, mesh: RowMesh, axis: str = "rows"):
        """The rank's part of a built plan (``plan.n_parts`` must be the
        mesh's size) and of the global ``diag``."""
        if plan.n_parts != mesh.size:
            raise ValueError(
                f"the plan has {plan.n_parts} parts, the mesh {mesh.size} ranks"
            )
        r = mesh.rank

        def row(a, dtype=None):
            arr = np.asarray(a[r]) if dtype is None else np.asarray(a[r], dtype)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)

        return cls(
            interior=EllMatrix(
                cols=global_put(plan.cols_local, mesh).long(),
                vals=global_put(plan.vals_local, mesh),
                n_rows=plan.rows_per, n_cols=plan.rows_per,
            ),
            b_rows=row(plan.b_rows, np.int64), b_pos=row(plan.b_pos, np.int64),
            b_vals=row(plan.b_vals),
            sends=tuple(row(s, np.int64) for s in plan.send_idx),
            halo_sizes=tuple(plan.halo_sizes), diag=global_put(np.asarray(diag), mesh),
            dists=tuple(plan.dists), n_rows=plan.n, mesh=mesh, axis=axis,
        )

    @property
    def dtype(self):
        return self.interior.dtype

    @property
    def device(self):
        return self.mesh.device

    def rows(self) -> int:
        return self.n_rows

    def cols(self) -> int:
        return self.n_rows

    def perform_op(self, x):
        mesh, r = self.mesh, self.mesh.rank
        tail = x.shape[1:]
        halos, sends, recvs = [], [], []
        for tag, (d, sidx, H) in enumerate(zip(self.dists, self.sends, self.halo_sizes)):
            buf = x.new_zeros((H, *tail))
            if 0 <= r - d < mesh.size:
                sends.append((x[sidx], r - d, tag))
            if 0 <= r + d < mesh.size:
                recvs.append((buf, r + d, tag))
            halos.append(buf)
        mesh.exchange(sends, recvs)
        y = self.interior.matvec(x) if x.ndim == 1 else self.interior.matmat(x)
        if halos:
            halo = torch.cat(halos)
            vals = self.b_vals if x.ndim == 1 else self.b_vals[:, None]
            y = y.index_add(0, self.b_rows, vals * halo[self.b_pos])
        return y

    matvec = perform_op

    def diagonal(self):
        return self.diag
