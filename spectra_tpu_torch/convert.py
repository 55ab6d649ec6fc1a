"""Build the port's objects from the JAX package's arrays.

The arrays come in as numpy arrays (``np.asarray`` of the JAX
objects), so this module never imports ``spectra_tpu``. The tests use
it to start the port from exactly the JAX package's state, e.g. a
restart compression from one JAX Krylov state, or to multiply the JAX
package's halo plan and hi/lo shards.
"""

import numpy as np
import torch

from spectra_tpu_torch.linalg.bkldlt import BKFactors
from spectra_tpu_torch.linalg.krylov import KrylovState
from spectra_tpu_torch.matop.dense import DenseSymMatProd
from spectra_tpu_torch.sparse.formats import DiaMatrix, EllMatrix
from spectra_tpu_torch.util.capabilities import resolve_device


def _tensor(arr, device):
    return torch.from_numpy(np.array(arr)).to(device)


def dia_from_numpy(data, offsets, n_rows, n_cols, device=None) -> DiaMatrix:
    """A :class:`DiaMatrix` from row-aligned ``data`` (d, n_rows)."""
    return DiaMatrix(
        data=_tensor(data, resolve_device(device)),
        offsets=tuple(int(o) for o in offsets),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
    )


def ell_from_numpy(cols, vals, n_rows, n_cols, device=None) -> EllMatrix:
    """An :class:`EllMatrix` from padded ``cols``/``vals`` (n_rows, L)."""
    device = resolve_device(device)
    return EllMatrix(
        cols=_tensor(np.asarray(cols, np.int64), device),
        vals=_tensor(vals, device),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
    )


def krylov_state_from_numpy(V, H, f, beta, k, nops, device=None,
                            seed: int = 0) -> KrylovState:
    """A :class:`KrylovState`: V (m, n) and f (n,) on ``device``, H
    (m, m) as a CPU tensor (f64, or c128 for a complex H), the scalars
    as Python numbers."""
    device = resolve_device(device)
    H = np.asarray(H)
    return KrylovState(
        V=_tensor(V, device),
        H=torch.from_numpy(np.array(H, np.complex128 if np.iscomplexobj(H) else np.float64)),
        f=_tensor(f, device),
        beta=float(beta),
        k=int(k),
        nops=int(nops),
        seed=int(seed),
    )


def dense_from_numpy(mat, device=None) -> DenseSymMatProd:
    """A :class:`DenseSymMatProd` holding ``mat`` as it is (already full
    symmetric: no triangle read)."""
    return DenseSymMatProd(mat=_tensor(mat, resolve_device(device)))


def bk_factors_from_numpy(L, d, e, is2x2, perm, ok, device=None) -> BKFactors:
    """:class:`BKFactors` from the arrays of a JAX ``BKFactors``, so that
    the port's ``solve`` runs on the JAX package's factorization."""
    device = resolve_device(device)
    return BKFactors(
        L=_tensor(L, device), d=_tensor(d, device), e=_tensor(e, device),
        is2x2=_tensor(np.asarray(is2x2, bool), device),
        perm=_tensor(np.asarray(perm, np.int64), device),
        ok=bool(ok),
    )


def halo_plan_from_numpy(n, n_parts, rows_per, dists, halo_sizes, send_idx,
                         cols_local, vals_local, b_rows, b_pos, b_vals):
    """A port :class:`~spectra_tpu_torch.parallel.halo_spmv.HaloPlan` from
    the arrays of a JAX ``HaloPlan`` (its fields, in order), for
    :meth:`ShardedEllMatProd.from_plan` on a mesh of ``n_parts`` ranks."""
    from spectra_tpu_torch.parallel.halo_spmv import HaloPlan

    return HaloPlan(
        n=int(n), n_parts=int(n_parts), rows_per=int(rows_per),
        dists=tuple(int(d) for d in dists),
        halo_sizes=tuple(int(h) for h in halo_sizes),
        send_idx=tuple(np.asarray(s, np.int32) for s in send_idx),
        cols_local=np.asarray(cols_local, np.int32),
        vals_local=np.asarray(vals_local),
        b_rows=np.asarray(b_rows, np.int32), b_pos=np.asarray(b_pos, np.int32),
        b_vals=np.asarray(b_vals),
    )


def hilo_shards_from_numpy(data_hi, data_lo, n_dev: int, rows_per: int):
    """The global hi/lo planes (d, n_dev * rows_per) of the JAX package's
    ``ShardedStencilHiLoMatProd`` planes (d, n_dev * n_pad), each
    shard's chunk padding stripped (``stencil_spmv.py:367-380``). The
    planes of a rank of any equal row partition are a column block of
    them (:meth:`ShardedStencilHiLoMatProd.from_planes`)."""
    out = []
    for plane in (data_hi, data_lo):
        plane = np.asarray(plane, np.float32)
        d = plane.shape[0]
        shards = plane.reshape(d, n_dev, plane.shape[1] // n_dev)[:, :, :rows_per]
        out.append(np.ascontiguousarray(shards.reshape(d, n_dev * rows_per)))
    return tuple(out)
