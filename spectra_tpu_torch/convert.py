"""Build the port's objects from the JAX package's arrays.

The arrays come in as numpy arrays (``np.asarray`` of the JAX
objects), so this module never imports ``spectra_tpu``. The tests use
it to start the port from exactly the JAX package's state, e.g. a
restart compression from one JAX Krylov state.
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
