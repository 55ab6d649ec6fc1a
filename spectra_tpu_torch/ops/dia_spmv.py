"""DIA sparse matrix-vector product: ``y = A x`` over row-aligned diagonals.

Port of :func:`spectra_tpu.ops.dia_pallas.dia_spmv_pallas`. For
``data[k, i] = A[i, i + offsets[k]]``,

    y[i] = sum_k data[k, i] * x[i + offsets[k]],   0 <= i < n_rows,

where terms whose column falls outside ``[0, n_cols)`` count as zero,
summed in offset order from ``k = 0``. ``x`` may be one vector
``(n_cols,)`` or a block ``(n_cols, ncol)`` (the ``matmat`` of the
Rayleigh quotients).

:func:`dia_spmv` launches the CUDA kernel ``csrc/dia_spmv.cu`` for
tensors on the card and runs :func:`dia_spmv_plain` for tensors on the
CPU; it never sends a CUDA tensor to the plain version. The kernel is
built with ``-fmad=false``, so both compute every term as a rounded
multiply followed by a rounded add in the same order, and agree
bitwise.

``LAUNCHES`` counts kernel launches (CUDA only), so a run can show
that its SpMVs went through the kernel.
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build

#: Most diagonals the kernel takes: above the 40 that a multigrid level
#: may have (:func:`spectra_tpu_torch.linalg.multigrid.build_mg`), and
#: above ``dia_suitability``'s 32, which is a format rule, not a limit
#: of the kernel.
MAX_DIAGS = 64

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_SYMBOLS = {
    torch.float64: "spectra_dia_spmv_f64",
    torch.float32: "spectra_dia_spmv_f32",
}
_KERNELS: dict = {}


def dia_spmv_plain(data, offsets, x, n_cols: int):
    """The shifted-slice sum of ``DiaMatrix.matvec``/``matmat``
    (``spectra_tpu/sparse/formats.py:173-196``) in plain torch: pad x
    with zero rows, then add one shifted slice per diagonal."""
    n_rows = data.shape[1]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets)) + max(0, n_rows - n_cols)
    tail = x.shape[1:]
    xp = torch.cat(
        [
            torch.zeros((lo, *tail), dtype=x.dtype, device=x.device),
            x,
            torch.zeros((hi, *tail), dtype=x.dtype, device=x.device),
        ]
    )
    y = torch.zeros((n_rows, *tail), dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        d = data[k] if x.ndim == 1 else data[k][:, None]
        y = y + d * xp[lo + off : lo + off + n_rows]
    return y


def _check(data, offsets, x, n_cols: int) -> None:
    if data.ndim != 2 or data.shape[0] != len(offsets):
        raise ValueError("data must have shape (len(offsets), n_rows)")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"the kernel takes 1 to {MAX_DIAGS} diagonals")
    if data.shape[1] < 1:
        raise ValueError("the matrix has no rows")
    if x.ndim not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(f"x must have shape ({n_cols},) or ({n_cols}, k)")
    if x.ndim == 2 and not 1 <= x.shape[1] <= 65535:
        raise ValueError("x must have 1 to 65535 columns")
    if data.dtype not in _SYMBOLS or x.dtype != data.dtype:
        raise TypeError("data and x must both be float32 or both float64")
    if data.device != x.device:
        raise ValueError("data and x must lie on the same device")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")


def _kernel(dtype):
    fn = _KERNELS.get(dtype)
    if fn is None:
        fn = getattr(_build.load("dia_spmv"), _SYMBOLS[dtype])
        ptr = ctypes.c_void_p
        fn.argtypes = [
            ptr, ptr, ptr,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ptr, ctypes.c_int, ptr,
        ]
        fn.restype = ctypes.c_int
        _KERNELS[dtype] = fn
    return fn


def dia_spmv(data, offsets, x, n_cols: int):
    """``y = A x`` for row-aligned DIA ``data`` (d, n_rows) with
    ``offsets`` (d Python ints), on x ``(n_cols,)`` or
    ``(n_cols, ncol)``."""
    global LAUNCHES
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x, n_cols)
    if x.device.type == "cpu":
        return dia_spmv_plain(data, offsets, x, n_cols)
    if x.device.type != "cuda":
        raise ValueError(f"no DIA SpMV for device {x.device}")
    n_rows = data.shape[1]
    ncol = 1 if x.ndim == 1 else x.shape[1]
    y = torch.empty((n_rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    fn = _kernel(data.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            data.data_ptr(), x.data_ptr(), y.data_ptr(),
            n_rows, n_cols, ncol, offs, len(offsets), stream,
        )
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
