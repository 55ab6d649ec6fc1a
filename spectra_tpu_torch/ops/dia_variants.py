"""Cost probes of the DIA SpMV (K1), in f32.

Port of the TPU probes ``scripts/tpu_dia_variants.py`` (``dia_noshift``,
``dia_roll2d``) and ``scripts/tpu_dia_f32_ceiling.py``
(``dia_spmv_f32``). None is on a solver path: ``chip_smoke.py`` times
them beside K1 and K2 to take apart what K1's time is made of.

* :func:`dia_noshift`: ``y[i] = sum_k data[k, i] * x[i]``, K1 with
  every slice aligned at the row, wrong on purpose; what it saves
  against K1 is the cost of the shifted x reads.
* :func:`dia_roll2d`: the correct ``y = A x`` with each block's x
  window staged once in shared memory (the TPU probe's ``(rows, 128)``
  VMEM window); its plain version transcribes the TPU body on the
  ``(R, 128)`` layout with ``torch.roll`` and ``torch.where``.
* :func:`dia_spmv_f32`: exactly K1's function in f32, so it runs K1's
  own f32 kernel (``ops/dia_spmv.py``); the TPU probe's ``chunk`` was a
  VMEM tile size and does not carry over.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel (``csrc/dia_variants.cu``, or K1's) for tensors on the card;
a CUDA tensor it does not take raises. The kernels round every product
and sum separately, so they agree bitwise with the plain versions.
``LAUNCHES`` counts launches of the two kernels of this module (CUDA
only); ``dia_spmv_f32`` counts in K1's ``LAUNCHES``.
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build
from spectra_tpu_torch.ops import dia_spmv as _k1

LANES = 128

#: Dynamic shared memory one block may use on Hopper.
MAX_SHARED_BYTES = 227 * 1024

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"dia_noshift": 0, "dia_roll2d": 0}

_KERNELS: dict = {}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_rows_for(offsets) -> int:
    """Rows of 128 that the x window reaches past each side of a block:
    ``round_up(round_up(max|off| + 128, 128) / 128, 4)``, as the TPU
    probe chose it (12 for the g=1000 Laplacian)."""
    maxoff = max(abs(int(o)) for o in offsets)
    return _round_up(_round_up(maxoff + LANES, LANES) // LANES, 4)


def window_bytes(offsets, rows: int) -> int:
    """Shared memory that a ``dia_roll2d`` block of ``rows`` takes."""
    return (rows + 2 * pad_rows_for(offsets)) * LANES * 4


def dia_noshift_plain(data, x):
    acc = data[0] * x
    for k in range(1, data.shape[0]):
        acc = acc + data[k] * x
    return acc


def dia_roll2d_plain(data, offsets, x, rows: int = 256):
    """The TPU probe's body on the ``(R, 128)`` layout: x padded by
    ``pad_rows`` rows of zeros on each side, each diagonal's operand
    built from two row-shifted views, rotated left by ``off mod 128``
    and joined at lane ``128 - r``."""
    d, n = data.shape
    pad_rows = pad_rows_for(offsets)
    R = (n + LANES - 1) // LANES
    Rp = _round_up(R, rows)
    xp = torch.nn.functional.pad(
        x, (pad_rows * LANES, (Rp * LANES - n) + pad_rows * LANES)
    ).reshape(-1, LANES)
    dp = torch.nn.functional.pad(data, (0, Rp * LANES - n)).reshape(d, Rp, LANES)
    lane = torch.arange(LANES, device=x.device)
    acc = None
    for k, off in enumerate(offsets):
        s, r = divmod(int(off), LANES)
        base = xp[pad_rows + s : pad_rows + s + Rp]
        if r == 0:
            shifted = base
        else:
            nxt = xp[pad_rows + s + 1 : pad_rows + s + 1 + Rp]
            shifted = torch.where(
                lane < LANES - r,
                torch.roll(base, -r, dims=1),
                torch.roll(nxt, -r, dims=1),
            )
        term = dp[k] * shifted
        acc = term if acc is None else acc + term
    return acc.reshape(-1)[:n]


def dia_spmv_f32_plain(data, offsets, x):
    return _k1.dia_spmv_plain(data, offsets, x, x.shape[0])


def _check(data, offsets, x) -> None:
    if data.ndim != 2 or data.shape[0] != len(offsets) or data.shape[0] < 1:
        raise ValueError("data must have shape (len(offsets), n) with d >= 1")
    if not len(offsets) <= _k1.MAX_DIAGS:
        raise ValueError(f"the kernels take at most {_k1.MAX_DIAGS} diagonals")
    if x.ndim != 1 or x.shape[0] != data.shape[1] or x.shape[0] < 1:
        raise ValueError("x must be a non-empty (n,) vector")
    if data.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("the probes run in float32")
    if data.device != x.device:
        raise ValueError("data and x must lie on the same device")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DIA probe for device {x.device}")


def _kernel(name: str, argtypes):
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(_build.load("dia_variants"), f"spectra_{name}_f32")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _launch(name: str, argtypes, x, *args):
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(name, argtypes)(*args[:2], y.data_ptr(), *args[2:], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def dia_noshift(data, offsets, x):
    """``y[i] = sum_k data[k, i] * x[i]`` (wrong on purpose: a cost
    probe) for f32 ``data`` (d, n) and ``x`` (n,)."""
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x)
    if x.device.type == "cpu":
        return dia_noshift_plain(data, x)
    p = ctypes.c_void_p
    return _launch(
        "dia_noshift", [p, p, p, ctypes.c_int64, ctypes.c_int, p], x,
        data.data_ptr(), x.data_ptr(), x.shape[0], len(offsets),
    )


def dia_roll2d(data, offsets, x, rows: int = 256):
    """``y = A x`` for f32 row-aligned DIA ``data`` (d, n), each block of
    ``rows`` x 128 outputs reading x from a window staged in shared
    memory."""
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x)
    if rows < 1:
        raise ValueError("rows must be >= 1")
    if x.device.type == "cpu":
        return dia_roll2d_plain(data, offsets, x, rows)
    if window_bytes(offsets, rows) > MAX_SHARED_BYTES:
        raise ValueError(
            f"the x window of {window_bytes(offsets, rows)} bytes exceeds "
            f"the {MAX_SHARED_BYTES} bytes of shared memory a block may use"
        )
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    p = ctypes.c_void_p
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    return _launch(
        "dia_roll2d",
        [p, p, p, ctypes.c_int64, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p],
        x, data.data_ptr(), x.data_ptr(), x.shape[0], offs, len(offsets),
        int(rows), pad_rows_for(offsets),
    )


def dia_spmv_f32(data, offsets, x):
    """``y = A x`` in f32 through K1's f32 kernel."""
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x)
    return _k1.dia_spmv(data, offsets, x, x.shape[0])
