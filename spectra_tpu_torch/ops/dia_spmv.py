"""DIA sparse matrix-vector product: ``y = A x`` over row-aligned diagonals.

Port of :func:`spectra_tpu.ops.dia_pallas.dia_spmv_pallas`. For
``data[k, i] = A[i, i + offsets[k]]``,

    y[i] = sum_k data[k, i] * x[i + offsets[k]],   0 <= i < n_rows,

where x counts as zero outside ``[0, n_cols)``, summed in offset order
from ``+0``. ``x`` may be one vector ``(n_cols,)`` or a block
``(n_cols, ncol)`` (the ``matmat`` of the Rayleigh quotients).

:func:`dia_spmv` launches the CUDA kernel ``csrc/dia_spmv.cu`` for
tensors on the card and runs :func:`dia_spmv_plain` for tensors on the
CPU; it never sends a CUDA tensor to the plain version. Both compute
every term as a rounded multiply followed by a rounded add in the same
order, the out-of-range terms as ``data * 0``, and agree bitwise.

The kernel's launch comes from :func:`launch_config`, chosen from
``n_rows``, ``ncol`` and the card's SM count, once per shape
(:func:`card_launch`). For one vector: block size, whether a thread
stages its loads through shared memory (cp.async) or loads into
registers, and blocks: small matrices (the north star's coarse multigrid
levels) stage, so that all of a row's loads are in flight at once, and
spread over every SM; large ones load into registers, the other rows'
warps hiding the latency. Thread ``t`` of block ``b`` takes row
``(b + s * blocks) * threads + t`` on trip ``s`` of the kernel's
grid-stride loop. For a block of columns (``csrc/dia_block.cuh``): block
size and the rows of a CTA's tile, which takes all ``ncol`` columns of
its rows, stages their data once in shared memory and walks X and Y as
flat row-major arrays, one pack of 16 bytes a thread where ``ncol``
allows it.

``LAUNCHES`` counts kernel launches (CUDA only), so a run can show
that its SpMVs went through the kernel.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from spectra_tpu_torch.ops import _build

#: Most diagonals the kernel takes: above the 40 that a multigrid level
#: may have (:func:`spectra_tpu_torch.linalg.multigrid.build_mg`), and
#: above ``dia_suitability``'s 32, which is a format rule, not a limit
#: of the kernel.
MAX_DIAGS = 64

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

#: Block sizes the kernel takes, and the most blocks it launches (a
#: grid-stride loop covers the rest).
BLOCK_SIZES = (32, 64, 128, 256)
MAX_BLOCKS = 1 << 20

#: Rows below which a vector's loads are staged through shared memory:
#: on an H100 staging halved K1's time at 29,791 rows (31^3) and took 2%
#: more at 226,981 (61^3), where the other rows' warps already hide the
#: latency (PERF.md).
STAGED_ROWS_MAX = 1 << 17

#: Elements of Y a block's tile aims at: one 16-byte f64 pack a thread
#: at 256 threads.
TILE_ELEMENTS = 512
#: Most rows of a block's tile: its staged data, d * rows values, stays
#: within 48 KB at 64 diagonals in f64.
TILE_ROWS_MAX = 96

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_KERNELS: dict = {}


class BlockPlan(NamedTuple):
    """K1's launch for a block of columns: ``threads`` a CTA, tiles of
    ``tile_rows`` rows (all their columns), ``blocks`` CTAs walking the
    tiles in a grid-stride loop."""

    threads: int
    tile_rows: int
    blocks: int


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


def launch_config(n_rows: int, ncol: int, sms: int):
    """K1's launch for ``n_rows`` rows and ``ncol`` columns on a card
    of ``sms`` SMs: ``(threads, staged, blocks)`` for one vector
    (``ncol == 1``), a :class:`BlockPlan` for a block.

    One vector of fewer than ``STAGED_ROWS_MAX`` rows stages its loads
    (the north star's levels 3 and 4, 31^3 and 16^3); larger ones load
    into registers. The block is the largest that still gives every SM
    two blocks (at least 32 threads), so that the 4,096 rows of a 16^3
    level run on 128 SMs rather than 16.

    A block's tile holds about ``TILE_ELEMENTS`` elements of Y (at most
    ``TILE_ROWS_MAX`` rows, at least one), fewer rows where that leaves
    an SM less than two tiles (LOBPCG's 10^4 x 10), and the CTA is the
    smallest that gives each thread one 16-byte f64 pack of the tile.
    The diagonal count does not enter: the kernels unroll the counts
    they know."""
    if ncol > 1:
        rows = min(TILE_ROWS_MAX, max(1, TILE_ELEMENTS // ncol), -(-n_rows // (2 * sms)))
        threads = next(
            (t for t in BLOCK_SIZES if 2 * t >= rows * ncol), BLOCK_SIZES[-1]
        )
        return BlockPlan(threads, rows, min(-(-n_rows // rows), MAX_BLOCKS))
    staged = n_rows < STAGED_ROWS_MAX
    threads = next(
        (t for t in BLOCK_SIZES[::-1] if -(-n_rows // t) >= 2 * sms), BLOCK_SIZES[0]
    )
    return threads, staged, min(-(-n_rows // threads), MAX_BLOCKS)


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
    if data.dtype not in _SUFFIX or x.dtype != data.dtype:
        raise TypeError("data and x must both be float32 or both float64")
    if data.device != x.device:
        raise ValueError("data and x must lie on the same device")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("data and x must be contiguous")


def _kernel(dtype, block: bool):
    """The vector entry ``spectra_dia_spmv_*`` or the block entry
    ``spectra_dia_block_*`` of ``csrc/dia_spmv.cu``."""
    fn = _KERNELS.get((dtype, block))
    if fn is None:
        kind = "block" if block else "spmv"
        fn = getattr(_build.load("dia_spmv"), f"spectra_dia_{kind}_{_SUFFIX[dtype]}")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        sizes = [i64, i64, i64] if block else [i64, i64]
        fn.argtypes = [ptr, ptr, ptr, *sizes, ptr, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _KERNELS[dtype, block] = fn
    return fn


@functools.lru_cache(maxsize=None)
def card_launch(n_rows: int, ncol: int, index: int):
    """:func:`launch_config` on CUDA device ``index`` without the block
    count (the kernel computes it): ``(threads, staged)`` for a vector,
    ``(threads, tile_rows)`` for a block; computed once per shape, so a
    hot call adds one cache lookup."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return launch_config(n_rows, ncol, sms)[:2]


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
    threads, staged_or_rows = card_launch(n_rows, ncol, x.device.index)
    y = torch.empty((n_rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    sizes = (n_rows, n_cols) if ncol == 1 else (n_rows, n_cols, ncol)
    fn = _kernel(data.dtype, ncol > 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            data.data_ptr(), x.data_ptr(), y.data_ptr(), *sizes,
            offs, len(offsets), threads, int(staged_or_rows), stream,
        )
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
