"""Double-single (hi/lo f32) DIA SpMV: the f64 product over f32 planes.

Port of :mod:`spectra_tpu.ops.dia_ds`. The f64 diagonals of a
row-aligned DIA matrix are stored as two f32 planes, ``hi = f32(a)`` and
``lo = f32(a - hi)`` (:func:`split_f64`, an exact two-term decomposition
up to 2^-48 relative), x is split the same way at the call boundary, and
one pass accumulates ``(Ah + Al)(xh + xl)`` in double-single arithmetic
(Dekker two-product with the split constant 4097, Knuth two-sum):
about 2^-48 relative, comparable to f64 round-off. The result comes back
as a renormalized pair ``(yh, yl)``; :func:`combine_f64` turns it into
f64.

Two entry points, as in the reference: :func:`dia_spmv_ds_padded` takes
x planes of length n, with columns outside ``[0, n)`` counting as zero;
:func:`dia_spmv_ds_ext` takes halo-extended x planes of length
``lo + n + hi`` (``lo = max(0, -min offsets)``, ``hi = max(0, max
offsets)``). Both launch the CUDA kernel ``csrc/dia_ds.cu`` for tensors
on the card and run :func:`dia_spmv_ds_plain` / :func:`dia_spmv_ds_ext_plain`
for tensors on the CPU. The plain versions do the kernel's f32
operations one whole vector at a time, each a separately rounded torch
operation, so the two agree bitwise.

The TPU's chunk picker (``pick_hilo_chunk``, ``_vmem_estimate``) encodes
its 16 MB of VMEM and does not carry over: the kernel has no chunks.
What remains is :func:`hilo_suitable`.

``LAUNCHES`` counts kernel launches (CUDA only).
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build

#: Most diagonals the kernel takes (the port's K1 takes as many).
MAX_DIAGS = 64

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_SPLIT = 4097.0  # 2**12 + 1: the f32 Dekker split constant
_KERNELS: dict = {}


def split_f64(x):
    """f64 -> (hi, lo) f32 planes, ``hi = f32(x)``, ``lo = f32(x - hi)``;
    ``|x - (hi + lo)| <= 2^-48 |x|``."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def combine_f64(hi, lo):
    return hi.to(torch.float64) + lo.to(torch.float64)


def hilo_suitable(dtype, n_rows: int, n_cols: int, d: int) -> bool:
    """Whether the kernel takes a DIA matrix: square, f64, 1 to
    :data:`MAX_DIAGS` diagonals."""
    return dtype == torch.float64 and n_rows == n_cols and 1 <= d <= MAX_DIAGS


def _extent(offsets):
    return max(0, -min(offsets)), max(0, max(offsets))


def _dekker_split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def dia_spmv_ds_ext_plain(dh, dl, xh_ext, xl_ext, *, offsets, n: int):
    """The kernel's recurrence (``spectra_tpu/ops/dia_ds.py:154-176``)
    in plain torch over halo-extended x planes ``(lo + n + hi,)``."""
    lo, _ = _extent(offsets)
    xhh, xhl = _dekker_split(xh_ext)  # split x once; each diagonal slices it
    s = torch.zeros(n, dtype=torch.float32, device=xh_ext.device)
    c = torch.zeros_like(s)
    for k, off in enumerate(offsets):
        a, al = dh[k, :n], dl[k, :n]
        win = slice(lo + off, lo + off + n)
        b, bl, bhh, bhl = xh_ext[win], xl_ext[win], xhh[win], xhl[win]
        p = a * b
        ahh, ahl = _dekker_split(a)
        err = ((ahh * bhh - p) + ahh * bhl + ahl * bhh) + ahl * bhl
        err = err + a * bl + al * b
        s, e2 = _two_sum(s, p)
        c = c + (err + e2)
    return _two_sum(s, c)


def dia_spmv_ds_plain(dh, dl, xh, xl, *, offsets, n: int):
    """Plain version of :func:`dia_spmv_ds_padded`: zero-pad the x
    planes by ``(lo, hi)`` and run the recurrence."""
    lo, hi = _extent(offsets)
    pad = torch.nn.functional.pad
    return dia_spmv_ds_ext_plain(
        dh, dl, pad(xh, (lo, hi)), pad(xl, (lo, hi)), offsets=offsets, n=n
    )


def _check(dh, dl, xh, xl, offsets, n: int, x_len: int) -> None:
    if dh.ndim != 2 or dh.shape != dl.shape or dh.shape[0] != len(offsets):
        raise ValueError("dh and dl must have shape (len(offsets), >= n)")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"the kernel takes 1 to {MAX_DIAGS} diagonals")
    if n < 1 or dh.shape[1] < n:
        raise ValueError("the planes must hold n >= 1 rows")
    if xh.shape != (x_len,) or xl.shape != (x_len,):
        raise ValueError(f"the x planes must have shape ({x_len},)")
    tensors = (dh, dl, xh, xl)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("planes must be float32")
    if any(t.device != xh.device for t in tensors):
        raise ValueError("planes must lie on the same device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("planes must be contiguous")


def _kernel(symbol: str):
    fn = _KERNELS.get(symbol)
    if fn is None:
        fn = getattr(_build.load("dia_ds"), symbol)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        head = [ptr, ptr, i64, ptr, ptr, ptr, ptr, i64]
        lo = [i64] if symbol == "spectra_dia_ds_ext" else []
        fn.argtypes = head + lo + [ptr, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _KERNELS[symbol] = fn
    return fn


def _launch(symbol, dh, dl, xh, xl, offsets, n, extra):
    global LAUNCHES
    if xh.device.type != "cuda":
        raise ValueError(f"no double-single DIA SpMV for device {xh.device}")
    yh = torch.empty(n, dtype=torch.float32, device=xh.device)
    yl = torch.empty_like(yh)
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _kernel(symbol)(
            dh.data_ptr(), dl.data_ptr(), dh.shape[1], xh.data_ptr(),
            xl.data_ptr(), yh.data_ptr(), yl.data_ptr(), n, *extra,
            offs, len(offsets), stream,
        )
    if err != 0:
        raise RuntimeError(f"dia_ds kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return yh, yl


def dia_spmv_ds_padded(dh, dl, xh, xl, *, offsets, n: int):
    """``(yh, yl) = A (xh + xl)`` for hi/lo planes ``dh``, ``dl`` of
    shape (d, ld >= n) and x planes of shape (n,)."""
    offsets = tuple(int(o) for o in offsets)
    _check(dh, dl, xh, xl, offsets, n, n)
    if xh.device.type == "cpu":
        return dia_spmv_ds_plain(dh, dl, xh, xl, offsets=offsets, n=n)
    return _launch("spectra_dia_ds_padded", dh, dl, xh, xl, offsets, n, ())


def dia_spmv_ds_ext(dh, dl, xh_ext, xl_ext, *, offsets, n: int):
    """Like :func:`dia_spmv_ds_padded` for halo-extended x planes of
    length ``lo + n + hi``: the halo slots replace the zero padding."""
    offsets = tuple(int(o) for o in offsets)
    lo, hi = _extent(offsets)
    _check(dh, dl, xh_ext, xl_ext, offsets, n, lo + n + hi)
    if xh_ext.device.type == "cpu":
        return dia_spmv_ds_ext_plain(
            dh, dl, xh_ext, xl_ext, offsets=offsets, n=n
        )
    return _launch(
        "spectra_dia_ds_ext", dh, dl, xh_ext, xl_ext, offsets, n, (lo,)
    )
