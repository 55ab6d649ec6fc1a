"""Double-single (hi/lo f32) DIA SpMV: the f64 product over f32 planes.

Port of :mod:`spectra_tpu.ops.dia_ds`. The f64 diagonals of a
row-aligned DIA matrix are stored as two f32 planes, ``hi = f32(a)`` and
``lo = f32(a - hi)`` (:func:`split_f64`, an exact two-term decomposition
up to 2^-48 relative), x is split the same way, and one pass accumulates
``(Ah + Al)(xh + xl)`` in double-single arithmetic (Dekker two-product
with the split constant 4097, Knuth two-sum): about 2^-48 relative,
comparable to f64 round-off. The result is a renormalized pair
``(yh, yl)``; :func:`combine_f64` turns it into f64.

Three entry points. :func:`dia_spmv_ds_f64` takes f64 x and returns f64
y: it splits x and combines y inside the kernel, in the IEEE operations
of :func:`split_f64` and :func:`combine_f64`, so it is bitwise
``combine_f64(*dia_spmv_ds_padded(dh, dl, *split_f64(x)))`` in one
launch (``DiaHiLoMatrix.matvec`` runs it). The two reference entry points
take x planes: :func:`dia_spmv_ds_padded` of length n, with columns
outside ``[0, n)`` counting as zero; :func:`dia_spmv_ds_ext`
halo-extended planes of length ``lo + n + hi`` (``lo = max(0, -min
offsets)``, ``hi = max(0, max offsets)``). All three launch the CUDA
kernel ``csrc/dia_ds.cu`` for tensors on the card and run their plain
versions (:func:`dia_spmv_ds_f64_plain`, :func:`dia_spmv_ds_plain`,
:func:`dia_spmv_ds_ext_plain`) for tensors on the CPU. The plain
versions do the kernel's operations one whole vector at a time, each a
separately rounded torch operation, so the two agree bitwise. The planes
may have a leading dimension ``ld >= n``; the kernel loads two rows of
them at a time where ``ld`` is even.

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


def dia_spmv_ds_f64_plain(dh, dl, x, *, offsets, n: int):
    """Plain version of :func:`dia_spmv_ds_f64`: split, the padded
    recurrence, combine."""
    yh, yl = dia_spmv_ds_plain(dh, dl, *split_f64(x), offsets=offsets, n=n)
    return combine_f64(yh, yl)


def _check(dh, dl, xs, offsets, n: int, x_len: int, x_dtype) -> None:
    if dh.ndim != 2 or dh.shape != dl.shape or dh.shape[0] != len(offsets):
        raise ValueError("dh and dl must have shape (len(offsets), >= n)")
    if not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"the kernel takes 1 to {MAX_DIAGS} diagonals")
    if n < 1 or dh.shape[1] < n:
        raise ValueError("the planes must hold n >= 1 rows")
    if any(x.shape != (x_len,) for x in xs):
        raise ValueError(f"x must have shape ({x_len},)")
    if dh.dtype != torch.float32 or dl.dtype != torch.float32:
        raise TypeError("planes must be float32")
    if any(x.dtype != x_dtype for x in xs):
        raise TypeError(f"x must be {x_dtype}")
    if any(t.device != dh.device for t in (dl, *xs)):
        raise ValueError("planes and x must lie on the same device")
    if not all(t.is_contiguous() for t in (dh, dl, *xs)):
        raise ValueError("planes and x must be contiguous")


#: Vector arguments of each C entry point, x then y: its signature is
#: (dh, dl, ld, vectors..., n, [lo], offsets, count, stream).
_VECTORS = {
    "spectra_dia_ds_padded": 4,
    "spectra_dia_ds_ext": 4,
    "spectra_dia_ds_f64": 2,
}


def _kernel(symbol: str):
    fn = _KERNELS.get(symbol)
    if fn is None:
        fn = getattr(_build.load("dia_ds"), symbol)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        vectors = [ptr] * _VECTORS[symbol]
        lo = [i64] if symbol == "spectra_dia_ds_ext" else []
        fn.argtypes = [ptr, ptr, i64, *vectors, i64, *lo, ptr, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _KERNELS[symbol] = fn
    return fn


def _launch(symbol, dh, dl, xs, out_dtype, n_out, offsets, n, extra):
    """Launch ``symbol`` on x tensors ``xs``; returns its ``n_out``
    fresh output vectors of length n."""
    global LAUNCHES
    if dh.device.type != "cuda":
        raise ValueError(f"no double-single DIA SpMV for device {dh.device}")
    ys = tuple(
        torch.empty(n, dtype=out_dtype, device=dh.device) for _ in range(n_out)
    )
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    with torch.cuda.device(dh.device):
        stream = torch.cuda.current_stream(dh.device).cuda_stream
        err = _kernel(symbol)(
            dh.data_ptr(), dl.data_ptr(), dh.shape[1],
            *(t.data_ptr() for t in (*xs, *ys)), n, *extra, offs,
            len(offsets), stream,
        )
    if err != 0:
        raise RuntimeError(f"dia_ds kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return ys


def dia_spmv_ds_f64(dh, dl, x, *, offsets, n: int):
    """``y = A x`` in f64 for hi/lo planes ``dh``, ``dl`` of shape
    (d, ld >= n) and f64 x of shape (n,): bitwise
    ``combine_f64(*dia_spmv_ds_padded(dh, dl, *split_f64(x)))``, one
    launch on the card."""
    offsets = tuple(int(o) for o in offsets)
    _check(dh, dl, (x,), offsets, n, n, torch.float64)
    if x.device.type == "cpu":
        return dia_spmv_ds_f64_plain(dh, dl, x, offsets=offsets, n=n)
    (y,) = _launch(
        "spectra_dia_ds_f64", dh, dl, (x,), torch.float64, 1, offsets, n, ()
    )
    return y


def dia_spmv_ds_padded(dh, dl, xh, xl, *, offsets, n: int):
    """``(yh, yl) = A (xh + xl)`` for hi/lo planes ``dh``, ``dl`` of
    shape (d, ld >= n) and x planes of shape (n,)."""
    offsets = tuple(int(o) for o in offsets)
    _check(dh, dl, (xh, xl), offsets, n, n, torch.float32)
    if xh.device.type == "cpu":
        return dia_spmv_ds_plain(dh, dl, xh, xl, offsets=offsets, n=n)
    return _launch(
        "spectra_dia_ds_padded", dh, dl, (xh, xl), torch.float32, 2, offsets,
        n, (),
    )


def dia_spmv_ds_ext(dh, dl, xh_ext, xl_ext, *, offsets, n: int):
    """Like :func:`dia_spmv_ds_padded` for halo-extended x planes of
    length ``lo + n + hi``: the halo slots replace the zero padding."""
    offsets = tuple(int(o) for o in offsets)
    lo, hi = _extent(offsets)
    _check(dh, dl, (xh_ext, xl_ext), offsets, n, lo + n + hi, torch.float32)
    if xh_ext.device.type == "cpu":
        return dia_spmv_ds_ext_plain(
            dh, dl, xh_ext, xl_ext, offsets=offsets, n=n
        )
    return _launch(
        "spectra_dia_ds_ext", dh, dl, (xh_ext, xl_ext), torch.float32, 2,
        offsets, n, (lo,),
    )
