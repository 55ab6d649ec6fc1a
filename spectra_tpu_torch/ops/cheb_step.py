"""One step of the Chebyshev filter's three-term recurrence.

Replaces no Pallas kernel: the JAX package leaves these passes to XLA
(``spectra_tpu/matop/chebyshev.py``). After each product ``y = A t`` of
:class:`spectra_tpu_torch.matop.chebyshev.ChebyshevFilteredOp` it
computes, with ``c`` and ``h`` the centre and half-width of the damped
interval,

    first step:   t_1     = (y - c t) / h
    later steps:  t_{k+1} = 2 (y - c t) / h - t_prev

:func:`cheb_step_plain` is that sequence as five PyTorch operations, the
filter's code before the kernel. :func:`cheb_step` runs it for tensors
on the CPU, and launches ``csrc/cheb_step.cu`` for every tensor on the
card: f32 and f64, and c64 and c128 as their interleaved real view (c
and h are real, so each part is the real recurrence of its own), after
a contiguous copy of any operand that is not contiguous. Operands of
another shape, dtype or device than ``t``, or a dtype the kernel does
not take, raise :class:`ValueError`. On the card the kernel agrees with
the plain sequence bitwise: it rounds each operation on its own in the
same order and divides as PyTorch's CUDA division by a Python scalar
does, by a multiply with the reciprocal (1 / h in double, rounded to the
dtype). For complex operands that holds for finite parts, signed zeros
included; a NaN or inf in one part stays in that part, where PyTorch's
complex multiply by ``c + 0j`` makes both parts NaN.

With ``overwrite`` the kernel writes the result over ``t_prev``, which
the caller no longer needs; the plain sequence always returns a new
tensor. ``LAUNCHES`` counts kernel launches (CUDA only), so a run can
show that its filter went through the kernel.
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

#: The kernel's entry for each dtype it takes; a complex tensor runs the
#: entry of its real part on the interleaved view.
_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
           torch.complex128: "f64", torch.complex64: "f32"}
_KERNELS: dict = {}


def cheb_step_plain(y, t, t_prev, c: float, h: float):
    """The recurrence step as PyTorch operations: ``(y - c t) / h``, and
    for a later step (``t_prev`` given) ``2 (y - c t) / h - t_prev``."""
    q = (y - c * t) / h
    return q if t_prev is None else 2.0 * q - t_prev


def routes_to_kernel(t) -> bool:
    """Whether :func:`cheb_step` launches the kernel: for every tensor on
    the card."""
    return t.is_cuda


def _check(y, t, t_prev) -> None:
    dtype, shape, device = t.dtype, t.shape, t.device
    if dtype not in _SUFFIX:
        raise ValueError(f"the recurrence kernel takes f32, f64, c64 or c128, not {dtype}")
    for name, a in (("y", y), ("t_prev", t_prev)):
        if a is not None and (a.dtype is not dtype or a.shape != shape
                              or a.device != device):
            raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)} on {a.device}, "
                             f"t is {dtype} {tuple(shape)} on {device}")


def _kernel(dtype):
    """The entry ``spectra_cheb_step_*`` of ``csrc/cheb_step.cu``."""
    fn = _KERNELS.get(dtype)
    if fn is None:
        fn = getattr(_build.load("cheb_step"), f"spectra_cheb_step_{_SUFFIX[dtype]}")
        ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, f64, f64, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _KERNELS[dtype] = fn
    return fn


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as its raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def cheb_step(y, t, t_prev, c: float, h: float, overwrite: bool = False):
    """One recurrence step from ``y = A t``, ``t`` and ``t_prev`` (None on
    the first step): :func:`cheb_step_plain` on the CPU, else one kernel
    launch, writing over ``t_prev`` with ``overwrite`` (over its
    contiguous copy where it is not contiguous)."""
    global LAUNCHES
    if not routes_to_kernel(t):
        return cheb_step_plain(y, t, t_prev, c, h)
    _check(y, t, t_prev)
    y, t = y.contiguous(), t.contiguous()
    if t_prev is not None:
        t_prev = t_prev.contiguous()
    out = t_prev if overwrite and t_prev is not None else torch.empty_like(t)
    n = t.numel() * (2 if t.is_complex() else 1)
    if n == 0:
        return out
    index = t.device.index
    err = _kernel(t.dtype)(
        y.data_ptr(), t.data_ptr(), None if t_prev is None else t_prev.data_ptr(),
        out.data_ptr(), n, c, h, index, _stream(index),
    )
    if err != 0:
        raise RuntimeError(f"cheb_step kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
