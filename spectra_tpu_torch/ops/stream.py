"""Streaming-bandwidth probe: ``y = 2 x`` over f32.

Port of the probe ``scripts/tpu_pallas_stream_probe.py::scale_pallas``.
It is no part of a solver: ``chip_smoke.py`` times it to measure the
bytes per second the card's device memory streams for a hand-written
kernel, the yardstick beside the data-sheet rate for every fraction of a
memory bound that the port reports.

:func:`stream_scale2` launches ``csrc/stream_scale.cu`` for a tensor on
the card and runs :func:`stream_scale2_plain` for one on the CPU. The
multiply by two is exact, so the two agree bitwise. ``LAUNCHES`` counts
kernel launches (CUDA only).
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_KERNEL: list = []


def stream_scale2_plain(x):
    return x * 2.0


def _kernel():
    if not _KERNEL:
        fn = _build.load("stream_scale").spectra_stream_scale2_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNEL.append(fn)
    return _KERNEL[0]


def stream_scale2(x):
    """``2 x`` for a contiguous 1-D float32 tensor."""
    global LAUNCHES
    if x.ndim != 1 or x.numel() < 1 or x.dtype != torch.float32:
        raise ValueError("x must be a non-empty 1-D float32 tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return stream_scale2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no stream probe for device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"stream_scale kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
