"""Tall-skinny Householder QR of an (n, c) block, c <= ``MAX_COLS``.

Replaces no Pallas kernel: the JAX package leaves this QR to XLA
(``spectra_tpu/linalg/orthogonalization.py``). On the card it takes the
place of ``torch.linalg.qr`` in
:func:`spectra_tpu_torch.linalg.orthogonalization.qr_orthogonalisation`,
the QR of the Jacobi-Davidson correction blocks, where cuSOLVER reduces
a (10^6, 10) block one column at a time over all its rows.

:func:`tsqr` returns the reduced ``(Q, R)`` of a block on the card with
R's diagonal made non-negative (where ``R_jj < 0`` row j of R and column
j of Q change sign; a zero ``R_jj`` counts as +1) and Q row-major and
contiguous. It launches ``csrc/tsqr.cu``: panels of rows factored in
registers, their R factors stacked and factored again until one panel
is left, then Q formed from the top down (the source's note has the
passes, their bytes and the workspace, whose size the source gives).
Its plain version is :func:`tsqr_plain`, ``torch.linalg.qr`` and the
sign fix, which the CPU runs: the same Householder QR with the same
sign convention, summed in another order, so the two agree to rounding,
not bitwise.

:func:`routes_to_kernel` says which blocks the kernel takes;
``LAUNCHES`` counts the QRs it did (CUDA only), one a QR whatever the
number of launches it took.
"""

import ctypes

import torch

from spectra_tpu_torch.ops import _build

#: Widest block the kernel takes.
MAX_COLS = 32

#: QRs done by the kernel since import (or since a caller reset it to 0).
LAUNCHES = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_KERNELS: dict = {}


def routes_to_kernel(device_type: str, dtype, shape) -> bool:
    """Whether :func:`qr_orthogonalisation` gives a block of this
    device type, dtype and shape to the kernel: a real f64 or f32 2-D
    block on the card with 1 <= c <= ``MAX_COLS`` and at least c rows.
    Everything else goes to ``torch.linalg.qr``."""
    return (
        device_type == "cuda" and dtype in _SUFFIX and len(shape) == 2
        and 1 <= shape[1] <= MAX_COLS and shape[0] >= shape[1]
    )


def tsqr_plain(A):
    """``torch.linalg.qr`` with R's diagonal made non-negative: the
    kernel's plain version, and the QR of every block the kernel does not
    take (complex ones too: there Q's column j is multiplied by the
    conjugate of ``sgn(R_jj)``, row j of R by ``sgn(R_jj)``)."""
    Q, R = torch.linalg.qr(A)
    d = torch.diagonal(R)
    signs = torch.sgn(torch.where(d == 0, torch.ones_like(d), d))
    return (Q * signs.conj()[None, :]).contiguous(), signs[:, None] * R


def _check(A) -> None:
    if A.dtype not in _SUFFIX:
        raise TypeError("the kernel takes a float32 or float64 block")
    if A.ndim != 2:
        raise ValueError("A must be a 2-D block (n, c)")
    if not 1 <= A.shape[1] <= MAX_COLS:
        raise ValueError(f"A must have 1 to {MAX_COLS} columns")
    if A.shape[0] < A.shape[1]:
        raise ValueError("A must have at least as many rows as columns")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")


def _kernel(dtype):
    """The entries of ``csrc/tsqr.cu``: ``spectra_tsqr_workspace`` and
    the QR ``spectra_tsqr_*`` of this dtype."""
    fn = _KERNELS.get(dtype)
    if fn is None:
        lib = _build.load("tsqr")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        workspace = lib.spectra_tsqr_workspace
        workspace.argtypes = [i64, i32]
        workspace.restype = i64
        qr = getattr(lib, f"spectra_tsqr_{_SUFFIX[dtype]}")
        qr.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
        qr.restype = ctypes.c_int
        fn = _KERNELS[dtype] = (workspace, qr)
    return fn


def tsqr(A):
    """The reduced QR ``(Q, R)`` of the contiguous real (n, c) block A on
    the card, R's diagonal non-negative. The CPU's QR is
    :func:`tsqr_plain`."""
    global LAUNCHES
    _check(A)
    if A.device.type != "cuda":
        raise ValueError(f"the kernel takes a tensor on the card, not on {A.device}")
    n, c = A.shape
    workspace, qr = _kernel(A.dtype)
    Q = torch.empty_like(A)
    R = torch.empty((c, c), dtype=A.dtype, device=A.device)
    work = torch.empty(workspace(n, c), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = qr(A.data_ptr(), Q.data_ptr(), R.data_ptr(), work.data_ptr(), n, c, stream)
    if err != 0:
        raise RuntimeError(f"tsqr kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return Q, R
