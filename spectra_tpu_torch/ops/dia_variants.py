"""Cost probes of the DIA SpMV (K1), in f32.

Port of the TPU probes ``scripts/tpu_dia_variants.py`` (``dia_noshift``,
``dia_roll2d``) and ``scripts/tpu_dia_f32_ceiling.py``
(``dia_spmv_f32``). None is on a solver path: ``chip_smoke.py`` times
them beside K1 and K2 to take apart what K1's time is made of.

* :func:`dia_noshift`: ``y[i] = sum_k data[k, i] * x[i]``, K1 with
  every slice aligned at the row, wrong on purpose; it runs K1's own
  kernel body and launch configuration (``csrc/dia_rows.cuh``,
  :func:`spectra_tpu_torch.ops.dia_spmv.card_launch`) with the shifted
  reads removed, so what it saves against K1 is the cost of the shifted
  x reads.
* :func:`dia_roll2d`: the correct ``y = A x`` with each tile of
  ``rows`` x 128 outputs reading x from one window staged in shared
  memory (the TPU probe's ``(rows, 128)`` VMEM window), shared across a
  thread-block cluster; its launch comes from :func:`roll2d_plan`,
  cached per shape by :func:`card_plan`. Its plain version transcribes
  the TPU body on the ``(R, 128)`` layout with ``torch.roll`` and
  ``torch.where``.
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
import functools
from typing import NamedTuple

import torch

from spectra_tpu_torch.ops import _build
from spectra_tpu_torch.ops import dia_spmv as _k1

LANES = 128

#: Shared memory one block may use on Hopper, and the part of it that
#: ``roll2d``'s static arrays (mbarriers, per-diagonal indices) may take.
MAX_SHARED_BYTES = 227 * 1024
STATIC_SHARED_BYTES = 1024

#: ``dia_roll2d``: thread-block cluster sizes (above 8 non-portable),
#: threads a CTA (at most 512 at d = 27, whose 54 values a thread need
#: more than the 64 registers of a 1024-thread block), and what an SM
#: holds at once.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
BLOCK_SIZES = (256, 512, 1024)
THREADS_PER_SM = 2048
SM_SHARED_BYTES = 228 * 1024

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"dia_noshift": 0, "dia_roll2d": 0}

_KERNELS: dict = {}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_rows_for(offsets) -> int:
    """Rows of 128 that the TPU probe's x window reached past each side
    of a block: ``round_up(round_up(max|off| + 128, 128) / 128, 4)``, a
    Mosaic sublane rule (12 for the g=1000 Laplacian). The plain version
    pads by it; the kernel pads by :func:`halo_for`."""
    maxoff = max(abs(int(o)) for o in offsets)
    return _round_up(_round_up(maxoff + LANES, LANES) // LANES, 4)


def halo_for(offsets) -> int:
    """Values of x that a tile's window reaches past each side of the
    tile: max|off| rounded up to 4 floats (16 bytes, what a bulk copy
    needs)."""
    return _round_up(max(abs(int(o)) for o in offsets), 4)


def window_bytes(offsets, rows: int) -> int:
    """Bytes of a tile's x window, ``rows`` x 128 outputs plus the halo
    on each side: what a tile reads of x from device memory, held in
    shares across its cluster (:func:`roll2d_plan`)."""
    return (rows * LANES + 2 * halo_for(offsets)) * 4


class Roll2dPlan(NamedTuple):
    """The launch of ``dia_roll2d``: ``tiles`` tiles of ``tile`` outputs,
    each on a cluster of ``cluster`` CTAs; a CTA computes ``per_cta``
    outputs with ``threads`` threads and holds ``share`` window values
    (``shared_bytes`` of shared memory, static arrays included)."""

    tile: int
    tiles: int
    cluster: int
    per_cta: int
    threads: int
    halo: int
    share: int
    shared_bytes: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster


def held_at_once(plan: Roll2dPlan, sms: int) -> int:
    """Clusters of ``plan`` that ``sms`` SMs hold at once by threads and
    shared memory (``THREADS_PER_SM``, ``SM_SHARED_BYTES``):
    :func:`roll2d_plan`'s model where the card is not asked
    (:func:`card_plan` asks it)."""
    ctas = min(THREADS_PER_SM // plan.threads, SM_SHARED_BYTES // (plan.shared_bytes + 1024))
    return ctas * sms // plan.cluster


def roll2d_candidates(n: int, offsets, rows: int) -> list:
    """Every launch of ``dia_roll2d`` for ``n`` rows, ``offsets`` and
    ``rows`` whose CTAs fit in shared memory: tiles of ``rows`` x 128
    outputs, each window split in ``cluster`` equal shares of a multiple
    of 4 values, one a CTA, for each cluster and block size. Raises
    ``ValueError`` when no cluster size fits in ``MAX_SHARED_BYTES``."""
    if rows < 1:
        raise ValueError("rows must be >= 1")
    tile = rows * LANES
    tiles = -(-n // tile)
    halo = halo_for(offsets)
    sizes = [t for t in BLOCK_SIZES if t <= (512 if len(offsets) == 27 else 1024)]
    plans = []
    for c in CLUSTER_SIZES:
        share = max(_round_up(-(-(tile + 2 * halo) // c), 4), 4)
        shared = _round_up(share * 4, 128) + STATIC_SHARED_BYTES
        if shared <= MAX_SHARED_BYTES:
            plans += [Roll2dPlan(tile, tiles, c, tile // c, t, halo, share, shared)
                      for t in sizes]
    if not plans:
        raise ValueError(
            f"the x window of {window_bytes(offsets, rows)} bytes does not fit "
            f"the {MAX_SHARED_BYTES} bytes of shared memory a CTA may use even "
            f"in shares of {CLUSTER_SIZES[-1]} (rows={rows}, max|off|={halo})"
        )
    return plans


def roll2d_plan(n: int, offsets, rows: int, sms: int, clusters_at_once=None) -> Roll2dPlan:
    """The launch of ``dia_roll2d`` for ``n`` rows, ``offsets`` and
    ``rows`` on a card of ``sms`` SMs.

    Of :func:`roll2d_candidates` that give at least as many CTAs as SMs
    (or as the tiles allow), the plan takes one whose tiles the card holds
    at once (``clusters_at_once(plan)``, default :func:`held_at_once`;
    one wave, so no tile waits for another's): the fewest threads that
    give one thread per output, else the most threads. Where none is held
    at once, the one the card holds most threads of. On a tie, the smaller
    cluster, whose reads stay more in the CTA's own share."""
    if clusters_at_once is None:
        clusters_at_once = lambda p: held_at_once(p, sms)
    plans = roll2d_candidates(n, offsets, rows)
    wide = min(sms, max(p.ctas for p in plans))
    plans = [p for p in plans if p.ctas >= wide]
    total = lambda p: p.ctas * p.threads
    held = {p: clusters_at_once(p) for p in plans}
    one_wave = [p for p in plans if p.tiles <= held[p]]
    enough = [p for p in one_wave if total(p) >= n]
    if enough:
        return min(enough, key=lambda p: (total(p), p.cluster))
    if one_wave:
        return min(one_wave, key=lambda p: (-total(p), p.cluster))
    return min(plans, key=lambda p: (-held[p] * p.cluster * p.threads, p.cluster, p.threads))


@functools.lru_cache(maxsize=None)
def card_plan(n: int, offsets: tuple, rows: int, index: int) -> Roll2dPlan:
    """:func:`roll2d_plan` on CUDA device ``index``, computed once per
    shape, with the clusters the card holds at once asked of the card."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return roll2d_plan(n, offsets, rows, sms,
                       clusters_at_once=lambda p: card_clusters(p, len(offsets), index))


@functools.lru_cache(maxsize=None)
def card_clusters(plan: Roll2dPlan, d: int, index: int) -> int:
    """Clusters of ``plan`` at ``d`` diagonals that CUDA device ``index``
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = _KERNELS.get("clusters")
    if fn is None:
        fn = _build.load("dia_variants").spectra_dia_roll2d_clusters_f32
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _KERNELS["clusters"] = fn
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(d, plan.cluster, plan.threads, plan.share, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"dia_roll2d occupancy query failed: CUDA error {err}")
    return out.value


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
    threads, staged = _k1.card_launch(x.shape[0], 1, x.device.index)
    p, i = ctypes.c_void_p, ctypes.c_int
    return _launch(
        "dia_noshift", [p, p, p, ctypes.c_int64, i, i, i, p], x,
        data.data_ptr(), x.data_ptr(), x.shape[0], len(offsets), threads,
        int(staged),
    )


def dia_roll2d(data, offsets, x, rows: int = 256):
    """``y = A x`` for f32 row-aligned DIA ``data`` (d, n), each tile of
    ``rows`` x 128 outputs reading x from one window staged in shared
    memory across a thread-block cluster."""
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x)
    if rows < 1:
        raise ValueError("rows must be >= 1")
    if x.device.type == "cpu":
        return dia_roll2d_plain(data, offsets, x, rows)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    plan = card_plan(x.shape[0], offsets, rows, x.device.index)
    p, i = ctypes.c_void_p, ctypes.c_int
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    return _launch(
        "dia_roll2d", [p, p, p, ctypes.c_int64, p, i, i, i, i, i, i, p], x,
        data.data_ptr(), x.data_ptr(), x.shape[0], offs, len(offsets),
        plan.tile, plan.cluster, plan.halo, plan.share, plan.threads,
    )


def dia_spmv_f32(data, offsets, x):
    """``y = A x`` in f32 through K1's f32 kernel."""
    offsets = tuple(int(o) for o in offsets)
    _check(data, offsets, x)
    return _k1.dia_spmv(data, offsets, x, x.shape[0])
