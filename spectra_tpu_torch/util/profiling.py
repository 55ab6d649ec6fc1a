"""Profiling hooks: a device trace and a host phase timer.

Port of :mod:`spectra_tpu.util.profiling`. The reference exposes only
``num_iterations``/``num_operations``; this module adds :func:`trace`,
a context manager around ``torch.profiler`` (the JAX package wraps
``jax.profiler``), and :class:`PhaseTimer`, a wall-clock timer for the
host-driven loops.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work with ``torch.profiler``, CPU activity
    always and CUDA activity when a card is present, and write a Chrome
    trace (readable by TensorBoard's profiler plugin, Perfetto or
    ``chrome://tracing``) to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.

    It reads the host's clock around the enclosed block, as the JAX
    package's does: work the block enqueues on the card counts only as
    far as the block waits for it (a synchronize or a host read).

    >>> t = PhaseTimer()
    >>> with t("spmv"):
    ...     run()
    >>> t.summary()
    {'spmv': {'calls': 1, 'total_s': ...}}
    """

    def __init__(self):
        self._acc: dict = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            slot = self._acc.setdefault(phase, {"calls": 0, "total_s": 0.0})
            slot["calls"] += 1
            slot["total_s"] += dt

    def summary(self) -> dict:
        return {k: dict(v) for k, v in self._acc.items()}

    def reset(self):
        self._acc.clear()
