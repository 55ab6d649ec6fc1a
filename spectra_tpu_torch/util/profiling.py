"""Profiling hooks: a device trace and the program's spans.

Port of :mod:`spectra_tpu.util.profiling`. The reference exposes only
``num_iterations``/``num_operations``; this module adds :func:`trace`,
a context manager around ``torch.profiler`` (the JAX package wraps
``jax.profiler``), and :func:`span`, the named ranges the solvers open
at their layer boundaries (:data:`SPANS`).

A span is a ``torch.profiler.record_function`` while a torch profiler
runs (:func:`trace`, or any ``torch.profiler.profile``), so it lies on
the profiler's clock beside the device's kernels and copies; otherwise
it is a shared no-op context, and opening one costs one attribute read.
"""

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

#: Every span the program opens, outermost first.
SPANS = (
    "cheb.bounds",  # the spectrum bounds' short Lanczos run, in the solver's constructor
    "cheb.rayleigh",  # V y and the Rayleigh quotients of the filtered solver's answer
    "irlm.start",  # the first ncv-step factorization and Ritz extraction
    "irlm.restart",  # one restart: shifts or collapse, compression, re-expansion, extraction
    "irlm.finalize",  # the back-transform and sort of the Ritz pairs
    "irlm.shifts",  # a restart's host half: the shift sweep (thick: the eigh and V Y)
    "irlm.compress",  # V Q and the new residual of an implicit restart
    "irlm.ritz",  # the Ritz eigh of the projection and the convergence test
    "jd.iteration",  # one Jacobi-Davidson iteration
    "jd.collapse",  # the restart of the search space to the leading Ritz vectors
    "jd.apply",  # the operator on the new columns of the search space
    "jd.rayleigh_ritz",  # the Gram product V^T A V and its host eigh
    "jd.eigh",  # the host eigh of the Rayleigh matrix, inside jd.rayleigh_ritz
    "jd.residual",  # Ritz vectors, residuals and their norms read to the host; convergence
    "jd.correction",  # the correction of the leading Ritz pairs (DPR for Davidson)
    "jd.orthogonalize",  # the correction projected off the basis and QR'd, twice
    "krylov.step",  # one Lanczos or Arnoldi step: the operator, the coefficients, the checks
    "krylov.reorth",  # the DGKS re-orthogonalization of a step's residual
    "cheb.filter",  # one filtered product: degree products of the operator and the recurrence
    "eigh.one_thread",  # a host eigh held to one BLAS thread (util/blas_threads.py)
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` while a torch profiler
    runs, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


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
