"""numpy's OpenBLAS thread pool, held to the calling thread for one call.

numpy's LAPACK (the OpenBLAS that a numpy wheel carries in its
``numpy.libs`` folder) runs one thread per core by default. On a small
matrix, waking those threads costs more than the arithmetic, and while
they spin after the call they hold the cores that PyTorch's own thread
pool wants next. :func:`one_thread` holds the pool to one thread for the
enclosed call and gives the previous count back afterwards.

The pool is found once, at first use, through the library's C interface
(``openblas_get_num_threads`` / ``openblas_set_num_threads``, under the
affixes a ``scipy_openblas`` build gives them). Where numpy carries no
OpenBLAS of its own, :func:`pool` is None and nothing is limited.
"""

import contextlib
import ctypes
import functools
import itertools
import threading
from pathlib import Path

import numpy as np

from spectra_tpu_torch.util.profiling import span


class Pool:
    """A BLAS library's thread count, read and set through its C
    interface; one lock orders the callers that limit it."""

    def __init__(self, get, set_):
        self._get, self._set = get, set_
        self.lock = threading.Lock()

    def threads(self) -> int:
        return int(self._get())

    def set_threads(self, n: int):
        self._set(int(n))


def _symbols(lib):
    """The (get, set) thread-count functions of an OpenBLAS, or None."""
    for pre, suf in itertools.product(("", "scipy_"), ("", "64_", "_64")):
        get = getattr(lib, f"{pre}openblas_get_num_threads{suf}", None)
        set_ = getattr(lib, f"{pre}openblas_set_num_threads{suf}", None)
        if get is not None and set_ is not None:
            get.argtypes, get.restype = [], ctypes.c_int
            set_.argtypes, set_.restype = [ctypes.c_int], None
            return get, set_
    return None


@functools.cache
def pool():
    """The :class:`Pool` of the OpenBLAS that numpy loaded, or None.

    A wheel's ``numpy.libs`` holds the libraries numpy's extensions link
    to; opening one that is loaded already returns the loaded copy."""
    for path in sorted((Path(np.__file__).parent.parent / "numpy.libs").glob("*openblas*")):
        try:
            found = _symbols(ctypes.CDLL(str(path)))
        except OSError:
            continue
        if found is not None:
            return Pool(*found)
    return None


@contextlib.contextmanager
def one_thread():
    """Hold numpy's BLAS pool to one thread for the enclosed call, and
    restore its count afterwards, also when the call raises. Opens the
    span ``eigh.one_thread`` where the limit took hold; does nothing
    where there is no pool to hold."""
    p = pool()
    if p is None:
        yield
        return
    with p.lock:
        before = p.threads()
        p.set_threads(1)
        try:
            with span("eigh.one_thread") if p.threads() == 1 else contextlib.nullcontext():
                yield
        finally:
            p.set_threads(before)
