"""Build and load the port's CUDA kernels and its host library.

Each ``spectra_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into
its own shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Each
``csrc/<name>.cpp`` (host code: the native dense driver and the sparse
toolkit) is compiled the same way by ``g++``. Libraries go to ``build/spectra_tpu_torch/``
at the root of the checkout, named by a hash of the source, the shared
device headers (``csrc/*.cuh``, for ``.cu`` sources) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.
:func:`build_all` starts one compiler per source, all at once. A failed
build raises with the compiler's output.

Nothing is built or loaded at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
CSRC = _ROOT / "spectra_tpu_torch" / "csrc"
BUILD_DIR = _ROOT / "build" / "spectra_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

#: ``g++`` flags for the host sources: the JAX package's own recipe
#: (``spectra_tpu/native/__init__.py::build_and_load``), so that the
#: native driver's arithmetic, FMA contractions included, and with it
#: every restart count, is the JAX package's. Because of
#: ``-march=native`` the library's name also hashes the target that
#: flag means on this host (:func:`_host_target`): a build directory
#: copied to another CPU is rebuilt there, never loaded.
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host library cannot be built")


@functools.cache
def _host_target() -> bytes:
    """What ``-march=native`` enables on this host, as ``g++`` reports
    it."""
    return subprocess.run(
        [_gxx(), "-march=native", "-Q", "--help=target"],
        capture_output=True, check=True,
    ).stdout


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        path = CSRC / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no source {name}.cu or {name}.cpp in {CSRC}")


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def _library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):  # shared device code
            digest.update(header.read_bytes())
    else:
        digest.update(_host_target())
    digest.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for one source unless its library is current.
    Returns ``(process, temp path, final path)`` or ``None``."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else _gxx()
    cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(proc.args[0]).name} failed on {_source(name).name}:\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def sources() -> list:
    """Names of every source under ``csrc/``: the kernels (``.cu``) and
    the host libraries (``.cpp``)."""
    return sorted(p.stem for p in (*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")))


def build_all() -> None:
    """Compile every out-of-date library, one compiler per source, all
    running at once."""
    started = {name: _start(name) for name in sources()}
    for name, s in started.items():
        _finish(name, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_library_path(name)))
        _LIBS[name] = lib
    return lib
