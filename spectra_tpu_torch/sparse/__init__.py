"""Device sparse formats (ELLPACK, DIA and hi/lo DIA) and their host
converters."""

from spectra_tpu_torch.sparse.formats import (
    DiaHiLoMatrix,
    DiaMatrix,
    EllMatrix,
    dia_from_scipy,
    ell_from_dense,
    ell_from_scipy,
    maybe_hilo,
)

__all__ = [
    "DiaHiLoMatrix",
    "DiaMatrix",
    "EllMatrix",
    "dia_from_scipy",
    "ell_from_dense",
    "ell_from_scipy",
    "maybe_hilo",
]
