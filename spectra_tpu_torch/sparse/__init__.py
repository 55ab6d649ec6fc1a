"""Device sparse formats (ELLPACK and DIA) and their host converters."""

from spectra_tpu_torch.sparse.formats import (
    DiaMatrix,
    EllMatrix,
    dia_from_scipy,
    ell_from_dense,
    ell_from_scipy,
)

__all__ = [
    "DiaMatrix",
    "EllMatrix",
    "dia_from_scipy",
    "ell_from_dense",
    "ell_from_scipy",
]
