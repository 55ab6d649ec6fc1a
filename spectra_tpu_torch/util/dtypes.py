"""Floating-point traits on torch dtypes.

Port of :mod:`spectra_tpu.util.dtypes` (reference:
include/Spectra/Util/TypeTraits.h): machine epsilon, a guarded
smallest-normal, and the derived thresholds the ARPACK-style
convergence and re-orthogonalization rules depend on.
"""

import numpy as np
import torch


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real scalar type underlying ``dtype`` (identity for reals)."""
    return dtype.to_real() if dtype.is_complex else dtype


def numpy_dtype(dtype):
    """The numpy dtype of ``dtype``, a torch or numpy dtype (``None``
    stays ``None``)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def eps(dtype: torch.dtype) -> float:
    """Machine epsilon of the real type underlying ``dtype``."""
    return float(torch.finfo(real_dtype(dtype)).eps)


def near_zero(dtype: torch.dtype) -> float:
    """10x smallest normal: 'a very small value whose reciprocal does not
    overflow' (reference: HermEigsBase.h:181-184)."""
    return float(torch.finfo(real_dtype(dtype)).tiny) * 10.0


def eps23(dtype: torch.dtype) -> float:
    """eps^(2/3), the ARPACK convergence-threshold floor
    (reference: HermEigsBase.h:160-166)."""
    return eps(dtype) ** (2.0 / 3.0)
