from spectra_tpu_torch.util.compinfo import CompInfo
from spectra_tpu_torch.util.selection import SortRule

__all__ = ["CompInfo", "SortRule"]
