"""Matrix IO helpers.

Port of :mod:`spectra_tpu.io`. ``load_matrix_market`` reads through the
port's native reader (:func:`spectra_tpu_torch.native.read_matrix_market`)
and returns a scipy CSR matrix ready for the MatProd constructors;
``load_operator`` wraps it in one, on ``device`` (``None`` means the
GPU).
"""

from spectra_tpu_torch import native


def load_matrix_market(path: str):
    """Read a Matrix Market (.mtx) file into a scipy CSR matrix."""
    return native.read_matrix_market(path)


def load_operator(path: str, kind: str = "sym", device=None, **kwargs):
    """Read a .mtx file and wrap it in the matching MatProd operator on
    ``device``. ``kind``: "sym" | "gen" | "herm"."""
    if kind not in ("sym", "gen", "herm"):
        raise ValueError("kind must be 'sym', 'gen' or 'herm'")
    mat = load_matrix_market(path)
    from spectra_tpu_torch.matop import sparse as msp

    if kind == "sym":
        return msp.SparseSymMatProd.from_full(mat, device=device, **kwargs)
    if kind == "gen":
        return msp.SparseGenMatProd.create(mat, device=device, **kwargs)
    return msp.SparseHermMatProd.create(mat, device=device, **kwargs)
