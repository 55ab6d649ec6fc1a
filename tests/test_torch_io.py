"""The port's Matrix Market IO (``spectra_tpu_torch/io.py``) against the
JAX package's (``spectra_tpu/io.py``): the 4 cases of
``tests/test_io.py``, in ``tmp_path``. Both read the same files; the
port's CSR is bitwise the JAX package's native read, and within 1e-14
of ``scipy.io.mmread``. The JAX test's fallback case becomes a check
against scipy's reader and the JAX package's numpy fallback: the port
has no fallback (a failed build raises, ``tests/test_torch_native.py``).
"""

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sps
import torch

from spectra_tpu import io as jio
from spectra_tpu import native as jnative
from spectra_tpu_torch import io as pio


def _roundtrip(tmp_path, mat, name):
    path = str(tmp_path / name)
    scipy.io.mmwrite(path[:-4], mat)  # mmwrite appends .mtx
    return path


def _maxdiff(a, b):
    d = abs(a.tocsr() - b.tocsr())
    return d.max() if d.nnz else 0.0


def _bitwise(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)):
        np.testing.assert_array_equal(x, y)


def test_load_matrix_market_matches_scipy(tmp_path):
    A = sps.random(60, 50, density=0.08, random_state=1, format="coo", dtype=np.float64)
    path = _roundtrip(tmp_path, A, "gen.mtx")
    got = pio.load_matrix_market(path).tocsr()
    want = scipy.io.mmread(path).tocsr()
    assert got.shape == want.shape
    assert _maxdiff(got, want) < 1e-14
    _bitwise(got, jio.load_matrix_market(path))


def test_load_matrix_market_symmetric(tmp_path):
    A = sps.random(40, 40, density=0.1, random_state=2, format="coo")
    A = (A + A.T) * 0.5
    path = _roundtrip(tmp_path, A.tocoo(), "sym.mtx")
    got = pio.load_matrix_market(path).tocsr()
    assert _maxdiff(got, scipy.io.mmread(path)) < 1e-14
    _bitwise(got, jio.load_matrix_market(path))
    with open(path) as fh:
        assert "symmetric" in fh.readline()


def test_native_and_scipy_agree(tmp_path, monkeypatch):
    """The port's native read agrees with ``scipy.io.mmread`` and with the
    JAX package's scipy fallback; a complex file goes to scipy by
    format."""
    A = sps.random(30, 30, density=0.15, random_state=3, format="coo")
    path = _roundtrip(tmp_path, A, "both.mtx")
    got = pio.load_matrix_market(path).tocsr()
    assert _maxdiff(got, scipy.io.mmread(path)) < 1e-14
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_build_failed", True)
    assert _maxdiff(got, jio.load_matrix_market(path)) < 1e-14
    Z = (A + 1j * A).tocoo()
    zpath = _roundtrip(tmp_path, Z, "cplx.mtx")
    zgot = pio.load_matrix_market(zpath)
    assert zgot.dtype == np.complex128
    assert _maxdiff(zgot, scipy.io.mmread(zpath)) < 1e-14


def test_load_operator_kinds(tmp_path):
    A = sps.random(25, 25, density=0.2, random_state=4, format="coo")
    A = A + A.T
    path = _roundtrip(tmp_path, A.tocoo(), "op.mtx")
    x = np.random.default_rng(5).standard_normal(25)
    want = A.tocsr() @ x
    for kind in ("sym", "gen"):
        op = pio.load_operator(path, kind=kind, device="cpu")
        assert op.device.type == "cpu"
        got = op.perform_op(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12)
        jgot = np.asarray(jio.load_operator(path, kind=kind).perform_op(np.asarray(x)))
        np.testing.assert_allclose(got, jgot, atol=1e-12)
    herm = pio.load_operator(path, kind="herm", device="cpu")
    np.testing.assert_allclose(
        herm.perform_op(torch.from_numpy(x.astype(complex))).numpy(), want, atol=1e-12)
    with pytest.raises(ValueError):
        pio.load_operator(path, kind="nope")
