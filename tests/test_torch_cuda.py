"""Tests of the PyTorch port that need an NVIDIA GPU; they skip without
one. This file imports neither jax nor the JAX package, so it also runs
where those are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu_torch.ops import dia_spmv as dmod
from spectra_tpu_torch.sparse import formats as pf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _cases():
    g = 64
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    lap = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    n = 777
    unaligned = sps.diags(
        [np.ones(n - 3), 2.0 + np.arange(n), -np.ones(n - 1)], [-3, 0, 1]
    ).tocsr()
    rng = np.random.default_rng(11)
    offsets = tuple(range(-8, 9))
    banded = sps.diags(
        [rng.normal(size=5000) for _ in offsets], offsets, shape=(5000, 5000)
    ).tocsr()
    return lap, unaligned, banded


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(cuda, dtype):
    """The CUDA kernel against its plain version; built with
    ``-fmad=false``, the two agree bitwise."""
    for A in _cases():
        pd = pf.dia_from_scipy(A, dtype=dtype, device="cuda")
        x = torch.randn(A.shape[1], dtype=dtype, device="cuda")
        X = torch.randn((A.shape[1], 7), dtype=dtype, device="cuda")
        before = dmod.LAUNCHES
        y, Y = pd.matvec(x), pd.matmat(X)
        torch.cuda.synchronize()
        assert dmod.LAUNCHES == before + 2
        assert torch.equal(
            y, dmod.dia_spmv_plain(pd.data, pd.offsets, x, pd.n_cols)
        )
        assert torch.equal(
            Y, dmod.dia_spmv_plain(pd.data, pd.offsets, X, pd.n_cols)
        )


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    data = torch.ones((3, 10), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0, 1), torch.ones(10, dtype=torch.float64), 10)
