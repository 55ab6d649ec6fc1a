"""The port's DIA cost probes (``ops/dia_variants.py``) against the JAX
package's TPU probes ``scripts/tpu_dia_variants.py`` (``dia_noshift``,
``dia_roll2d``) and ``scripts/tpu_dia_f32_ceiling.py``
(``dia_spmv_f32``).

Those scripts call ``pl.pallas_call`` without ``interpret``; here it is
patched to interpret mode for the calls, so they run on the CPU. The
port runs on the CPU, so its wrappers take their plain versions.
Tolerance: atol 1e-5 in f32, as ``tests/test_torch_dia.py`` states.
``dia_roll2d``'s plain version is also held bitwise equal to K1's plain
version: the same f32 products added in the same order. The CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools
import importlib

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu_torch.ops import dia_spmv as k1
from spectra_tpu_torch.ops import dia_variants as dv
from spectra_tpu_torch.sparse.formats import dia_from_scipy

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def probes():
    """The two TPU probe scripts with ``pallas_call`` in interpret mode
    while the tests of this module run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True)
        )
        yield (
            importlib.import_module("scripts.tpu_dia_variants"),
            importlib.import_module("scripts.tpu_dia_f32_ceiling"),
        )


def _lap2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _f32_dia(A):
    m = dia_from_scipy(A, dtype=torch.float32, device="cpu")
    return m.data, m.offsets


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_noshift_matches_jax_probe(probes):
    variants, _ = probes
    data, offsets = _f32_dia(_lap2d(40))
    x = _x(data.shape[1])
    want = np.asarray(variants.dia_noshift(
        jnp.asarray(data.numpy()), offsets, jnp.asarray(x), chunk=1024
    ))
    got = dv.dia_noshift(data, offsets, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Wrong on purpose: every diagonal multiplies x[i] itself.
    np.testing.assert_allclose(got, data.sum(0).numpy() * x, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("g, rows", [(40, 8), (200, 8), (200, 16)])
def test_roll2d_matches_jax_probe(probes, g, rows):
    """g=200 has offsets of +-200, beyond one row of 128: the operand
    then comes from two rows of the window."""
    variants, _ = probes
    A = _lap2d(g)
    data, offsets = _f32_dia(A)
    x = _x(data.shape[1], seed=g)
    want = np.asarray(variants.dia_roll2d(
        jnp.asarray(data.numpy()), offsets, jnp.asarray(x), rows=rows
    ))
    got = dv.dia_roll2d(data, offsets, torch.from_numpy(x), rows=rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, A @ x.astype(np.float64), rtol=0, atol=ATOL)


@pytest.mark.parametrize("offsets, n", [
    ((-1000, -1, 0, 1, 1000), 10**5),
    ((-300, -129, -128, -3, 0, 5, 127, 128, 260), 5000),
    ((0,), 300),
])
def test_roll2d_plain_bitwise_equals_k1_plain(offsets, n):
    rng = np.random.default_rng(len(offsets))
    data = torch.from_numpy(
        (rng.standard_normal((len(offsets), n)) * np.pi).astype(np.float32)
    )
    x = torch.from_numpy(_x(n, seed=n))
    for rows in (8, 32):
        got = dv.dia_roll2d(data, offsets, x, rows=rows)
        assert torch.equal(got, k1.dia_spmv_plain(data, offsets, x, n))


def test_spmv_f32_matches_jax_probe(probes):
    _, ceiling = probes
    from scripts.tpu_dia_ds_probe import lap3d_dia_planes

    g = 8
    data64, offsets = lap3d_dia_planes(g)
    data = data64.astype(np.float32)
    x = _x(g**3)
    want = np.asarray(ceiling.dia_spmv_f32(
        jnp.asarray(data), jnp.asarray(x), offsets=offsets, n=g**3, chunk=1024
    ))
    got = dv.dia_spmv_f32(torch.from_numpy(data), offsets, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # The probe is K1 in f32: the port's own DIA layout of the 3-D
    # Laplacian is the same planes.
    pdata, poffs = _f32_dia(_lap3d(g))
    assert poffs == offsets
    assert torch.equal(pdata, torch.from_numpy(data))
    assert torch.equal(got, dv.dia_spmv_f32_plain(pdata, poffs, torch.from_numpy(x)))


def _lap3d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    e = sps.eye(g)
    return (
        sps.kron(sps.kron(lap1, e), e) + sps.kron(sps.kron(e, lap1), e)
        + sps.kron(sps.kron(e, e), lap1)
    ).tocsr()


def test_window_rule_and_input_checks():
    offsets = (-1000, -1, 0, 1, 1000)
    assert dv.pad_rows_for(offsets) == 12
    assert dv.window_bytes(offsets, 256) == 143_360
    assert dv.window_bytes(offsets, 512) > dv.MAX_SHARED_BYTES
    data = torch.ones((5, 64), dtype=torch.float64)
    with pytest.raises(TypeError):
        dv.dia_roll2d(data, offsets, torch.ones(64, dtype=torch.float64))
    with pytest.raises(ValueError):
        dv.dia_noshift(data.float(), offsets[:3], torch.ones(64))
    with pytest.raises(ValueError):
        dv.dia_roll2d(data.float(), offsets, torch.ones(64), rows=0)
