"""Tests of the PyTorch port that need an NVIDIA GPU; they skip without
one. This file imports neither jax nor the JAX package, so it also runs
where those are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu_torch.ops import dia_ds as dsmod
from spectra_tpu_torch.ops import dia_spmv as dmod
from spectra_tpu_torch.ops import dia_variants as dv
from spectra_tpu_torch.ops import stream
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


@pytest.mark.cuda
def test_ds_kernel_matches_plain_on_card(cuda):
    """K2 against its plain version, both entry points, a 40-diagonal
    band and the hi/lo matrix's matmat; every step is a separately
    rounded f32 operation in both, so they agree bitwise."""
    g = 40
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    eye = sps.eye(g)
    lap3 = (
        sps.kron(sps.kron(lap1, eye), eye) + sps.kron(sps.kron(eye, lap1), eye)
        + sps.kron(sps.kron(eye, eye), lap1)
    ).tocsr() * np.pi
    rng = np.random.default_rng(12)
    wide = tuple(range(-60, 60, 3))  # 40 diagonals
    band = sps.diags(
        [rng.normal(size=4000) for _ in wide], wide, shape=(4000, 4000)
    ).tocsr()
    for A in (lap3, band):
        dia = pf.dia_from_scipy(A, device="cuda")
        hilo = pf.DiaHiLoMatrix.from_dia(dia)
        n, offs = hilo.n_rows, hilo.offsets
        lo, hi = max(0, -min(offs)), max(0, max(offs))
        for x_len, entry, plain in (
            (n, dsmod.dia_spmv_ds_padded, dsmod.dia_spmv_ds_plain),
            (lo + n + hi, dsmod.dia_spmv_ds_ext, dsmod.dia_spmv_ds_ext_plain),
        ):
            xh, xl = dsmod.split_f64(
                torch.randn(x_len, dtype=torch.float64, device="cuda")
            )
            before = dsmod.LAUNCHES
            yh, yl = entry(hilo.data_hi, hilo.data_lo, xh, xl, offsets=offs, n=n)
            torch.cuda.synchronize()
            assert dsmod.LAUNCHES == before + 1
            ph, pl = plain(hilo.data_hi, hilo.data_lo, xh, xl, offsets=offs, n=n)
            assert torch.equal(yh, ph) and torch.equal(yl, pl)
        X = torch.randn((n, 3), dtype=torch.float64, device="cuda")
        Y = hilo.matmat(X)
        for c in range(3):
            xh, xl = dsmod.split_f64(X[:, c].contiguous())
            ph, pl = dsmod.dia_spmv_ds_plain(
                hilo.data_hi, hilo.data_lo, xh, xl, offsets=offs, n=n
            )
            assert torch.equal(Y[:, c], dsmod.combine_f64(ph, pl))
        ref = dia.matvec(X[:, 0].contiguous())
        assert float((Y[:, 0] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def _stencil_offsets(g):
    """The 27 offsets of a 3-D 27-point stencil on a g^3 grid (what MG
    level 1 of a 7-point operator has)."""
    return tuple(sorted(a * g * g + b * g + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


# (label, n, offsets): odd n and every residue mod 4, d = 1, 7, 27, 64.
DS_CASES = [
    ("n1_d1", 1, (0,)),
    ("n3_d3", 3, (-1, 0, 1)),
    ("n1001_d1", 1001, (0,)),
    ("n1002_d2", 1002, (-5, 9)),
    ("g17_d7", 17**3, (-289, -17, -1, 0, 1, 17, 289)),
    ("g15_d27", 15**3, _stencil_offsets(15)),
    ("n4099_d27", 4099, tuple(range(-39, 42, 3))),
    ("n5003_d64", 5003, tuple(range(-320, 320, 10))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label, n, offsets", DS_CASES, ids=[c[0] for c in DS_CASES])
def test_ds_entries_match_plain_on_card(cuda, label, n, offsets):
    """The f64 entry and both plane entries bitwise against their plain
    versions, on planes padded as ``DiaHiLoMatrix`` pads them (vector
    loads) and on unpadded planes (4-byte loads at odd n); the f64 entry also
    bitwise the three-step route launched on the card, in one launch."""
    rng = np.random.default_rng(len(offsets) * n)
    data = torch.from_numpy(rng.standard_normal((len(offsets), n)) * np.pi)
    dia = pf.DiaMatrix(data=data.cuda(), offsets=offsets, n_rows=n, n_cols=n)
    padded = pf.DiaHiLoMatrix.from_dia(dia)
    assert padded.data_hi.shape[1] % pf.PLANE_ALIGN == 0
    unpadded = dsmod.split_f64(dia.data)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    x = torch.randn(n, dtype=torch.float64, device="cuda")
    x_ext = torch.randn(lo + n + hi, dtype=torch.float64, device="cuda")
    for dh, dl in ((padded.data_hi, padded.data_lo), unpadded):
        kw = dict(offsets=offsets, n=n)
        before = dsmod.LAUNCHES
        y = dsmod.dia_spmv_ds_f64(dh, dl, x, **kw)
        torch.cuda.synchronize()
        assert dsmod.LAUNCHES == before + 1
        assert torch.equal(y, dsmod.dia_spmv_ds_f64_plain(dh, dl, x, **kw))
        three_step = dsmod.combine_f64(
            *dsmod.dia_spmv_ds_padded(dh, dl, *dsmod.split_f64(x), **kw)
        )
        assert torch.equal(y, three_step)
        for entry, plain, v in (
            (dsmod.dia_spmv_ds_padded, dsmod.dia_spmv_ds_plain, x),
            (dsmod.dia_spmv_ds_ext, dsmod.dia_spmv_ds_ext_plain, x_ext),
        ):
            xh, xl = dsmod.split_f64(v)
            yh, yl = entry(dh, dl, xh, xl, **kw)
            ph, pl = plain(dh, dl, xh, xl, **kw)
            assert torch.equal(yh, ph) and torch.equal(yl, pl)
    assert torch.equal(padded.matvec(x), dsmod.dia_spmv_ds_f64_plain(
        padded.data_hi, padded.data_lo, x, offsets=offsets, n=n))


@pytest.mark.cuda
def test_stream_probe_matches_plain_on_card(cuda):
    for n in (1, 7, 4096, (1 << 20) + 3, (1 << 22) + 4 * 1024 + 2):
        x = torch.randn(n, dtype=torch.float32, device="cuda")
        before = stream.LAUNCHES
        y = stream.stream_scale2(x)
        torch.cuda.synchronize()
        assert stream.LAUNCHES == before + 1
        assert torch.equal(y, x * 2)


@pytest.mark.cuda
def test_dia_probes_match_plain_on_card(cuda):
    """The two probe kernels of ``csrc/dia_variants.cu`` against their
    plain versions (bitwise: every step a separately rounded f32
    operation), ``dia_roll2d`` also against K1's plain version, at every
    ``rows`` the chip run times; ``dia_spmv_f32`` is K1's f32 kernel."""
    g = 100
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    lap = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    rng = np.random.default_rng(13)
    wide = (-700, -129, -128, -1, 0, 3, 128, 300)
    band = sps.diags(
        [rng.normal(size=9001) for _ in wide], wide, shape=(9001, 9001)
    ).tocsr()
    for A in (lap, band):
        m = pf.dia_from_scipy(A, dtype=torch.float32, device="cuda")
        x = torch.randn(A.shape[0], dtype=torch.float32, device="cuda")
        ref = dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
        before = dict(dv.LAUNCHES)
        y = dv.dia_noshift(m.data, m.offsets, x)
        assert torch.equal(y, dv.dia_noshift_plain(m.data, x))
        for rows in (32, 64, 128, 256):
            y = dv.dia_roll2d(m.data, m.offsets, x, rows=rows)
            assert torch.equal(y, dv.dia_roll2d_plain(m.data, m.offsets, x, rows))
            assert torch.equal(y, ref)
        k1_before = dmod.LAUNCHES
        assert torch.equal(dv.dia_spmv_f32(m.data, m.offsets, x), ref)
        torch.cuda.synchronize()
        assert dmod.LAUNCHES == k1_before + 1
        assert dv.LAUNCHES["dia_noshift"] == before["dia_noshift"] + 1
        assert dv.LAUNCHES["dia_roll2d"] == before["dia_roll2d"] + 4


@pytest.mark.cuda
def test_dia_probes_raise_for_what_they_do_not_take(cuda):
    data = torch.ones((5, 4096), dtype=torch.float64, device="cuda")
    offs = (-1000, -1, 0, 1, 1000)
    with pytest.raises(TypeError):
        dv.dia_roll2d(data, offs, torch.ones(4096, dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError):
        dv.dia_roll2d(data.float(), offs, torch.ones(4096, device="cuda"), rows=512)
