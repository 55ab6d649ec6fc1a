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
from spectra_tpu_torch.ops import tsqr
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


def _stencil9_offsets(g):
    """The 9 offsets of a 2-D 9-point stencil on a g^2 grid (the 2-D
    Galerkin multigrid levels of config #3)."""
    return tuple(sorted(a * g + b for a in (-1, 0, 1) for b in (-1, 0, 1)))


# (label, n_rows, n_cols, offsets) for K1 and P3: each unrolled d (5, 7,
# 9, 27) and the generic path (1, 3, 64); n odd and even, n = 1; the
# shapes of config #3's coarse levels (d = 9 at 500^2 to 63^2) and the
# north star's (d = 27 at 31^3 and 16^3); non-square. On a 132-SM card
# the vectors reach every launch that ``launch_config`` picks: staged
# with 32 threads (n <= 16,832), 64 (31^3), 128 (250^2) and 256
# (2^17 - 1), in registers with 256 (2^17 + 1, 500^2); the matmats on
# ``K1_BLOCK_COLUMNS`` reach every block size of the block kernel, tiles
# bounded by each of the plan's three limits, every pack width (16, 8
# and 4 bytes in f32; 16 and 8 in f64) and more than one trip a thread
# over a tile (3 columns at 250^2 in f64).
K1_CASES = [
    ("n1_d1", 1, 1, (0,)),
    ("n2_d5", 2, 2, (-2, -1, 0, 1, 2)),
    ("n4097_d5", 4097, 4097, (-64, -1, 0, 1, 64)),
    ("g17_d7", 17**3, 17**3, (-289, -17, -1, 0, 1, 17, 289)),
    ("g50_d9", 2500, 2500, _stencil9_offsets(50)),
    ("g63_d9", 63**2, 63**2, _stencil9_offsets(63)),
    ("g125_d9", 125**2, 125**2, _stencil9_offsets(125)),
    ("g250_d9", 250**2, 250**2, _stencil9_offsets(250)),
    ("g500_d9", 500**2, 500**2, _stencil9_offsets(500)),
    ("g16_d27", 16**3, 16**3, _stencil_offsets(16)),
    ("g15_d27", 15**3, 15**3, _stencil_offsets(15)),
    ("g31_d27", 31**3, 31**3, _stencil_offsets(31)),
    ("n1001_d3", 1001, 1001, (-1, 0, 1)),
    ("n5003_d64", 5003, 5003, tuple(range(-320, 320, 10))),
    ("staged_top_d5", dmod.STAGED_ROWS_MAX - 1, dmod.STAGED_ROWS_MAX - 1,
     (-1000, -1, 0, 1, 1000)),
    ("registers_d7", dmod.STAGED_ROWS_MAX + 1, dmod.STAGED_ROWS_MAX + 1,
     (-16384, -128, -1, 0, 1, 128, 16384)),
    ("rect_40x55", 40, 55, (-7, -1, 0, 2, 9)),
    ("rect_55x40", 55, 40, (-7, -1, 0, 2, 9)),
]
#: Columns of the matmats of ``K1_CASES``.
K1_BLOCK_COLUMNS = (2, 3, 10, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "label, n_rows, n_cols, offsets", K1_CASES, ids=[c[0] for c in K1_CASES]
)
def test_k1_and_p3_bitwise_on_card(cuda, dtype, label, n_rows, n_cols, offsets):
    """K1 bitwise against its plain version with random data in every
    position (the out-of-range ones included), at the launch the wrapper
    picks, and its matmat on 2, 3, 10 and 20 columns; P3 on K1's body
    bitwise against its plain version (square f32 cases)."""
    rng = np.random.default_rng(n_rows * len(offsets))
    data = torch.from_numpy(rng.standard_normal((len(offsets), n_rows))).to(
        dtype=dtype, device="cuda"
    )
    x = torch.randn(n_cols, dtype=dtype, device="cuda")
    before = dmod.LAUNCHES
    y = dmod.dia_spmv(data, offsets, x, n_cols)
    torch.cuda.synchronize()
    assert dmod.LAUNCHES == before + 1
    assert torch.equal(y, dmod.dia_spmv_plain(data, offsets, x, n_cols))
    for ncol in K1_BLOCK_COLUMNS:
        X = torch.randn((n_cols, ncol), dtype=dtype, device="cuda")
        before = dmod.LAUNCHES
        Y = dmod.dia_spmv(data, offsets, X, n_cols)
        torch.cuda.synchronize()
        assert dmod.LAUNCHES == before + 1
        assert torch.equal(Y, dmod.dia_spmv_plain(data, offsets, X, n_cols))
    if dtype == torch.float32 and n_rows == n_cols:
        before = dv.LAUNCHES["dia_noshift"]
        y = dv.dia_noshift(data, offsets, x)
        torch.cuda.synchronize()
        assert dv.LAUNCHES["dia_noshift"] == before + 1
        assert torch.equal(y, dv.dia_noshift_plain(data, x))


@pytest.mark.cuda
def test_k1_cases_reach_every_launch(cuda):
    """The cases above reach every launch the wrapper picks for a vector
    (each block size staged, 256 threads in registers) and, on
    ``K1_BLOCK_COLUMNS``, every block plan: each block size, and tiles
    bounded by each of ``TILE_ROWS_MAX``, ``TILE_ELEMENTS // ncol`` and
    the two tiles an SM, on the 132-SM card they are sized for."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the cases are sized for a 132-SM card (H100 SXM)")
    want = {(t, True) for t in dmod.BLOCK_SIZES} | {(256, False)}
    assert want <= {dmod.card_launch(n, 1, 0) for _, n, _, _ in K1_CASES}
    blocks = [(n, c, dmod.card_launch(n, c, 0)) for _, n, _, _ in K1_CASES
              for c in K1_BLOCK_COLUMNS]
    assert set(dmod.BLOCK_SIZES) <= {threads for _, _, (threads, _) in blocks}
    bounds = lambda n, c: {"rows": dmod.TILE_ROWS_MAX, "fill": -(-n // 264),
                           "elements": max(1, dmod.TILE_ELEMENTS // c)}
    reached = {k for n, c, (_, rows) in blocks for k, v in bounds(n, c).items() if rows == v}
    assert reached == {"rows", "elements", "fill"}


@pytest.mark.cuda
def test_stream_probe_matches_plain_on_card(cuda):
    for n in (1, 7, 4096, (1 << 20) + 3, (1 << 22) + 4 * 1024 + 2):
        x = torch.randn(n, dtype=torch.float32, device="cuda")
        before = stream.LAUNCHES
        y = stream.stream_scale2(x)
        torch.cuda.synchronize()
        assert stream.LAUNCHES == before + 1
        assert torch.equal(y, x * 2)


def _stencil27(g):
    return tuple(sorted(a * g * g + b * g + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


#: P4 beyond the Laplacians, as (n, offsets, rows): n odd, the 27-point
#: planes at a small g with n odd, offsets larger than one CTA's slice,
#: n = 1 and rows = 1.
ROLL2D_CASES = [
    (9001, (-700, -129, -128, -1, 0, 3, 128, 300), 32),
    (7**3, _stencil27(7), 8),
    (50001, (-20000, -1, 0, 1, 20000), 8),
    (1, (0,), 32),
    (50001, (-20000, -1, 0, 1, 20000), 1),
]


@pytest.mark.cuda
def test_dia_probes_match_plain_on_card(cuda):
    """The two probe kernels of ``csrc/dia_variants.cu`` against their
    plain versions (bitwise: every step a separately rounded f32
    operation), ``dia_roll2d`` also against K1's plain version, at every
    ``rows`` the chip run times and at the cases of ``ROLL2D_CASES``,
    one launch a call; ``dia_spmv_f32`` is K1's f32 kernel."""
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
    for n, offsets, rows in ROLL2D_CASES:
        data = torch.randn((len(offsets), n), dtype=torch.float32, device="cuda")
        x = torch.randn(n, dtype=torch.float32, device="cuda")
        before = dv.LAUNCHES["dia_roll2d"]
        y = dv.dia_roll2d(data, offsets, x, rows=rows)
        torch.cuda.synchronize()
        assert dv.LAUNCHES["dia_roll2d"] == before + 1
        assert torch.equal(y, dv.dia_roll2d_plain(data, offsets, x, rows))
        assert torch.equal(y, dmod.dia_spmv_plain(data, offsets, x, n))


@pytest.mark.cuda
def test_dia_probes_raise_for_what_they_do_not_take(cuda):
    data = torch.ones((5, 4096), dtype=torch.float64, device="cuda")
    offs = (-1000, -1, 0, 1, 1000)
    with pytest.raises(TypeError):
        dv.dia_roll2d(data, offs, torch.ones(4096, dtype=torch.float64, device="cuda"))
    # A window whose share exceeds 227 KB a CTA even in clusters of 16.
    far = (-600_000, 0, 600_000)
    with pytest.raises(ValueError):
        dv.dia_roll2d(torch.ones((3, 4096), device="cuda"), far,
                      torch.ones(4096, device="cuda"), rows=256)


def _bk_matrix(n, complex_):
    rng = np.random.default_rng(n)
    A = rng.uniform(size=(n, n)) - 0.5
    if complex_:
        A = A + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A + A.conj().T


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n", [1, 2, 37, 300])
def test_bkldlt_on_card_matches_cpu(cuda, n, complex_):
    """BKLDLT ``factorize``/``solve`` on the card against the same calls
    on the CPU: the same pivots, factors and solves within 1e-12."""
    from spectra_tpu_torch.linalg import bkldlt

    A = torch.from_numpy(_bk_matrix(n, complex_))
    b = torch.from_numpy(np.random.default_rng(n + 1).normal(size=(n, 3))).to(A.dtype)
    cpu = bkldlt.factorize(A, 0.3)
    card = bkldlt.factorize(A.cuda(), 0.3)
    assert card.ok == cpu.ok
    assert torch.equal(card.perm.cpu(), cpu.perm)
    assert torch.equal(card.is2x2.cpu(), cpu.is2x2)
    for name in ("L", "d", "e"):
        want = getattr(cpu, name)
        got = getattr(card, name).cpu()
        assert (got - want).abs().max() <= 1e-12 * max(want.abs().max(), 1.0)
    x_cpu = bkldlt.solve(cpu, b)
    x_card = bkldlt.solve(card, b.cuda()).cpu()
    assert (x_card - x_cpu).abs().max() <= 1e-12 * x_cpu.abs().max()


@pytest.mark.cuda
def test_generalized_shift_invert_on_card(cuda):
    """One generalized mode end to end on the card: the ShiftInvert mode
    on config #5a's pair at g=32 with the multigrid inner solve, against
    the analytic eigenvalues; K1 runs B's SpMV and every level."""
    import spectra_tpu_torch as stt

    g = 32
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    A = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    m1 = sps.diags([1.0 / 6, 2.0 / 3, 1.0 / 6], [-1, 0, 1], shape=(g, g))
    B = sps.kron(sps.eye(g), m1).tocsr()
    before = dmod.LAUNCHES
    op = stt.SymShiftInvert.create(A, B, method="mg").set_shift(0.0)
    bop = stt.SparseSymMatProd.from_full(B)
    e = stt.SymGEigsShiftSolver.from_factored(op, bop, 6, 20, 0.0)
    e.init()
    assert e.compute(stt.SortRule.LargestMagn, tol=1e-10) == 6
    torch.cuda.synchronize()
    assert e.info() == stt.CompInfo.Successful and dmod.LAUNCHES > before
    theta = np.arange(1, g + 1) * np.pi / (g + 1)
    lam, mu = 2 - 2 * np.cos(theta), (2 + np.cos(theta)) / 3
    want = np.sort(((lam[:, None] + lam[None, :]) / mu[None, :]).ravel())[:6]
    np.testing.assert_allclose(np.sort(e.eigenvalues()), want, rtol=1e-10, atol=0)
    U = e.eigenvectors().cpu().numpy()
    assert np.abs(A @ U - (B @ U) * e.eigenvalues()).max() < 1e-9


def _gen_pair(n, complex_, dense_driver, monkeypatch):
    """``GenEigsSolver`` on the same dense general matrix on the card and
    on the CPU (the IRAM: ``SPECTRA_TPU_DENSE_DRIVER=torch``)."""
    import spectra_tpu_torch as stt

    monkeypatch.setenv("SPECTRA_TPU_DENSE_DRIVER", dense_driver)
    rng = np.random.RandomState(123)
    A = rng.uniform(size=(n, n)) - 0.5
    if complex_:
        A = A + 1j * (rng.uniform(size=(n, n)) - 0.5)
    out = []
    for device in ("cuda", "cpu"):
        e = stt.GenEigsSolver(stt.DenseGenMatProd.create(A, device=device), nev=6, ncv=20)
        e.init()
        e.compute(stt.SortRule.LargestMagn)
        out.append(e)
    return A, out


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_gen_eigs_on_card_matches_cpu(cuda, monkeypatch, complex_):
    """The IRAM on the card against the same call on the CPU: nconv,
    info and the values (1e-10); V and the eigenvectors stay on the
    card, H on the host."""
    A, (card, cpu) = _gen_pair(200, complex_, "torch", monkeypatch)
    assert card.info() == cpu.info() and card.info().name == "Successful"
    np.testing.assert_allclose(card.eigenvalues(), cpu.eigenvalues(), rtol=0, atol=1e-10)
    U = card.eigenvectors()
    assert U.device.type == "cuda" and U.is_complex()
    U = U.cpu().numpy()
    assert np.abs(A @ U - U * card.eigenvalues()[None, :]).max() < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_dense_lu_shift_solve_on_card_matches_cpu(cuda, complex_):
    """The dense LU shift-solves factor and solve on the card, against the
    CPU within 1e-12 relative."""
    import spectra_tpu_torch as stt

    A = np.random.default_rng(4).uniform(size=(300, 300)) - 0.5
    b = torch.from_numpy(np.random.default_rng(5).normal(size=300))
    cls = stt.DenseGenComplexShiftSolve if complex_ else stt.DenseGenRealShiftSolve
    shift = (0.4, 0.7) if complex_ else (0.4,)
    card = cls.create(A, device="cuda").set_shift(*shift)
    cpu = cls.create(A, device="cpu").set_shift(*shift)
    assert card.lu.device.type == "cuda"
    y_card = card.perform_op(b.cuda())
    assert y_card.device.type == "cuda" and y_card.dtype == torch.float64
    y_cpu = cpu.perform_op(b)
    assert (y_card.cpu() - y_cpu).abs().max() <= 1e-12 * y_cpu.abs().max()


@pytest.mark.cuda
def test_bicgstab_on_dia_operator_on_card(cuda):
    """BiCGStab on config #4's operator at g=64 shifted by 0: the shifted
    matrix is a DiaMatrix on the card, every SpMV one K1 launch, the
    residual within the coupled 1e-12 relative, and the solve agrees
    with the CPU's within 1e-8 relative."""
    import spectra_tpu_torch as stt

    g = 64
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
    A = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))
         + 0.3 * sps.kron(sps.eye(g), upw1)).tocsr()
    b = torch.from_numpy(np.random.default_rng(6).normal(size=g * g))
    card = stt.SparseGenRealShiftSolve.create(A, method="bicgstab").set_shift(0.0)
    cpu = stt.SparseGenRealShiftSolve.create(A, method="bicgstab", device="cpu").set_shift(0.0)
    assert isinstance(card.shifted, pf.DiaMatrix) and card.shifted.device.type == "cuda"
    before = dmod.LAUNCHES
    y = card.perform_op(b.cuda())
    torch.cuda.synchronize()
    assert dmod.LAUNCHES - before >= 3
    y_cpu = cpu.perform_op(b)
    assert torch.isfinite(y).all()
    # both solves stop at a relative residual of 1e-12; the system's
    # condition number (about 2e3) bounds how far apart they may be
    assert (y.cpu() - y_cpu).abs().max() <= 1e-8 * y_cpu.abs().max()
    r = A @ y.cpu().numpy() - b.numpy()
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b.numpy())


def _rand_herm(n, seed=123):
    rng = np.random.RandomState(seed)
    A = (rng.uniform(size=(n, n)) - 0.5) + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A + A.conj().T


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["LargestAlge", "SmallestMagn"])
def test_complex_lanczos_on_card_matches_cpu(cuda, rule):
    """The complex IRLM (``HermEigsSolver``) on the card against the same
    call on the CPU: nconv, info and the values (1e-10); the complex
    eigenvectors stay on the card, H is real on the host."""
    import spectra_tpu_torch as stt

    A = _rand_herm(200)
    out = []
    for device in ("cuda", "cpu"):
        e = stt.HermEigsSolver(stt.DenseHermMatProd.create(A, device=device), 6, 20)
        e.init()
        e.compute(getattr(stt.SortRule, rule))
        out.append(e)
    card, cpu = out
    assert card.info() == cpu.info() and card.info().name == "Successful"
    np.testing.assert_allclose(card.eigenvalues(), cpu.eigenvalues(), rtol=0, atol=1e-10)
    assert card._result.V.device.type == "cuda" and card._result.V.is_complex()
    U = card.eigenvectors()
    assert U.device.type == "cuda" and U.is_complex()
    U = U.cpu().numpy()
    assert np.abs(A @ U - U * card.eigenvalues()[None, :]).max() < 1e-9


@pytest.mark.cuda
def test_j_structured_embedding_on_card(cuda):
    """The J-structured real embedding on the card: the top values of A,
    and unit complex eigenvectors recovered on the card."""
    import spectra_tpu_torch as stt

    A = _rand_herm(120, seed=21)
    op = stt.RealEmbeddedHermMatProd.create(A, device="cuda")
    e = stt.SymEigsSolver(op, nev=4, ncv=16)
    e.init()
    assert e.compute(stt.SortRule.LargestAlge) == 4
    np.testing.assert_allclose(np.sort(e.eigenvalues()), np.linalg.eigvalsh(A)[-4:],
                               atol=1e-9)
    Z = op.recover_eigenvectors(e.eigenvectors())
    assert Z.device.type == "cuda" and Z.is_complex()
    Z = Z.cpu().numpy()
    assert np.abs(A @ Z - Z * e.eigenvalues()[None, :]).max() < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["davidson", "subclass"])
def test_davidson_on_dia_operator_on_card(cuda, monkeypatch, solver):
    """Config #5b's matrix at n = 5,000 on the card, by Davidson and by
    a JD subclass with only ``calculate_correction_vector``: 10/10, the
    CPU's iteration count, values within 1e-9 ||A||, one K1 launch per
    operator call, the blocks of 20 and then 10 columns, and every QR
    the loop issues (two an iteration that extends the space) the TSQR
    kernel's, none the library's."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.linalg import orthogonalization as porth
    from spectra_tpu_torch.solvers import _jd_core as jd_core

    class DprOnly(stt.JDSymEigsBase):
        def __init__(self, op, nev):
            super().__init__(op, nev)
            self._diagonal = op.diagonal()

        setup_initial_search_space = stt.DavidsonSymEigsSolver.setup_initial_search_space

        def calculate_correction_vector(self):
            pairs = self._ritz_pairs
            return pairs.residues / (pairs.values - self._diagonal[:, None])

    n = 5000
    d = np.linspace(1.0, 100.0, n) ** 2
    A = sps.diags([np.full(n, 0.25), np.full(n, 0.5), d, np.full(n, 0.5),
                   np.full(n, 0.25)], [-1000, -1, 0, 1, 1000], shape=(n, n), format="csr")
    issued = [0]  # QRs the loop asks for
    qr = porth.qr_orthogonalisation

    def counted(*args, **kwargs):
        issued[0] += 1
        return qr(*args, **kwargs)

    monkeypatch.setattr(jd_core, "qr_orthogonalisation", counted)
    out = []
    for device in ("cuda", "cpu"):
        op = stt.SparseSymMatProd.from_full(A, device=device)
        before = dmod.LAUNCHES
        qrs, library, issued[0] = tsqr.LAUNCHES, porth.LIBRARY_QRS, 0
        e = (stt.DavidsonSymEigsSolver if solver == "davidson" else DprOnly)(op, nev=10)
        nconv = e.compute(stt.SortRule.LargestAlge, maxit=150, tol=1e-9 * d.max())
        torch.cuda.synchronize()
        out.append((e, nconv, dmod.LAUNCHES - before, tsqr.LAUNCHES - qrs,
                    porth.LIBRARY_QRS - library, issued[0]))
    (card, n_card, launches, kernel_qrs, library_qrs, issued), (cpu, n_cpu, *_) = out
    assert n_card == n_cpu == 10 and card.info() == stt.CompInfo.Successful
    assert card.num_iterations() == cpu.num_iterations()
    assert card.num_operations() == cpu.num_operations()
    np.testing.assert_allclose(card.eigenvalues(), cpu.eigenvalues(), atol=1e-9 * d.max())
    assert card.eigenvectors().device.type == "cuda"
    assert launches == 1 + (card.num_operations() - 20) // 10
    # every QR of the correction blocks is the kernel's, two an extension
    assert kernel_qrs == issued == 2 * (card.num_iterations() - 1)
    assert library_qrs == 0


@pytest.mark.cuda
def test_lobpcg_and_partial_svd_on_card(cuda):
    """LOBPCG on a DIA Laplacian (K1 on its blocks) and the partial SVD
    of a dense matrix on the card, against the CPU."""
    import spectra_tpu_torch as stt

    g = 20
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    L = (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()
    X0 = np.random.default_rng(0).normal(size=(g * g, 4))
    before = dmod.LAUNCHES
    card = stt.LOBPCGSolver(L, X0, device="cuda")
    assert card.compute(maxit=300, tol_div_n=1e-10) == 4
    torch.cuda.synchronize()
    assert dmod.LAUNCHES > before and card.eigenvectors().device.type == "cuda"
    np.testing.assert_allclose(np.sort(card.eigenvalues()),
                               np.sort(np.linalg.eigvalsh(L.toarray()))[:4], atol=1e-8)
    M = np.random.default_rng(1).normal(size=(300, 200))
    p = stt.PartialSVDSolver(M, ncomp=4, ncv=12, device="cuda")
    assert p.compute() == 4
    np.testing.assert_allclose(p.singular_values(), np.linalg.svd(M, compute_uv=False)[:4],
                               atol=1e-8)
    assert p.matrix_U(4).device.type == "cuda"


def count_entries(monkeypatch, mod):
    """The launches of ``mod`` (``ops.dia_spmv`` or ``ops.dia_ds``) by
    entry from now on: every launch looks its kernel up once through
    ``mod._kernel``, whose arguments name the entry."""
    counts, lookup = {}, mod._kernel

    def counted(*key):
        if mod is dmod:
            name = dmod._SUFFIX[key[0]] + ("_block" if key[1] else "")
        else:
            name = key[0].rsplit("_", 1)[1]
        counts[name] = counts.get(name, 0) + 1
        return lookup(*key)

    monkeypatch.setattr(mod, "_kernel", counted)
    return counts


@pytest.mark.cuda
def test_mixed_precision_on_card(cuda, monkeypatch):
    """``set_precision("mixed")`` on a small DIA matrix on the card: the
    twin's SpMVs are K1's f32 vector launches, one a twin operation; each
    refinement round is two f64 block launches; the values match the
    double run's and the CPU mixed run's."""
    import spectra_tpu_torch as stt

    n, k = 20000, 4
    d = np.linspace(1.0, 100.0, n)
    d[-k:] = 100.0 * 1.05 ** np.arange(1, k + 1)
    A = sps.diags(
        [0.25 * np.ones(n - 100), 0.5 * np.ones(n - 1), d, 0.5 * np.ones(n - 1),
         0.25 * np.ones(n - 100)], [-100, -1, 0, 1, 100],
    ).tocsr()

    def run(device, precision, tol):
        s = stt.SymEigsSolver(stt.SparseSymMatProd.from_full(A, device=device), k, 20)
        s.set_precision(precision)
        s.init()
        dmod.LAUNCHES = 0
        entries = count_entries(monkeypatch, dmod)
        nconv = s.compute(stt.SortRule.LargestAlge, maxit=500, tol=tol)
        torch.cuda.synchronize()
        monkeypatch.undo()
        return s, nconv, entries

    s, nconv, launches = run("cuda", "mixed", 1e-6)
    assert nconv == k and s.info() == stt.CompInfo.Successful
    twin_ops = s.num_operations() - 3 * nconv
    assert launches.get("f32") == twin_ops
    assert launches.get("f64_block", 0) % 2 == 0 and launches["f64_block"] >= 2
    assert set(launches) == {"f32", "f64_block"}
    ref, _, _ = run("cuda", "double", 1e-10)
    cpu, _, _ = run("cpu", "mixed", 1e-6)
    scale = np.abs(ref.eigenvalues()).max()
    np.testing.assert_allclose(s.eigenvalues(), ref.eigenvalues(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(s.eigenvalues(), cpu.eigenvalues(), rtol=0, atol=1e-9 * scale)
    assert np.all(s.mixed_report()["resid_f64"] <= 1e-6 * scale)
    assert s.eigenvectors().device.type == "cuda"


@pytest.fixture
def nccl_one_rank(cuda):
    """A one-rank NCCL row mesh (``row_mesh()`` starts the process group
    itself), the group destroyed at teardown so no later test inherits
    it."""
    import torch.distributed as dist

    from spectra_tpu_torch.parallel import row_mesh

    assert not dist.is_initialized()
    yield row_mesh()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_products_one_rank_nccl(nccl_one_rank, monkeypatch):
    """The multi-device layer on one rank over NCCL: each sharded
    operator's product (vector and block) equals the unsharded product
    on the card bitwise (the same kernel, with zero halos), and the hi/lo
    class launches K2's ``_ext`` entry once a vector."""
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.parallel import (
        ShardedEllMatProd,
        ShardedStencilMatProd,
        shard_problem,
        sharded_stencil_op,
    )
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia

    mesh = nccl_one_rank
    assert mesh.backend == "nccl" and mesh.size == 1 and not mesh.staged
    g = 40
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    eye = sps.eye(g)
    A = (
        sps.kron(sps.kron(lap1, eye), eye) + sps.kron(sps.kron(eye, lap1), eye)
        + sps.kron(sps.kron(eye, eye), lap1)
    ).tocsr()
    n = A.shape[0]
    x = torch.randn(n, dtype=torch.float64, device="cuda")
    X = torch.randn((n, 5), dtype=torch.float64, device="cuda")
    dia = pf.dia_from_scipy(A, device="cuda")
    hilo = pf.DiaHiLoMatrix.from_dia(dia)
    stencil = ShardedStencilMatProd.create(host_dia(A), mesh)
    assert torch.equal(stencil.perform_op(x), dia.matvec(x))
    assert torch.equal(stencil.perform_op(X), dia.matmat(X))
    op = sharded_stencil_op(host_dia(A), mesh, hilo=True)
    entries = count_entries(monkeypatch, dsmod)
    y = op.perform_op(x)
    torch.cuda.synchronize()
    assert entries == {"ext": 1}
    assert torch.equal(y, hilo.matvec(x))
    assert torch.equal(op.perform_op(X), hilo.matmat(X))
    ell = ShardedEllMatProd.create(A, mesh)
    ref = pf.ell_from_scipy(A, device="cuda")
    torch.testing.assert_close(ell.perform_op(x), ref.matvec(x), rtol=1e-13, atol=0)
    # GSPMD's lowering: the gather, then K1 on the rows (d=7, n=64,000:
    # under the hi/lo threshold, so f64 DIA)
    row_op, xs = shard_problem(stt.SparseSymMatProd.from_full(A, device="cuda"), x, mesh)
    assert torch.equal(row_op.perform_op(xs), dia.matvec(x))


def _tsqr_checks(A, Q, R):
    """``(max |Q^T Q - I|, ||A - QR||_F / ||A||_F)``, with R upper
    triangular and its diagonal non-negative asserted."""
    assert torch.equal(R, torch.triu(R))
    assert bool((torch.diagonal(R) >= 0).all())
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return (float((Q.mT @ Q - eye).abs().max()),
            float(torch.linalg.norm(A - Q @ R) / torch.linalg.norm(A)))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n, c, dtype",
    [
        (10**6, 10, torch.float64),
        (10**6, 20, torch.float64),
        (999_983, 7, torch.float64),  # a ragged last panel
        (5000, 1, torch.float64),
        (100_000, tsqr.MAX_COLS, torch.float64),
        (5000, 10, torch.float32),
        (20_000, 17, torch.float32),  # the 32-column bucket in f32
    ],
)
def test_tsqr_matches_library_on_card(cuda, n, c, dtype):
    """The TSQR kernel on Gaussian blocks against ``torch.linalg.qr`` with
    the sign fix (:func:`tsqr_plain`): orthonormal Q, A = QR, R upper
    triangular with a non-negative diagonal, Q within 1e-12 of the
    library's (f64); in f32 every limit is 1e-5."""
    g = torch.Generator(device="cuda").manual_seed(n + c)
    A = torch.randn((n, c), dtype=dtype, device="cuda", generator=g)
    assert tsqr.routes_to_kernel(A.device.type, A.dtype, A.shape)
    before = tsqr.LAUNCHES
    Q, R = tsqr.tsqr(A)
    torch.cuda.synchronize()
    assert tsqr.LAUNCHES == before + 1
    assert Q.shape == A.shape and Q.is_contiguous() and R.shape == (c, c)
    orth, resid = _tsqr_checks(A, Q, R)
    Ql, _ = tsqr.tsqr_plain(A)
    near = float((Q - Ql).abs().max())
    f64 = dtype == torch.float64
    assert orth <= (1e-13 if f64 else 1e-5)
    assert resid <= (1e-14 if f64 else 1e-5)
    assert near <= (1e-12 if f64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cond_1e12", "zero_column"])
def test_tsqr_ill_conditioned_blocks_on_card(cuda, kind):
    """A block of condition number 1e12 and one with a zero column: Q
    orthonormal and A = QR (Q itself is not determined to compare)."""
    n, c = 200_000, 10
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn((n, c), dtype=torch.float64, device="cuda", generator=g)
    if kind == "cond_1e12":
        U, _ = torch.linalg.qr(A)
        V, _ = torch.linalg.qr(torch.randn((c, c), dtype=torch.float64, device="cuda", generator=g))
        s = torch.logspace(0, -12, c, dtype=torch.float64, device="cuda")
        A = ((U * s[None, :]) @ V.mT).contiguous()
    else:
        A[:, 4] = 0
    Q, R = tsqr.tsqr(A)
    orth, resid = _tsqr_checks(A, Q, R)
    assert orth <= 1e-13 and resid <= 1e-14
