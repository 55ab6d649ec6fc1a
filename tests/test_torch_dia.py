"""The port's DIA/ELL formats and DIA SpMV against the JAX package.

The port runs on the CPU, so ``dia_spmv`` takes its plain version; the
JAX kernel runs as ``tests/test_pallas_ops.py`` runs it
(``interpret=True``). Tolerances: atol 1e-5 in f32 and 1e-12 in f64,
as in ``test_pallas_ops.py``; 1e-12 for the other methods. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spectra_tpu.ops import dia_spmv_pallas
from spectra_tpu.sparse import formats as jf
from spectra_tpu_torch.convert import dia_from_numpy, ell_from_numpy
from spectra_tpu_torch.matop.sparse import SparseSymMatProd
from spectra_tpu_torch.ops import dia_spmv as dmod
from spectra_tpu_torch.sparse import formats as pf

torch.set_num_threads(1)


def _laplacian_2d(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def _unaligned(n=777):
    return sps.diags(
        [np.ones(n - 3), 2.0 + np.arange(n), -np.ones(n - 1)], [-3, 0, 1]
    ).tocsr()


def _banded(n_rows, n_cols, offsets, seed):
    rng = np.random.default_rng(seed)
    diags = [rng.normal(size=n_rows) for _ in offsets]
    return sps.diags(diags, offsets, shape=(n_rows, n_cols)).tocsr()


def _pair(A, dtype=None):
    """The JAX DiaMatrix and the port's, built from the same arrays."""
    jd = jf.dia_from_scipy(A, dtype=dtype)
    pd = dia_from_numpy(
        np.asarray(jd.data), jd.offsets, jd.n_rows, jd.n_cols, device="cpu"
    )
    return jd, pd


def _stencil27_offsets(g):
    """The 27 offsets of a 3-D 27-point stencil on a g^3 grid."""
    return tuple(sorted(a * g * g + b * g + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


# Random data in every position, the out-of-range ones included: (n_rows,
# n_cols, offsets). d=64 keeps its offsets within the Pallas kernel's
# chunk of 1024.
RANDOM_K1_CASES = {
    "stencil27_g7": (7**3, 7**3, _stencil27_offsets(7)),
    "d1": (500, 500, (3,)),
    "d64": (2000, 2000, tuple(range(-480, 480, 15))),
    "rect_40x55": (40, 55, (-7, -1, 0, 2, 9)),
    "rect_55x40": (55, 40, (-7, -1, 0, 2, 9)),
}


def _k1_case(case, dtype):
    """(JAX DiaMatrix, port DiaMatrix, x) of one case."""
    rng = np.random.default_rng(0)
    if case in RANDOM_K1_CASES:
        n_rows, n_cols, offsets = RANDOM_K1_CASES[case]
        data = rng.normal(size=(len(offsets), n_rows)).astype(dtype)
        jd = jf.DiaMatrix(data=jnp.asarray(data), offsets=offsets,
                          n_rows=n_rows, n_cols=n_cols)
        pd = dia_from_numpy(data, offsets, n_rows, n_cols, device="cpu")
    else:
        jd, pd = _pair(_laplacian_2d(24) if case == "lap24" else _unaligned(), dtype)
    return jd, pd, rng.normal(size=pd.n_cols).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["lap24", "n777", *RANDOM_K1_CASES])
def test_dia_spmv_matches_pallas_and_jax(case, dtype):
    """The port's K1 (its plain version on the CPU) against the Pallas
    kernel in interpret mode and ``DiaMatrix.matvec``. Both JAX functions
    zero-pad x; for more rows than columns x gets zero rows up to n_rows
    first (the Pallas kernel reads x over the rows' range, and the JAX
    matvec's dynamic_slice would clamp), which adds only zero terms."""
    jd, pd, x = _k1_case(case, dtype)
    xj = jnp.asarray(np.pad(x, (0, max(0, pd.n_rows - pd.n_cols))))
    want_pallas = np.asarray(
        dia_spmv_pallas(jd.data, jd.offsets, xj, chunk=1024, interpret=True)
    )
    want_jax = np.asarray(jd.matvec(xj))
    xt = torch.from_numpy(x)
    plain = dmod.dia_spmv_plain(pd.data, pd.offsets, xt, pd.n_cols).numpy()
    got = pd.matvec(xt).numpy()
    atol = 1e-5 if dtype == np.float32 else 1e-12
    for y in (plain, got):
        assert y.dtype == dtype and y.shape == (pd.n_rows,)
        np.testing.assert_allclose(y, want_pallas, atol=atol)
        np.testing.assert_allclose(y, want_jax, atol=atol)
    np.testing.assert_array_equal(got, plain)


def _kernel_rows(n_rows, threads, blocks):
    """The rows K1's grid-stride loop computes (``csrc/dia_rows.cuh``):
    thread t of block b takes row (b + s * blocks) * threads + t on trip
    s, while that row is below n_rows."""
    per_trip = np.arange(blocks * threads)
    return np.concatenate([
        start + per_trip[start + per_trip < n_rows]
        for start in range(0, n_rows, blocks * threads)
    ])


#: SMs of an H100 SXM, the card the launch choice was measured on.
SMS = 132


@pytest.mark.parametrize(
    "n", [1, 2, 31, 32, 33, 4096, 4097, 29791, 226981,
          dmod.STAGED_ROWS_MAX - 1, dmod.STAGED_ROWS_MAX, dmod.STAGED_ROWS_MAX + 257,
          16832, 16833, 33664, 33665, 67328, 67329],
)
def test_launch_config_covers_every_row_once(n):
    """K1's launch (``launch_config``) and the kernel's row map cover
    rows 0 .. n-1 exactly once, from n = 1 to past the staging
    threshold, and with the block count capped (grid-stride trips); the
    block is the largest that gives every SM two blocks (32 threads
    where none does), so n on each side of 2 * 132 * t reaches each
    block size t."""
    threads, staged, blocks = dmod.launch_config(n, 1, SMS)
    assert threads in dmod.BLOCK_SIZES and staged == (n < dmod.STAGED_ROWS_MAX)
    assert blocks == min(-(-n // threads), dmod.MAX_BLOCKS)
    fills = [t for t in dmod.BLOCK_SIZES if -(-n // t) >= 2 * SMS]
    assert threads == max(fills, default=dmod.BLOCK_SIZES[0])
    for b in (blocks, max(1, blocks // 7)):
        got = np.sort(_kernel_rows(n, threads, b))
        np.testing.assert_array_equal(got, np.arange(n))


def _pack_width(ncol, itemsize):
    """Elements of the block kernel's pack (``csrc/dia_block.cuh``
    ``pack_width``, for aligned x and y): the widest of 16, 8 or
    ``itemsize`` bytes that divides a row."""
    return next(v for v in (16 // itemsize, 8 // itemsize, 1) if ncol % v == 0)


def _block_walk(n_rows, ncol, plan, width):
    """The block kernel's walk: CTA b takes tiles b, b + blocks, ... of
    ``tile_rows`` rows; its threads take packs t, t + threads, ... of a
    tile, pack p being flat elements ``r0 * ncol + p * width`` on, all
    in row ``r0 + p * width // ncol``. Yields ``(tile, r0, rows, row,
    first element)`` per tile, the last two as arrays over its packs."""
    tiles = -(-n_rows // plan.tile_rows)
    for b in range(plan.blocks):
        for tile in range(b, tiles, plan.blocks):
            r0 = tile * plan.tile_rows
            rows = min(plan.tile_rows, n_rows - r0)
            p = np.arange(rows * (ncol // width))
            yield tile, r0, rows, r0 + p * width // ncol, r0 * ncol + p * width


#: (n_rows, ncol) of the block path: config #5b's shapes, LOBPCG's, and
#: a few more.
BLOCK_SHAPES = [(250_000, 10), (250_000, 20), (10**6, 10), (10**6, 20), (10**4, 10)]


@pytest.mark.parametrize("ncol", [2, 3, 10, 20, 33, 700])
@pytest.mark.parametrize("n", [1, 2, 263, 264, 1001, 2999, 4097])
def test_block_plan_covers_every_element_once(n, ncol):
    """K1's block plan and the kernel's walk cover every (row, column)
    of Y exactly once, in packs that stay in one row, with the plan's
    blocks and with fewer (grid-stride trips over the tiles); every tile
    fits its staged data at 64 f64 diagonals in 48 KB."""
    plan = dmod.launch_config(n, ncol, SMS)
    assert isinstance(plan, dmod.BlockPlan) and plan.threads in dmod.BLOCK_SIZES
    assert 1 <= plan.tile_rows <= dmod.TILE_ROWS_MAX
    assert dmod.MAX_DIAGS * plan.tile_rows * 8 <= 48 * 1024
    assert plan.blocks == min(-(-n // plan.tile_rows), dmod.MAX_BLOCKS)
    for width in {_pack_width(ncol, 8), _pack_width(ncol, 4), 1}:
        for blocks in (plan.blocks, max(1, plan.blocks // 7)):
            seen = np.zeros(n * ncol, dtype=np.int64)
            for _, r0, rows, row, first in _block_walk(n, ncol, plan._replace(blocks=blocks), width):
                assert ((row >= r0) & (row < r0 + rows)).all()
                elems = first[:, None] + np.arange(width)
                assert (elems // ncol == row[:, None]).all()  # one row a pack
                seen[elems.ravel()] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("n, ncol", BLOCK_SHAPES)
def test_block_plan_fills_the_card(n, ncol):
    """At config #5b's and LOBPCG's shapes the block plan gives each of
    the 132 SMs at least two CTAs, each thread one 16-byte f64 pack of
    its tile."""
    plan = dmod.launch_config(n, ncol, SMS)
    assert plan.blocks >= 2 * SMS
    assert plan.tile_rows * ncol <= 2 * plan.threads


def _emulate_block_kernel(data, offsets, X, n_cols, plan):
    """The block kernel in torch along its walk: each tile's data staged
    once (the copies side by side), each pack's row read from its tile's
    copy and its X from flat element e + off * ncol (zero outside
    [0, n_cols * ncol)), the terms added in offset order from +0, all
    packs of all tiles at once."""
    n_rows, ncol = data.shape[1], X.shape[1]
    width = _pack_width(ncol, X.element_size())
    copies, at, firsts, base = [], [], [], 0
    for _, r0, rows, row, first in _block_walk(n_rows, ncol, plan, width):
        copies.append(data[:, r0 : r0 + rows])  # the cp.async copy
        at.append(base + row - r0)
        firsts.append(first)
        base += rows
    staged = torch.cat(copies, dim=1)
    at, e = torch.from_numpy(np.concatenate(at)), torch.from_numpy(np.concatenate(firsts))
    lanes = torch.arange(width)
    x = X.reshape(-1)
    acc = torch.zeros((len(e), width), dtype=X.dtype)
    for k, off in enumerate(offsets):
        src = e + off * ncol
        inside = (src >= 0) & (src < n_cols * ncol)
        xs = x[torch.where(inside, src, 0)[:, None] + lanes]
        xs = torch.where(inside[:, None], xs, torch.zeros((), dtype=X.dtype))
        acc = acc + staged[k, at][:, None] * xs
    y = torch.full((n_rows * ncol,), float("nan"), dtype=X.dtype)
    y[e[:, None] + lanes] = acc
    return y.reshape(n_rows, ncol)


#: (n_rows, n_cols, offsets) for the block emulation: odd n with
#: config #5b's offsets and with offsets beyond n, rectangular, d = 64.
BLOCK_EMULATION_CASES = {
    "n1001_config5b_offsets": (1001, 1001, (-1000, -1, 0, 1, 1000)),
    "n1001_offsets_beyond_n": (1001, 1001, (-1500, -3, 0, 2, 1200)),
    "rect_40x55": (40, 55, (-7, -1, 0, 2, 9)),
    "rect_55x40": (55, 40, (-7, -1, 0, 2, 9)),
    "d64": (2000, 2000, tuple(range(-480, 480, 15))),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ncol", [2, 3, 10, 20, 33])
@pytest.mark.parametrize("case", list(BLOCK_EMULATION_CASES))
def test_block_kernel_addressing_bitwise_equals_k1_plain(case, ncol, dtype):
    """The block kernel's flat addressing and tile walk, emulated, give
    K1's plain product bitwise, with the plan's blocks and with fewer
    (grid-stride trips), random data in every position."""
    n_rows, n_cols, offsets = BLOCK_EMULATION_CASES[case]
    rng = np.random.default_rng(n_rows * ncol + len(offsets))
    data = torch.from_numpy(rng.standard_normal((len(offsets), n_rows))).to(dtype)
    X = torch.from_numpy(rng.standard_normal((n_cols, ncol))).to(dtype)
    want = dmod.dia_spmv_plain(data, offsets, X, n_cols)
    plan = dmod.launch_config(n_rows, ncol, SMS)
    for blocks in (plan.blocks, max(1, plan.blocks // 7)):
        got = _emulate_block_kernel(data, offsets, X, n_cols, plan._replace(blocks=blocks))
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(777, 777), (40, 55), (55, 40)])
def test_dia_methods_match_jax(shape):
    n_rows, n_cols = shape
    A = (
        _unaligned()
        if shape == (777, 777)
        else _banded(n_rows, n_cols, (-7, -1, 0, 2, 9), seed=3)
    )
    jd, pd = _pair(A)
    rng = np.random.default_rng(1)
    x = rng.normal(size=n_cols)
    X = rng.normal(size=(n_cols, 4))
    u = rng.normal(size=n_rows)
    tol = dict(atol=1e-12, rtol=0)
    y = pd.matvec(torch.from_numpy(x)).numpy()
    Y = pd.matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(y, A @ x, **tol)
    np.testing.assert_allclose(Y, A @ X, **tol)
    if n_rows <= n_cols:
        # For n_rows > n_cols the JAX package's dynamic_slice clamps its
        # start index and shifts the product (ROADMAP.md section 3).
        np.testing.assert_allclose(y, np.asarray(jd.matvec(x)), **tol)
        np.testing.assert_allclose(Y, np.asarray(jd.matmat(X)), **tol)
    np.testing.assert_allclose(
        pd.rmatvec(torch.from_numpy(u)).numpy(), np.asarray(jd.rmatvec(u)),
        **tol,
    )
    np.testing.assert_allclose(
        pd.diagonal().numpy(), np.asarray(jd.diagonal()), **tol
    )
    np.testing.assert_allclose(
        pd.to_dense().numpy(), np.asarray(jd.to_dense()), **tol
    )
    np.testing.assert_allclose(pd.to_dense().numpy(), A.toarray(), **tol)
    for i, j in [(0, 0), (5, 6), (9, 2), (10, 1), (3, 30)]:
        assert float(pd.element(i, j)) == float(jd.element(i, j))


def test_matmat_columns_equal_matvecs():
    _, pd = _pair(_laplacian_2d(12))
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(144, 6)))
    Y = pd.matmat(X)
    for c in range(6):
        np.testing.assert_array_equal(
            Y[:, c].numpy(), pd.matvec(X[:, c].contiguous()).numpy()
        )


def test_ell_matches_jax():
    A = sps.random(60, 45, density=0.1, random_state=4, format="csr")
    je = jf.ell_from_scipy(A)
    pe = ell_from_numpy(
        np.asarray(je.cols), np.asarray(je.vals), je.n_rows, je.n_cols,
        device="cpu",
    )
    rng = np.random.default_rng(5)
    x = rng.normal(size=45)
    X = rng.normal(size=(45, 3))
    u = rng.normal(size=60)
    tol = dict(atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        pe.matvec(torch.from_numpy(x)).numpy(), np.asarray(je.matvec(x)), **tol
    )
    np.testing.assert_allclose(
        pe.matmat(torch.from_numpy(X)).numpy(), np.asarray(je.matmat(X)), **tol
    )
    np.testing.assert_allclose(
        pe.rmatvec(torch.from_numpy(u)).numpy(), np.asarray(je.rmatvec(u)),
        **tol,
    )
    np.testing.assert_allclose(
        pe.diagonal().numpy(), np.asarray(je.diagonal()), **tol
    )
    np.testing.assert_allclose(pe.to_dense().numpy(), A.toarray(), **tol)
    i, j = int(A.nonzero()[0][0]), int(A.nonzero()[1][0])
    assert float(pe.element(i, j)) == float(je.element(i, j))


def test_ell_host_converters_match_jax():
    A = sps.random(30, 30, density=0.2, random_state=6, format="csr")
    for jm, pm in [
        (jf.ell_from_scipy(A), pf.ell_from_scipy(A, device="cpu")),
        (jf.ell_from_dense(A.toarray()),
         pf.ell_from_dense(A.toarray(), device="cpu")),
    ]:
        np.testing.assert_array_equal(pm.cols.numpy(), np.asarray(jm.cols))
        np.testing.assert_array_equal(pm.vals.numpy(), np.asarray(jm.vals))


@pytest.mark.parametrize("case", ["laplacian", "banded", "rectangular"])
def test_dia_from_scipy_matches_jax(case):
    A = {
        "laplacian": lambda: _laplacian_2d(20),
        "banded": lambda: _banded(300, 300, (-40, -3, 0, 1, 17), seed=7),
        "rectangular": lambda: _banded(50, 70, (-5, 0, 12), seed=8),
    }[case]()
    jd = jf.dia_from_scipy(A)
    pd = pf.dia_from_scipy(A, device="cpu")
    assert pd.offsets == tuple(jd.offsets)
    assert (pd.n_rows, pd.n_cols) == (jd.n_rows, jd.n_cols)
    np.testing.assert_array_equal(pd.data.numpy(), np.asarray(jd.data))
    assert pf.dia_suitability(A) == jf.dia_suitability(A)
    f32 = pf.dia_from_scipy(A, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32


def test_symmetrize_matches_jax():
    A = sps.random(40, 40, density=0.15, random_state=9, format="csr")
    for uplo in ("L", "U"):
        want = jf.symmetrize_scipy(A, uplo).toarray()
        np.testing.assert_array_equal(
            pf.symmetrize_scipy(A, uplo).toarray(), want
        )


def test_format_routing():
    lap = _laplacian_2d(10)
    assert isinstance(
        SparseSymMatProd.from_full(lap, device="cpu").ell, pf.DiaMatrix
    )
    rnd = sps.random(50, 50, density=0.3, random_state=1)
    rnd = (rnd + rnd.T).tocsr()
    assert isinstance(
        SparseSymMatProd.from_full(rnd, device="cpu").ell, pf.EllMatrix
    )
    hilo = SparseSymMatProd.from_full(lap, format="dia_hilo", device="cpu").ell
    assert isinstance(hilo, pf.DiaHiLoMatrix)
    # "auto" never routes to hi/lo planes on the CPU
    assert isinstance(
        SparseSymMatProd.from_full(lap, format="auto", device="cpu").ell,
        pf.DiaMatrix,
    )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    data = torch.ones((3, 10), dtype=torch.float64)
    x = torch.ones(10, dtype=torch.float64)
    dmod.dia_spmv(data, (-1, 0, 1), x, 10)
    with pytest.raises(TypeError):
        dmod.dia_spmv(data, (-1, 0, 1), x.float(), 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0), x, 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0, 1), torch.ones(9, dtype=torch.float64), 10)
    with pytest.raises(ValueError):
        dmod.dia_spmv(data, (-1, 0, 1), torch.ones((10, 4)).double().mT, 10)
    many = tuple(range(dmod.MAX_DIAGS + 1))
    with pytest.raises(ValueError):
        dmod.dia_spmv(torch.ones((len(many), 10)).double(), many, x, 10)


def test_cpu_path_launches_no_kernel():
    before = dmod.LAUNCHES
    _, pd = _pair(_laplacian_2d(8))
    pd.matvec(torch.ones(64, dtype=torch.float64))
    assert dmod.LAUNCHES == before
