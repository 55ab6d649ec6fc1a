"""The port's double-single DIA SpMV (K2) and hi/lo DIA format against the
JAX package.

The port runs on the CPU, so the K2 wrappers take their plain versions;
the JAX kernel runs as ``tests/test_dia_ds.py`` runs it
(``interpret=True``, chunk 1024). Tolerances: ``1e-12 * max|y|`` against
the f64 product, as in ``test_dia_ds.py``; ``2^-45 * max|y|`` between
the hi/lo format and the f64 DIA matrix (the planes' backward error).
The plain version also agrees bitwise with a numpy emulation of the
kernel's f32 recurrence. Against JAX's interpret mode ``yh`` agrees
bitwise and ``yl`` does not in every entry: XLA on the CPU evaluates the
error terms in another way; the combined values agree within the
tolerance. The f64 entry (``dia_spmv_ds_f64``, what
``DiaHiLoMatrix.matvec`` runs) is held bitwise to the three-step route
``combine_f64(padded(split_f64(x)))`` and within the same tolerance to
the JAX kernel. The CUDA kernel is held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import spectra_tpu as st
from spectra_tpu.ops import dia_ds as jds
from spectra_tpu.sparse import formats as jf
from spectra_tpu_torch.convert import dia_from_numpy
from spectra_tpu_torch.matop.sparse import SparseSymMatProd
from spectra_tpu_torch.ops import dia_ds as pds
from spectra_tpu_torch.ops import dia_spmv as dmod
from spectra_tpu_torch.ops import stream
from spectra_tpu_torch.solvers.sym_eigs import SymEigsSolver
from spectra_tpu_torch.sparse import formats as pf
from spectra_tpu_torch.util.rng import SimpleRandom
from spectra_tpu_torch.util.selection import SortRule

torch.set_num_threads(1)
CHUNK = 1024


def _random_dia(n, offsets, seed=0):
    """Non-dyadic random diagonals, zero at out-of-range positions."""
    data = np.random.default_rng(seed).standard_normal((len(offsets), n)) * np.pi
    for k, off in enumerate(offsets):
        if off > 0:
            data[k, n - off :] = 0.0
        elif off < 0:
            data[k, :-off] = 0.0
    return data


def _ref_spmv(data, offsets, x):
    n = x.shape[0]
    y = np.zeros(n)
    for k, off in enumerate(offsets):
        if off >= 0:
            y[: n - off] += data[k, : n - off] * x[off:]
        else:
            y[-off:] += data[k, -off:] * x[: n + off]
    return y


def _numpy_ds(dh, dl, xh_ext, xl_ext, offsets, n):
    """The kernel's recurrence in numpy float32, for a bitwise check."""
    f = np.float32
    lo = max(0, -min(offsets))

    def split(a):
        c = a * f(4097.0)
        h = c - (c - a)
        return h, a - h

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    xhh, xhl = split(xh_ext)
    s = np.zeros(n, f)
    c = np.zeros(n, f)
    for k, off in enumerate(offsets):
        a, al = dh[k, :n], dl[k, :n]
        w = slice(lo + off, lo + off + n)
        b, bl, bhh, bhl = xh_ext[w], xl_ext[w], xhh[w], xhl[w]
        p = a * b
        ahh, ahl = split(a)
        err = ((ahh * bhh - p) + ahh * bhl + ahl * bhh) + ahl * bhl
        err = err + a * bl + al * b
        s, e2 = two_sum(s, p)
        c = c + (err + e2)
    return two_sum(s, c)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = {
    "5diag": ((-3, -1, 0, 1, 3), 3000),
    "-17_0_17": ((-17, 0, 17), 2500),
    "3d_7diag_g13": ((-169, -13, -1, 0, 1, 13, 169), 13**3),
}


def test_split_combine_bitwise_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(512) * 10.0 ** rng.integers(-8, 8, 512)
    jh, jl = jds.split_f64(jnp.asarray(x))
    ph, pl = pds.split_f64(torch.from_numpy(x))
    assert ph.dtype == pl.dtype == torch.float32
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        pds.combine_f64(ph, pl).numpy(), np.asarray(jds.combine_f64(jh, jl))
    )
    err = np.abs(pds.combine_f64(ph, pl).numpy() - x)
    assert np.all(err <= 2.0**-47 * np.abs(x))


@pytest.mark.parametrize("entry", ["padded", "ext"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case, entry, record_property):
    offsets, n = CASES[case]
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    rng = np.random.default_rng(2)
    data = _random_dia(n, offsets)
    n_pad = (n + CHUNK - 1) // CHUNK * CHUNK
    dh, dl = jds.split_f64(jnp.pad(jnp.asarray(data), ((0, 0), (0, n_pad - n))))
    if entry == "padded":
        x = rng.standard_normal(n)
        xh, xl = jds.split_f64(jnp.asarray(x))
        jh, jl = jds.dia_spmv_ds_padded(
            dh, dl, xh, xl, offsets=offsets, n=n, chunk=CHUNK, interpret=True
        )
        ph, pl = pds.dia_spmv_ds_padded(
            _t(dh), _t(dl), _t(xh), _t(xl), offsets=offsets, n=n
        )
        y_ref = _ref_spmv(data, offsets, x)
        xe_h, xe_l = np.pad(np.asarray(xh), (lo, hi)), np.pad(np.asarray(xl), (lo, hi))
    else:
        # random halos in place of the zero padding
        x_ext = rng.standard_normal(lo + n + hi)
        xh, xl = jds.split_f64(jnp.asarray(x_ext))
        jh, jl = jds.dia_spmv_ds_ext(
            dh, dl, xh, xl, offsets=offsets, n=n, chunk=CHUNK, interpret=True
        )
        ph, pl = pds.dia_spmv_ds_ext(
            _t(dh), _t(dl), _t(xh), _t(xl), offsets=offsets, n=n
        )
        y_ref = np.zeros(n)
        for k, off in enumerate(offsets):
            y_ref += data[k] * x_ext[lo + off : lo + off + n]
        xe_h, xe_l = np.asarray(xh), np.asarray(xl)
    nh, nl = _numpy_ds(np.asarray(dh), np.asarray(dl), xe_h, xe_l, offsets, n)
    np.testing.assert_array_equal(ph.numpy(), nh)
    np.testing.assert_array_equal(pl.numpy(), nl)
    y_port = pds.combine_f64(ph, pl).numpy()
    y_jax = np.asarray(jds.combine_f64(jh, jl))
    scale = np.abs(y_ref).max()
    assert np.abs(y_port - y_ref).max() <= 1e-12 * scale
    assert np.abs(y_jax - y_ref).max() <= 1e-12 * scale
    assert np.abs(y_port - y_jax).max() <= 1e-12 * scale
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    record_property(
        "bitwise_equal_to_jax",
        bool(np.array_equal(pl.numpy(), np.asarray(jl))),
    )


@pytest.mark.parametrize("case", list(CASES))
def test_f64_entry_matches_pallas_interpret(case):
    """The f64 entry against the JAX kernel in interpret mode (its x split
    and its y combined as the JAX package does at the call boundary) and
    the f64 product, within ``1e-12 * max|y|``; bitwise the three-step
    route through the port's own plain version."""
    offsets, n = CASES[case]
    data = _random_dia(n, offsets, seed=5)
    x = np.random.default_rng(6).standard_normal(n)
    n_pad = (n + CHUNK - 1) // CHUNK * CHUNK
    dh, dl = jds.split_f64(jnp.pad(jnp.asarray(data), ((0, 0), (0, n_pad - n))))
    y_jax = np.asarray(jds.combine_f64(*jds.dia_spmv_ds_padded(
        dh, dl, *jds.split_f64(jnp.asarray(x)), offsets=offsets, n=n,
        chunk=CHUNK, interpret=True,
    )))
    y_port = pds.dia_spmv_ds_f64(_t(dh), _t(dl), _t(x), offsets=offsets, n=n)
    assert y_port.dtype == torch.float64 and y_port.shape == (n,)
    three_step = pds.combine_f64(*pds.dia_spmv_ds_plain(
        _t(dh), _t(dl), *pds.split_f64(_t(x)), offsets=offsets, n=n
    ))
    assert torch.equal(y_port, three_step)
    y_ref = _ref_spmv(data, offsets, x)
    scale = np.abs(y_ref).max()
    assert np.abs(y_port.numpy() - y_ref).max() <= 1e-12 * scale
    assert np.abs(y_port.numpy() - y_jax).max() <= 1e-12 * scale


@pytest.mark.parametrize(
    "n, offsets",
    [(1, (0,)), (2, (-1, 0, 1)), (3, (-1, 0, 1)), (1001, (-7, 0, 3)),
     (1002, (0,)), (1003, (-40, -1, 0, 1, 40))],
)
def test_f64_plain_is_the_three_step_route(n, offsets):
    """``dia_spmv_ds_f64_plain`` is bitwise split, the padded recurrence
    and combine, at n of every residue mod 4 and n < 4; the wrapper on
    the CPU returns the same."""
    data = _random_dia(n, offsets, seed=n)
    dh, dl = pds.split_f64(_t(data))
    x = _t(np.random.default_rng(n).standard_normal(n) * 1e3)
    y = pds.dia_spmv_ds_f64_plain(dh, dl, x, offsets=offsets, n=n)
    ref = pds.combine_f64(
        *pds.dia_spmv_ds_plain(dh, dl, *pds.split_f64(x), offsets=offsets, n=n)
    )
    assert torch.equal(y, ref)
    assert torch.equal(pds.dia_spmv_ds_f64(dh, dl, x, offsets=offsets, n=n), ref)


@pytest.mark.parametrize("n", [1256, 1257, 1258, 1259])
def test_hilo_matvec_unchanged_by_padded_planes(n):
    """``from_dia`` pads the planes' leading dimension to a multiple of 32
    with zeros; ``matvec`` (now one call of the f64 entry) is bitwise the
    three-step route over unpadded planes, at n of every residue mod 4."""
    offsets = (-16, -1, 0, 1, 16)
    data = _random_dia(n, offsets, seed=n)
    hilo = pf.DiaHiLoMatrix.from_dia(dia_from_numpy(data, offsets, n, n, device="cpu"))
    ld = hilo.data_hi.shape[1]
    assert hilo.data_lo.shape == hilo.data_hi.shape == (5, ld)
    assert ld % pf.PLANE_ALIGN == 0 and n <= ld < n + pf.PLANE_ALIGN
    assert not hilo.data_hi[:, n:].any() and not hilo.data_lo[:, n:].any()
    dh, dl = pds.split_f64(_t(data))
    assert torch.equal(hilo.data_hi[:, :n], dh) and torch.equal(hilo.data_lo[:, :n], dl)
    x = _t(np.random.default_rng(7).standard_normal(n))
    before = pds.combine_f64(
        *pds.dia_spmv_ds_plain(dh, dl, *pds.split_f64(x), offsets=offsets, n=n)
    )
    assert torch.equal(hilo.matvec(x), before)


@pytest.mark.parametrize("n", [1256, 1257, 1258, 1259])
def test_padded_planes_accessors_match_jax(n):
    """Every accessor reads the first n columns of the padded planes:
    bitwise the JAX format's (padded to its chunk)."""
    offsets = (-16, -1, 0, 1, 16)
    jh, ph = _jax_and_port_hilo(n, offsets, seed=n)
    assert ph.data_hi.shape[1] > n or n % pf.PLANE_ALIGN == 0
    np.testing.assert_array_equal(ph.to_dia().data.numpy(), np.asarray(jh.to_dia().data))
    np.testing.assert_array_equal(ph.data.numpy(), np.asarray(jh.data))
    np.testing.assert_array_equal(ph.diagonal().numpy(), np.asarray(jh.diagonal()))
    np.testing.assert_array_equal(
        ph.row_abs_sums().numpy(), np.abs(np.asarray(jh.data)).sum(axis=0)
    )
    np.testing.assert_array_equal(ph.to_dense().numpy(), np.asarray(jh.to_dense()))
    u = np.random.default_rng(8).standard_normal(n)
    np.testing.assert_array_equal(
        ph.rmatvec(_t(u)).numpy(), np.asarray(jh.rmatvec(jnp.asarray(u)))
    )
    for i, j in [(0, 0), (n - 1, n - 1), (n - 1, n - 2), (n - 17, n - 1)]:
        assert float(ph.element(i, j)) == float(jh.element(i, j))
    assert ph.nnz == jh.nnz == 5 * n


def test_host_split_planes_equal_from_dia(monkeypatch):
    """The route's host split (``dia_device_from_scipy``) pads and splits
    exactly as ``from_dia`` does on the device."""
    n = 1003
    A = sps.diags(
        [np.full(n - 31, np.pi), np.full(n, 2.0 / 3.0), np.full(n - 1, -np.e)],
        [-31, 0, 1],
    ).tocsr()
    monkeypatch.setattr(pf, "hilo_route", lambda *args, **kwargs: True)
    routed = pf.dia_device_from_scipy(A, device="cpu")
    assert isinstance(routed, pf.DiaHiLoMatrix)
    ref = pf.DiaHiLoMatrix.from_dia(pf.dia_from_scipy(A, device="cpu"))
    assert torch.equal(routed.data_hi, ref.data_hi)
    assert torch.equal(routed.data_lo, ref.data_lo)


@pytest.mark.parametrize("d", [7, 33, 40])
def test_wide_stencils_run_on_both_kernels(d):
    """33-40 diagonals (what a multigrid level may have) run through K1
    and K2 (both take up to 64) and match their plain versions and the
    f64 product."""
    assert dmod.MAX_DIAGS >= 40 and pds.MAX_DIAGS >= 40
    n = 1500
    offsets = tuple(range(-(d // 2), d - d // 2))
    offsets = tuple(o * 7 for o in offsets)
    data = _random_dia(n, offsets, seed=d)
    x = np.random.default_rng(3).standard_normal(n)
    X = np.random.default_rng(4).standard_normal((n, 3))
    y_ref = _ref_spmv(data, offsets, x)
    dia = dia_from_numpy(data, offsets, n, n, device="cpu")
    y = dia.matvec(torch.from_numpy(x))
    np.testing.assert_array_equal(
        y.numpy(),
        dmod.dia_spmv_plain(dia.data, offsets, torch.from_numpy(x), n).numpy(),
    )
    np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-12 * np.abs(y_ref).max())
    Y = dia.matmat(torch.from_numpy(X))
    np.testing.assert_array_equal(
        Y.numpy(),
        dmod.dia_spmv_plain(dia.data, offsets, torch.from_numpy(X), n).numpy(),
    )
    hilo = pf.DiaHiLoMatrix.from_dia(dia)
    y2 = hilo.matvec(torch.from_numpy(x)).numpy()
    assert np.abs(y2 - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


def _jax_and_port_hilo(n, offsets, seed):
    data = _random_dia(n, offsets, seed=seed)
    jd = jf.DiaMatrix(data=jnp.asarray(data), offsets=offsets, n_rows=n, n_cols=n)
    pdia = dia_from_numpy(data, offsets, n, n, device="cpu")
    return jf.DiaHiLoMatrix.from_dia(jd, chunk=CHUNK), pf.DiaHiLoMatrix.from_dia(pdia)


def test_hilo_matrix_matches_jax():
    n, offsets = 1257, (-16, -1, 0, 1, 16)
    jh, ph = _jax_and_port_hilo(n, offsets, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n)
    X = rng.standard_normal((n, 3))
    tol = 2.0**-45
    # The JAX format runs its f64 DIA fallback off the TPU; the port runs
    # the double-single plain version. They agree to the planes'
    # backward error.
    y_j, y_p = np.asarray(jh.matvec(jnp.asarray(x))), ph.matvec(_t(x)).numpy()
    assert np.abs(y_p - y_j).max() <= tol * np.abs(y_j).max()
    Y_j, Y_p = np.asarray(jh.matmat(jnp.asarray(X))), ph.matmat(_t(X)).numpy()
    assert np.abs(Y_p - Y_j).max() <= tol * np.abs(Y_j).max()
    for c in range(3):
        np.testing.assert_array_equal(Y_p[:, c], ph.matvec(_t(X[:, c].copy())).numpy())
    # Every other accessor reads the same planes: equal bitwise.
    np.testing.assert_array_equal(ph.to_dia().data.numpy(), np.asarray(jh.to_dia().data))
    np.testing.assert_array_equal(ph.diagonal().numpy(), np.asarray(jh.diagonal()))
    np.testing.assert_array_equal(ph.to_dense().numpy(), np.asarray(jh.to_dense()))
    u = rng.standard_normal(n)
    np.testing.assert_array_equal(
        ph.rmatvec(_t(u)).numpy(), np.asarray(jh.rmatvec(jnp.asarray(u)))
    )
    for i, j in [(0, 0), (5, 6), (40, 24), (3, 30)]:
        assert float(ph.element(i, j)) == float(jh.element(i, j))
    np.testing.assert_array_equal(
        ph.row_abs_sums().numpy(), np.abs(np.asarray(jh.data)).sum(axis=0)
    )
    assert ph.dtype == torch.float64 and ph.nnz == jh.nnz == 5 * n


# (dtype, n_rows, n_cols, d, device, routed): the g=243 north-star
# operator (n = 243^3) and its MG level 1 (n = 122^3, d = 27) route on
# the card; config #3's 2-D 1M-node Laplacian (56 MB) does not; nothing
# routes on the CPU.
ROUTES = [
    (torch.float64, 243**3, 243**3, 7, "cuda", True),
    (torch.float64, 122**3, 122**3, 27, "cuda", True),
    (torch.float64, 61**3, 61**3, 27, "cuda", False),
    (torch.float64, 10**6, 10**6, 5, "cuda", False),
    (torch.float64, 243**3, 243**3, 7, "cpu", False),
    (torch.float32, 243**3, 243**3, 7, "cuda", False),
    (torch.float64, 243**3, 243**3 + 1, 7, "cuda", False),
    (torch.float64, 10**7, 10**7, 65, "cuda", False),
    (np.float64, 243**3, 243**3, 7, "cuda", True),
]


@pytest.mark.parametrize("dtype, n_rows, n_cols, d, device, routed", ROUTES)
def test_routing_rule(dtype, n_rows, n_cols, d, device, routed):
    assert pf.hilo_route(dtype, n_rows, n_cols, d, device) is routed


def test_routing_at_the_threshold():
    t = pf.HILO_BYTES_THRESHOLD
    assert t == jf.HILO_BYTES_THRESHOLD == 120 * 1024 * 1024
    n = -(-t // (8 * 9))  # the least n with (d + 2) * 8 * n >= t, d = 7
    assert pf.hilo_route(torch.float64, n, n, 7, "cuda")
    assert not pf.hilo_route(torch.float64, n - 1, n - 1, 7, "cuda")
    assert not pf.hilo_route(torch.float64, n, n, 7, "cpu")
    assert pf.hilo_route(torch.float64, 100, 100, 3, "cuda", threshold=0)


def test_cpu_never_routes():
    A = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(500, 500)).tocsr()
    dia = pf.dia_from_scipy(A, device="cpu")
    assert pf.maybe_hilo(dia, threshold=0) is dia
    assert isinstance(pf.dia_device_from_scipy(A, device="cpu"), pf.DiaMatrix)
    # the JAX package off the TPU does the same
    jdia = jf.dia_from_scipy(A)
    assert jf.maybe_hilo(jdia, threshold=0) is jdia


def test_sym_eigs_on_dia_hilo_matches_jax():
    """``format="dia_hilo"`` through ``SymEigsSolver`` against the JAX
    package on the anisotropic grid (simple extreme eigenvalues): same
    nconv and info, eigenvalues within 1e-10, equal counts."""
    g = 20
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    A = (sps.kron(sps.eye(g), lap1) + 1.37 * sps.kron(lap1, sps.eye(g))).tocsr()
    v0 = SimpleRandom(0).random_vec(g * g)
    jop = st.SparseSymMatProd.from_full(A, format="dia_hilo")
    assert isinstance(jop.ell, jf.DiaHiLoMatrix)
    js = st.SymEigsSolver(jop, nev=4, ncv=12)
    js.init(v0)
    jn = js.compute(st.SortRule.LargestAlge, maxit=500, tol=1e-10)
    pop = SparseSymMatProd.from_full(A, format="dia_hilo", device="cpu")
    assert isinstance(pop.ell, pf.DiaHiLoMatrix)
    ps = SymEigsSolver(pop, nev=4, ncv=12)
    ps.init(v0)
    pn = ps.compute(SortRule.LargestAlge, maxit=500, tol=1e-10)
    assert pn == jn == 4 and ps.info().name == js.info().name == "Successful"
    np.testing.assert_allclose(
        ps.eigenvalues(), np.asarray(js.eigenvalues()), rtol=0, atol=1e-10
    )
    assert ps.num_iterations() == js.num_iterations()
    assert ps.num_operations() == js.num_operations()


def test_wrappers_reject_what_the_kernels_do_not_take():
    n, offsets = 10, (-1, 0, 1)
    dh = torch.ones((3, n))
    x = torch.ones(n)
    pds.dia_spmv_ds_padded(dh, dh, x, x, offsets=offsets, n=n)
    with pytest.raises(TypeError):
        pds.dia_spmv_ds_padded(dh.double(), dh.double(), x, x, offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_padded(dh, dh, x[:9], x[:9], offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_ext(dh, dh, x, x, offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_padded(dh[:2], dh[:2], x, x, offsets=offsets, n=n)
    many = tuple(range(pds.MAX_DIAGS + 1))
    wide = torch.ones((len(many), n))
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_padded(wide, wide, x, x, offsets=many, n=n)
    hilo = pf.DiaHiLoMatrix.from_dia(
        dia_from_numpy(np.ones((3, n)), offsets, n, n, device="cpu")
    )
    with pytest.raises(TypeError):
        hilo.matvec(x)
    with pytest.raises(ValueError):
        pf.DiaHiLoMatrix.from_dia(
            dia_from_numpy(np.ones((3, n)), offsets, n, n + 1, device="cpu")
        )
    with pytest.raises(ValueError):
        stream.stream_scale2(torch.ones(4, dtype=torch.float64))


def test_f64_wrapper_rejects_what_the_kernel_does_not_take():
    n, offsets = 10, (-1, 0, 1)
    dh = torch.ones((3, 12))
    x = torch.ones(n, dtype=torch.float64)
    assert pds.dia_spmv_ds_f64(dh, dh, x, offsets=offsets, n=n).dtype == torch.float64
    with pytest.raises(TypeError):
        pds.dia_spmv_ds_f64(dh, dh, x.float(), offsets=offsets, n=n)
    with pytest.raises(TypeError):
        pds.dia_spmv_ds_f64(dh.double(), dh.double(), x, offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_f64(dh, dh, x[:9], offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_f64(dh, dh, torch.ones(11, dtype=torch.float64),
                            offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_f64(dh, dh, x.to("meta"), offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_f64(dh[:, :9], dh[:, :9], x, offsets=offsets, n=n)
    with pytest.raises(ValueError):
        pds.dia_spmv_ds_f64(dh.t().contiguous().t(), dh, x, offsets=offsets, n=n)


def test_cpu_paths_launch_no_kernel():
    before = (pds.LAUNCHES, stream.LAUNCHES)
    hilo = pf.DiaHiLoMatrix.from_dia(
        dia_from_numpy(_random_dia(64, (-8, 0, 8)), (-8, 0, 8), 64, 64, device="cpu")
    )
    hilo.matvec(torch.ones(64, dtype=torch.float64))
    pds.dia_spmv_ds_f64(
        hilo.data_hi, hilo.data_lo, torch.ones(64, dtype=torch.float64),
        offsets=hilo.offsets, n=64,
    )
    x = torch.randn(1001, dtype=torch.float32)
    assert torch.equal(stream.stream_scale2(x), x * 2)
    assert (pds.LAUNCHES, stream.LAUNCHES) == before
