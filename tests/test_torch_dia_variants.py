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
    # The TPU probe's window rule, which the plain version transcribes.
    assert dv.pad_rows_for(offsets) == 12
    # The kernel's window: the tile plus max|off| rounded up to 4 a side,
    # held in shares across a cluster, at most 227 KB a CTA.
    assert dv.halo_for(offsets) == 1000
    assert dv.halo_for((-1001, 0, 3)) == 1004
    assert dv.window_bytes(offsets, 256) == (256 * 128 + 2000) * 4
    assert dv.roll2d_plan(10**6, offsets, 512, 132).shared_bytes <= dv.MAX_SHARED_BYTES
    with pytest.raises(ValueError):  # a share above 227 KB even in clusters of 16
        dv.roll2d_plan(4096, (-600_000, 0, 600_000), 256, 132)
    data = torch.ones((5, 64), dtype=torch.float64)
    with pytest.raises(TypeError):
        dv.dia_roll2d(data, offsets, torch.ones(64, dtype=torch.float64))
    with pytest.raises(ValueError):
        dv.dia_noshift(data.float(), offsets[:3], torch.ones(64))
    with pytest.raises(ValueError):
        dv.dia_roll2d(data.float(), offsets, torch.ones(64), rows=0)


def _stencil27(g):
    return tuple(sorted(a * g * g + b * g + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


#: (label, n, offsets): every offsets set these tests and the card's use.
PLAN_SHAPES = [
    ("laplacian_g1000", 10**6, (-1000, -1, 0, 1, 1000)),
    ("laplacian_g1000_n1e5", 10**5, (-1000, -1, 0, 1, 1000)),
    ("nine_offsets", 5000, (-300, -129, -128, -3, 0, 5, 127, 128, 260)),
    ("diagonal", 300, (0,)),
    ("laplacian_g40", 1600, (-40, -1, 0, 1, 40)),
    ("laplacian_g200", 40000, (-200, -1, 0, 1, 200)),
    ("stencil27_g61", 61**3, _stencil27(61)),
    ("stencil27_g7", 7**3, _stencil27(7)),
    ("band_n9001", 9001, (-700, -129, -128, -1, 0, 3, 128, 300)),
    ("wide_offsets", 50001, (-20000, -1, 0, 1, 20000)),
    ("n1", 1, (0,)),
]
SMS = 132


@pytest.mark.parametrize("rows", [1, 8, 32, 256])
@pytest.mark.parametrize("label, n, offsets", PLAN_SHAPES, ids=[s[0] for s in PLAN_SHAPES])
def test_roll2d_plan(label, n, offsets, rows):
    """The launch plan covers every tile once, pads by max|off| rounded up
    to 4 floats, fits each CTA in shared memory, takes a legal cluster
    size and fills the card wherever the tiles allow."""
    plan = dv.roll2d_plan(n, offsets, rows, SMS)
    assert plan.tile == rows * 128
    assert (plan.tiles - 1) * plan.tile < n <= plan.tiles * plan.tile
    assert plan.cluster in dv.CLUSTER_SIZES and plan.threads in dv.BLOCK_SIZES
    assert plan.threads <= (512 if len(offsets) == 27 else 1024)
    assert plan.per_cta * plan.cluster == plan.tile and plan.per_cta % 4 == 0
    maxoff = max(abs(o) for o in offsets)
    assert maxoff <= plan.halo < maxoff + 4 and plan.halo % 4 == 0
    assert plan.share % 4 == 0 and plan.share >= plan.per_cta
    assert plan.share * plan.cluster >= plan.tile + 2 * plan.halo
    assert plan.shared_bytes <= dv.MAX_SHARED_BYTES
    # The CTAs reach the SM count wherever the tiles allow (every cluster
    # size fits at these shapes), all held at once where any launch is.
    assert plan.ctas >= min(SMS, plan.tiles * dv.CLUSTER_SIZES[-1])
    others = dv.roll2d_candidates(n, offsets, rows)
    assert plan in others
    one_wave = lambda p: p.tiles <= dv.held_at_once(p, SMS)
    wide = [p for p in others if p.ctas >= min(SMS, plan.tiles * dv.CLUSTER_SIZES[-1])]
    if any(one_wave(p) for p in wide):
        assert one_wave(plan)
        # One thread per output where a launch held at once gives that.
        if any(p.ctas * p.threads >= n for p in wide if one_wave(p)):
            assert plan.ctas * plan.threads >= n


@pytest.mark.parametrize("rows", [32, 256])
def test_roll2d_plan_takes_one_wave_by_the_cards_count(rows):
    """Where the card holds fewer clusters at once than threads alone
    allow (a model of one 1024-thread CTA an SM), the plan takes a launch
    whose tiles all run at once."""
    offsets = (-1000, -1, 0, 1, 1000)
    held = lambda p: (1 if p.threads == 1024 else 4) * SMS // p.cluster
    plan = dv.roll2d_plan(10**6, offsets, rows, SMS, clusters_at_once=held)
    assert plan.tiles <= held(plan) and plan.ctas >= SMS
    assert plan.threads < 1024 or plan.tiles * plan.cluster <= SMS


def _emulate_kernel(data, offsets, x, plan):
    """The kernel's addressing in numpy: each CTA's window share as its
    bulk copy and plain stores fill it, each read at (owner CTA, local
    index) as the kernel computes them, the f32 terms in offset order."""
    d, n = data.shape
    C, S, H, T, Tc = plan.cluster, plan.share, plan.halo, plan.tile, plan.per_cta
    n4 = n & ~3
    y = np.empty(n, dtype=np.float32)
    for t in range(plan.tiles):
        first = t * T
        shares = np.zeros((C, S), dtype=np.float32)
        for c in range(C):
            g0 = first - H + c * S
            b0, b1 = max(g0, 0), min(g0 + S, n4)
            if b1 <= b0:
                b0 = b1 = g0
            assert b0 % 4 == 0 and b1 % 4 == 0 and (b0 - g0) % 4 == 0
            shares[c, b0 - g0 : b1 - g0] = x[b0:b1]  # the bulk copy
            for l in [*range(0, b0 - g0), *range(b1 - g0, S)]:  # plain stores
                g = g0 + l
                shares[c, l] = x[g] if 0 <= g < n else 0.0
        for c in range(C):
            out0 = first + c * Tc
            valid = min(max(n - out0, 0), Tc)
            p = np.arange(valid)
            acc = None
            for k, off in enumerate(offsets):
                q, r = divmod(H + c * Tc + off, S)
                tt = r + p
                nxt = tt >= S
                owner, local = q + nxt, np.where(nxt, tt - S, tt)
                assert (owner >= 0).all() and (owner < C).all()
                term = data[k, out0 : out0 + valid] * shares[owner, local]
                acc = term if acc is None else acc + term
            y[out0 : out0 + valid] = acc
    return y


@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("label, n, offsets", [
    s for s in PLAN_SHAPES if s[1] <= 10**5 and s[0] != "laplacian_g1000_n1e5"
], ids=lambda v: v if isinstance(v, str) else None)
def test_roll2d_kernel_addressing_bitwise_equals_k1_plain(label, n, offsets, sms):
    """The kernel's window shares and cluster reads, emulated, give K1's
    plain product bitwise, for clusters of 1 to 16 (``sms`` 1 to 132)."""
    rng = np.random.default_rng(n)
    data = (rng.standard_normal((len(offsets), n)) * np.pi).astype(np.float32)
    x = _x(n, seed=n + 1)
    want = k1.dia_spmv_plain(torch.from_numpy(data), offsets, torch.from_numpy(x), n)
    for rows in (1, 8):
        plan = dv.roll2d_plan(n, offsets, rows, sms)
        got = _emulate_kernel(data, offsets, x, plan)
        assert np.array_equal(got, want.numpy())
