"""The tall-skinny QR's CPU side (``spectra_tpu_torch/ops/tsqr.py``): which
blocks :func:`qr_orthogonalisation` gives the kernel, that a CPU QR is
bitwise what it was before the kernel existed, the wrapper's checks, and
the tree of panels that ``csrc/tsqr.cu`` walks, emulated here with numpy
Householder panels. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from spectra_tpu_torch.linalg import orthogonalization as porth
from spectra_tpu_torch.ops import tsqr


def _qr_before(A):
    """``qr_orthogonalisation`` as it read before the kernel: the library
    QR, then the sign fix."""
    Q, R = torch.linalg.qr(A)
    d = torch.diagonal(R)
    signs = torch.sgn(torch.where(d == 0, torch.ones_like(d), d))
    return (Q * signs.conj()[None, :]).contiguous()


@pytest.mark.parametrize(
    "device, dtype, shape, kernel",
    [
        ("cuda", torch.float64, (10**6, 10), True),
        ("cuda", torch.float64, (10**6, 20), True),
        ("cuda", torch.float32, (5000, 10), True),
        ("cuda", torch.float64, (7, 1), True),
        ("cuda", torch.float64, (32, 32), True),
        ("cuda", torch.float64, (10**4, tsqr.MAX_COLS + 1), False),
        ("cuda", torch.float64, (9, 10), False),
        ("cuda", torch.float64, (100, 0), False),
        ("cuda", torch.complex128, (1000, 10), False),
        ("cuda", torch.complex64, (1000, 10), False),
        ("cuda", torch.float16, (1000, 10), False),
        ("cuda", torch.float64, (1000,), False),
        ("cuda", torch.float64, (3, 1000, 10), False),
        ("cpu", torch.float64, (10**6, 10), False),
        ("cpu", torch.float32, (1000, 10), False),
        ("meta", torch.float64, (1000, 10), False),
    ],
)
def test_route_predicate(device, dtype, shape, kernel):
    """A real f64 or f32 2-D block on the card with 1 <= c <= MAX_COLS
    and rows >= c takes the kernel; everything else the library."""
    assert tsqr.routes_to_kernel(device, dtype, shape) is kernel


def test_max_cols_is_at_least_32():
    assert tsqr.MAX_COLS >= 32


@pytest.mark.parametrize(
    "dtype, shape",
    [
        (torch.float64, (2000, 10)),
        (torch.float64, (1001, 20)),
        (torch.float64, (50, 1)),
        (torch.float32, (500, 7)),
        (torch.complex128, (300, 6)),
        (torch.float64, (400, 40)),
    ],
)
def test_cpu_qr_orthogonalisation_bitwise_unchanged(dtype, shape):
    """On the CPU ``qr_orthogonalisation`` is bitwise the library QR with
    the sign fix, and neither counter moves."""
    g = torch.Generator().manual_seed(shape[0] * 7 + shape[1])
    A = torch.randn(shape, dtype=dtype, generator=g)
    A[:, shape[1] // 2] = 0  # a zero R_jj takes the +1 sign
    launches, library = tsqr.LAUNCHES, porth.LIBRARY_QRS
    Q = porth.qr_orthogonalisation(A)
    assert torch.equal(Q, _qr_before(A))
    assert Q.is_contiguous()
    assert (tsqr.LAUNCHES, porth.LIBRARY_QRS) == (launches, library)


def test_cpu_twice_is_enough_bitwise_unchanged():
    """The host JD route's extension on the CPU: its QRs are the library's."""
    g = torch.Generator().manual_seed(3)
    V, _ = torch.linalg.qr(torch.randn((500, 8), dtype=torch.float64, generator=g))
    A = torch.cat([V, torch.randn((500, 4), dtype=torch.float64, generator=g)], dim=1)
    out = porth.twice_is_enough(A, 8)

    def before(X):
        X = porth.subspace_orthogonalisation(X, 8)
        return torch.cat([X[:, :8], _qr_before(X[:, 8:])], dim=1)

    assert torch.equal(out, before(before(A)))


@pytest.mark.parametrize("shape", [(3000, 10), (64, 32), (5, 1)])
def test_tsqr_plain_is_the_library_qr_with_the_sign_fix(shape):
    """The kernel's plain version: Q bitwise the old
    ``qr_orthogonalisation``, R upper triangular with a non-negative
    diagonal, A = QR, and no kernel QR counted."""
    A = torch.randn(shape, dtype=torch.float64)
    launches = tsqr.LAUNCHES
    Q, R = tsqr.tsqr_plain(A)
    assert tsqr.LAUNCHES == launches
    assert torch.equal(Q, _qr_before(A))
    assert torch.equal(R, torch.triu(R)) and bool((torch.diagonal(R) >= 0).all())
    assert float((A - Q @ R).abs().max()) <= 1e-13 * float(A.abs().max())


@pytest.mark.parametrize(
    "A, error",
    [
        (torch.ones((10, 2), dtype=torch.int64), TypeError),
        (torch.ones((10, 2), dtype=torch.complex128), TypeError),
        (torch.ones((10, 2), dtype=torch.float16), TypeError),
        (torch.ones(10, dtype=torch.float64), ValueError),
        (torch.ones((2, 10, 2), dtype=torch.float64), ValueError),
        (torch.ones((10, 0), dtype=torch.float64), ValueError),
        (torch.ones((100, tsqr.MAX_COLS + 1), dtype=torch.float64), ValueError),
        (torch.ones((3, 4), dtype=torch.float64), ValueError),
        (torch.ones((4, 10), dtype=torch.float64).T, ValueError),
        (torch.ones((10, 6), dtype=torch.float32)[:, ::2], ValueError),
        (torch.ones((10, 2), dtype=torch.float64), ValueError),  # on the CPU
        (torch.ones((10, 2), dtype=torch.float32, device="meta"), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(A, error):
    """Wrong dtype, rank, width, height or layout, or a tensor that is not
    on the card (the CPU's QR is :func:`tsqr_plain`)."""
    launches = tsqr.LAUNCHES
    with pytest.raises(error):
        tsqr.tsqr(A)
    assert tsqr.LAUNCHES == launches


def _householder(panel, c):
    """A panel's Householder QR as the kernel computes it (dlarfg, dlarf,
    dorg2r): Q_p (rows, c) and R_p (c, c), R's diagonal not yet fixed."""
    a = panel.copy()
    rows = a.shape[0]
    tau = np.zeros(c)
    for j in range(c):
        alpha, x = a[j, j], a[j + 1 :, j]
        xnorm2 = float(x @ x)
        t, scale, beta = 0.0, 0.0, alpha
        if xnorm2 != 0.0:
            beta = -np.copysign(np.sqrt(alpha * alpha + xnorm2), alpha)
            t, scale = (beta - alpha) / beta, 1.0 / (alpha - beta)
        tau[j] = t
        a[j + 1 :, j] *= scale
        v = np.zeros(rows)
        v[j], v[j + 1 :] = 1.0, a[j + 1 :, j]
        a[:, j + 1 : c] -= np.outer(v, t * (v @ a[:, j + 1 : c]))
        a[j, j] = beta
    R = np.triu(a[:c])
    for i in range(c - 1, -1, -1):
        v = np.zeros(rows)
        v[i], v[i + 1 :] = 1.0, a[i + 1 :, i]
        a[:, i + 1 : c] -= np.outer(v, tau[i] * (v @ a[:, i + 1 : c]))
        a[:i, i], a[i, i], a[i + 1 :, i] = 0.0, 1.0 - tau[i], -tau[i] * a[i + 1 :, i]
    return a, R


def _levels(n, c, P):
    """The rows of each level of the tree: n, then each level the stacked
    c x c R factors of the panels of P rows below it, until one panel is
    left."""
    levels = [n]
    while -(-levels[-1] // P) > 1:
        levels.append(-(-levels[-1] // P) * c)
    return levels


def _emulate(A, P):
    """The kernel's passes over the tree of panels of P rows: factor
    each level's panels (zero-padded to P rows) into the next, the top
    panel with the signs of its R, then Q from the top down as Q_p B_p."""
    c = A.shape[1]
    levels = [A]
    for rows in _levels(A.shape[0], c, P)[1:]:
        M = levels[-1]
        stacked = np.zeros((rows, c))
        for p in range(-(-M.shape[0] // P)):
            panel = np.zeros((P, c))
            part = M[p * P : (p + 1) * P]
            panel[: len(part)] = part
            stacked[p * c : (p + 1) * c] = _householder(panel, c)[1]
        levels.append(stacked)
    top = np.zeros((P, c))
    top[: len(levels[-1])] = levels[-1]
    Qt, Rt = _householder(top, c)
    d = np.where(np.diag(Rt) < 0, -1.0, 1.0)
    Y = (Qt * d[None, :])[: len(levels[-1])]
    for M in reversed(levels[:-1]):
        out = np.zeros_like(M)
        for p in range(-(-M.shape[0] // P)):
            panel = np.zeros((P, c))
            part = M[p * P : (p + 1) * P]
            panel[: len(part)] = part
            out[p * P : p * P + len(part)] = (_householder(panel, c)[0] @ Y[p * c : (p + 1) * c])[
                : len(part)
            ]
        Y = out
    return Y, d[:, None] * Rt


@pytest.mark.parametrize(
    "n, c, P",
    [
        # the kernel's panels: 384 rows for c <= 10, 128 above
        (20_000, 10, 384), (5003, 7, 384), (700, 3, 384), (5000, 20, 128), (12, 12, 128),
        (3000, 32, 128),
        # smaller panels, for more levels
        (2000, 10, 96), (5003, 7, 96), (1500, 20, 64), (3000, 32, 64), (999, 1, 32),
    ],
)
def test_tree_emulation_gives_the_plain_qr(n, c, P):
    """The kernel's tree of panels, emulated with numpy panels (ragged
    last panels included), is the plain QR to rounding: orthonormal Q,
    A = QR, R upper triangular with a non-negative diagonal, Q within
    1e-12 of :func:`tsqr_plain`'s. Each level is shorter than the one
    below, so the tree ends, in one panel."""
    levels = _levels(n, c, P)
    assert len(levels) >= (2 if n > P else 1) and levels[-1] <= P
    assert all(above < below for below, above in zip(levels, levels[1:]))
    A = np.random.default_rng(n + c).normal(size=(n, c))
    Q, R = _emulate(A, P)
    assert np.abs(Q.T @ Q - np.eye(c)).max() <= 1e-13
    assert np.linalg.norm(A - Q @ R) / np.linalg.norm(A) <= 1e-14
    assert np.array_equal(R, np.triu(R)) and (np.diag(R) >= 0).all()
    Qp, Rp = tsqr.tsqr_plain(torch.from_numpy(A))
    assert np.abs(Q - Qp.numpy()).max() <= 1e-12
    assert np.abs(R - Rp.numpy()).max() <= 1e-12 * np.abs(R).max()
