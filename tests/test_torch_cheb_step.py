"""The Chebyshev recurrence step's CPU side (``spectra_tpu_torch/ops/
cheb_step.py``): that its plain version is bitwise the filter's
recurrence as it read before the kernel, that the filter on CPU tensors,
real or complex, never reaches the kernel's binding or its build, and
the host logic around the kernel (the pointers it is handed, complex
operands as their real view, non-contiguous operands as contiguous
copies, the update written over ``T_{k-1}`` and never over x,
mismatched operands refused), with the kernel emulated by numpy through
the tensors' addresses. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import ctypes

import numpy as np
import pytest
import torch

from spectra_tpu_torch.matop.chebyshev import ChebyshevFilteredOp
from spectra_tpu_torch.matop.dense import DenseHermMatProd, DenseSymMatProd
from spectra_tpu_torch.ops import _build
from spectra_tpu_torch.ops import cheb_step as cs

LO, HI = -0.7, 3.1
C, H = 0.5 * (HI + LO), 0.5 * (HI - LO)

DTYPES = [torch.float64, torch.float32]
SHAPES = [(1001,), (1001, 3)]


def _operands(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    y, t, t_prev = (torch.from_numpy(rng.normal(size=shape)).to(dtype)
                    for _ in range(3))
    return y, t, t_prev


def _scaled_before(op, x, c, h):
    """``ChebyshevFilteredOp._scaled_matvec`` as it read before the
    kernel."""
    return (op.perform_op(x) - c * x) / h


def _filter_before(op, x, degree, c=C, h=H):
    """``ChebyshevFilteredOp.perform_op`` as it read before the kernel."""
    t_prev = x
    t_cur = _scaled_before(op, x, c, h)
    for _ in range(1, degree):
        t_prev, t_cur = t_cur, 2.0 * _scaled_before(op, t_cur, c, h) - t_prev
    return t_cur


class _Given:
    """An operator that returns a fixed ``y`` whatever it is given."""

    def __init__(self, y):
        self.y = y

    def perform_op(self, x):
        return self.y


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
@pytest.mark.parametrize("shape", SHAPES, ids=["vector", "block3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_plain_step_is_the_recurrence_before(dtype, shape, first):
    y, t, t_prev = _operands(dtype, shape)
    scaled = _scaled_before(_Given(y), t, C, H)
    want = scaled if first else 2.0 * scaled - t_prev
    got = cs.cheb_step_plain(y, t, None if first else t_prev, C, H)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)


def _sym_op(dtype, n=37):
    A = np.random.default_rng(1).normal(size=(n, n))
    return DenseSymMatProd.create((A + A.T).astype(
        np.float64 if dtype == torch.float64 else np.float32), device="cpu")


def _herm_op(n=37):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return DenseHermMatProd.create(A + A.conj().T, device="cpu")


def _no_kernel(*_args, **_kwargs):
    raise AssertionError("the CPU filter reached the kernel")


@pytest.mark.parametrize("degree", [1, 2, 3, 7])
@pytest.mark.parametrize("ncol", [None, 3], ids=["vector", "block3"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128],
                         ids=["f64", "f32", "c128"])
def test_filter_on_cpu_is_unchanged_and_never_builds(monkeypatch, dtype, ncol, degree):
    """The filter on CPU tensors, real or complex, gives bitwise what it
    gave before the kernel, leaves x as it was, and never looks up the
    kernel or builds its library."""
    monkeypatch.setattr(_build, "load", _no_kernel)
    monkeypatch.setattr(cs, "_kernel", _no_kernel)
    op = _herm_op() if dtype.is_complex else _sym_op(dtype)
    shape = (op.rows(),) if ncol is None else (op.rows(), ncol)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    if dtype.is_complex:
        x = x + 1j * torch.from_numpy(rng.normal(size=shape)).to(dtype)
    x0 = x.clone()
    filt = ChebyshevFilteredOp.create(op, LO, HI, degree)
    before = cs.LAUNCHES
    got = filt.perform_op(x)
    assert torch.equal(got, _filter_before(op, x, degree))
    assert torch.equal(x, x0)
    assert cs.LAUNCHES == before
    assert not cs.routes_to_kernel(x)


_CTYPE = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}
_NP = {torch.float64: np.float64, torch.float32: np.float32}
_REAL = {torch.float64: torch.float64, torch.float32: torch.float32,
         torch.complex128: torch.float64, torch.complex64: torch.float32}


class _EmulatedKernel:
    """``spectra_cheb_step_*`` in numpy, on the memory the pointers name:
    the operands rounded as the kernel's entry rounds them (c, and 1 / h
    computed in double, to the dtype), each operation rounded on its own
    in the kernel's order. Records the pointers and length of every
    call."""

    def __init__(self, dtype):
        self.real = _REAL[dtype]
        self.calls = []

    def _array(self, ptr, n):
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(_CTYPE[self.real])), shape=(n,))

    def __call__(self, y, t, t_prev, out, n, c, h, device, stream):
        self.calls.append((y, t, t_prev, out, n))
        f = _NP[self.real]
        c, inv_h = f(c), f(1.0 / h)
        q = (self._array(y, n) - c * self._array(t, n)) * inv_h
        r = q if t_prev is None else f(2) * q - self._array(t_prev, n)
        self._array(out, n)[:] = r
        return 0


def _real(a):
    return torch.view_as_real(a) if a.is_complex() else a


def _filter_reciprocal(op, x, degree, dtype):
    """The filter with the kernel's arithmetic, in torch, on the real view
    of complex vectors."""
    f = _NP[_REAL[dtype]]
    c, inv_h = float(f(C)), float(f(1.0 / H))

    def step(t, t_prev):
        q = (_real(op.perform_op(t)) - c * _real(t)) * inv_h
        r = q if t_prev is None else 2.0 * q - _real(t_prev)
        return torch.view_as_complex(r) if dtype.is_complex else r

    t_prev, t_cur = x, step(x, None)
    for _ in range(1, degree):
        t_prev, t_cur = t_cur, step(t_cur, t_prev)
    return t_cur


def _emulate(monkeypatch, dtype):
    """Route CPU tensors to the kernel, emulated; returns the emulation."""
    kernel = _EmulatedKernel(dtype)
    monkeypatch.setattr(cs, "routes_to_kernel", lambda t: True)
    monkeypatch.setattr(cs, "_kernel", lambda d: kernel)
    monkeypatch.setattr(cs, "_stream", lambda index: 0)
    return kernel


def _vector(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    if dtype.is_complex:
        x = x + 1j * torch.from_numpy(rng.normal(size=shape)).to(dtype)
    return x


@pytest.mark.parametrize("degree", [1, 2, 3, 6])
@pytest.mark.parametrize("ncol", [None, 3], ids=["vector", "block3"])
@pytest.mark.parametrize("dtype", DTYPES + [torch.complex128],
                         ids=["f64", "f32", "c128"])
def test_filter_hands_the_kernel_its_operands(monkeypatch, dtype, ncol, degree):
    """With the kernel emulated on the CPU: one launch a degree step, the
    first without ``t_prev``, the second into a new tensor (its
    ``t_prev`` is x), every later one over its ``t_prev``; x is never
    written, a complex vector goes as its 2n reals, and the result is the
    recurrence with the kernel's arithmetic."""
    kernel = _emulate(monkeypatch, dtype)
    op = _herm_op() if dtype.is_complex else _sym_op(dtype)
    shape = (op.rows(),) if ncol is None else (op.rows(), ncol)
    x = _vector(dtype, shape, 4)
    x0 = x.clone()
    before = cs.LAUNCHES
    got = ChebyshevFilteredOp.create(op, LO, HI, degree).perform_op(x)
    assert cs.LAUNCHES - before == degree == len(kernel.calls)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(x, x0)
    assert torch.equal(got, _filter_reciprocal(op, x, degree, dtype))
    x_ptr = x.data_ptr()
    for k, (_, t, t_prev, out, n) in enumerate(kernel.calls):
        assert n == x.numel() * (2 if dtype.is_complex else 1)
        assert out != x_ptr
        if k == 0:
            assert t == x_ptr and t_prev is None
        elif k == 1:
            assert t_prev == x_ptr
        else:
            assert out == t_prev
    assert kernel.calls[-1][3] == got.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128], ids=["f64", "c128"])
def test_kernel_filter_within_rounding_of_the_cpu_filter(monkeypatch, dtype):
    """The filter through the kernel's multiply by 1 / h stays within
    rounding of the filter on the CPU, which divides: the two agree to a
    few ulps of the largest entry at degree 20."""
    op = _herm_op() if dtype.is_complex else _sym_op(dtype)
    x = _vector(dtype, (op.rows(),), 5)
    filt = ChebyshevFilteredOp.create(op, LO, HI, 20)
    a = filt.perform_op(x)
    _emulate(monkeypatch, dtype)
    before = cs.LAUNCHES
    b = filt.perform_op(x)
    assert cs.LAUNCHES - before == 20
    assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())


@pytest.mark.parametrize("layout", ["t", "y", "t_prev"])
@pytest.mark.parametrize("dtype", DTYPES + [torch.complex64], ids=["f64", "f32", "c64"])
def test_kernel_gets_contiguous_copies(monkeypatch, dtype, layout):
    """An operand that is not contiguous (a column of a block) reaches the
    kernel as a contiguous copy; the step is the one its contiguous
    operands give, and in place it writes over that copy alone."""
    kernel = _emulate(monkeypatch, dtype)
    blocks = {name: _vector(dtype, (41, 2), seed) for seed, name in
              enumerate(("y", "t", "t_prev"))}
    ops = {name: (b[:, 1] if name == layout else b[:, 1].clone())
           for name, b in blocks.items()}
    want = cs.cheb_step(*(o.contiguous() for o in ops.values()), C, H)
    kept = ops["t_prev"].clone()
    got = cs.cheb_step(ops["y"], ops["t"], ops["t_prev"], C, H, overwrite=True)
    assert torch.equal(got, want) and got.is_contiguous()
    assert len(kernel.calls) == 2
    assert (got.data_ptr() == ops["t_prev"].data_ptr()) == (layout != "t_prev")
    if layout == "t_prev":
        assert torch.equal(ops["t_prev"], kept)


_X = torch.zeros(11, dtype=torch.float64)


@pytest.mark.parametrize("y, t, t_prev", [
    (_X, _X, _X.float()), (_X.float(), _X, None), (_X[:10], _X, None),
    (_X, _X, _X.reshape(11, 1)), (_X.half(), _X.half(), None),
    (_X.long(), _X.long(), None), (_X.to(torch.complex128), _X, None),
], ids=["t_prev_f32", "y_f32", "y_short", "t_prev_block", "f16", "int64", "y_complex"])
def test_kernel_refuses_mismatched_operands(monkeypatch, y, t, t_prev):
    """Operands of another dtype or shape than ``t``, or a dtype the kernel
    does not take, raise before any launch."""
    kernel = _emulate(monkeypatch, torch.float64)
    with pytest.raises(ValueError):
        cs.cheb_step(y, t, t_prev, C, H)
    assert kernel.calls == []


def test_empty_operands_launch_nothing(monkeypatch):
    kernel = _emulate(monkeypatch, torch.float64)
    e = torch.zeros((0, 3), dtype=torch.float64)
    got = cs.cheb_step(e, e, e, C, H)
    assert got.shape == (0, 3) and kernel.calls == []
