"""The port's util modules against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectra_tpu.util import dtypes as jdt
from spectra_tpu.util import rng as jrng
from spectra_tpu.util import selection as jsel
from spectra_tpu_torch.util import dtypes as pdt
from spectra_tpu_torch.util import rng as prng
from spectra_tpu_torch.util import selection as psel
from spectra_tpu_torch.util.capabilities import resolve_device
from spectra_tpu_torch.util.compinfo import CompInfo

torch.set_num_threads(1)

REAL_RULES = [
    "LargestMagn", "LargestReal", "LargestAlge", "SmallestMagn",
    "SmallestReal", "SmallestAlge", "BothEnds",
]


@pytest.mark.parametrize("seed", [0, 1, 77003])
def test_simple_random_bit_identical(seed):
    want = jrng.SimpleRandom(seed)
    got = prng.SimpleRandom(seed)
    np.testing.assert_array_equal(got.random_vec(1000), want.random_vec(1000))
    assert got.random() == want.random()
    np.testing.assert_array_equal(
        got.random_vec(70000, np.float32), want.random_vec(70000, np.float32)
    )


@pytest.mark.parametrize("rule", REAL_RULES)
def test_argsort_matches_jax_with_ties(rule):
    rng = np.random.default_rng(3)
    vals = np.round(rng.normal(size=40), 1)  # many ties
    vals[:6] = [2.0, -2.0, 2.0, 0.0, -0.0, -2.0]
    want = np.asarray(jsel.argsort(getattr(jsel.SortRule, rule), jnp.asarray(vals)))
    got = psel.argsort(getattr(psel.SortRule, rule), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        psel.argsort_np(getattr(psel.SortRule, rule), vals),
        jsel.argsort_np(getattr(jsel.SortRule, rule), vals),
    )


def test_enums_match_by_name():
    assert [r.name for r in psel.SortRule] == [r.name for r in jsel.SortRule]
    assert [r.value for r in psel.SortRule] == [r.value for r in jsel.SortRule]
    assert [c.name for c in CompInfo] == [
        "Successful", "NotComputed", "NotConverging", "NumericalIssue"
    ]


def test_imag_rules_need_complex():
    with pytest.raises(ValueError):
        psel.argsort(psel.SortRule.LargestImag, torch.zeros(3))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dtype_traits_match_jax(dtype):
    tdt = getattr(torch, dtype)
    assert pdt.eps(tdt) == jdt.eps(np.dtype(dtype))
    assert pdt.eps23(tdt) == jdt.eps23(np.dtype(dtype))
    assert pdt.near_zero(tdt) == jdt.near_zero(np.dtype(dtype))
    assert pdt.numpy_dtype(tdt) == np.dtype(dtype)


def test_uniform_m05_05_is_deterministic_and_in_range():
    def draw():
        gen = torch.Generator().manual_seed(5)
        return prng.uniform_m05_05(gen, 4096, torch.float64, "cpu")

    a, b = draw(), draw()
    assert torch.equal(a, b)
    assert a.dtype == torch.float64
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.02


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
