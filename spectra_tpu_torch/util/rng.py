"""Deterministic random vectors for residual initialization.

Port of :mod:`spectra_tpu.util.rng`. The reference seeds every solver
with a Park-Miller MINSTD LCG (a = 16807, m = 2^31 - 1, seed 0 mapped
to state 1) and draws Uniform(-0.5, 0.5) entries (reference:
Util/SimpleRandom.h:21-129). :class:`SimpleRandom` is numpy-only and
copied unchanged, so starting vectors are bit-identical to the JAX
package's and to the reference's.

The LCG is evaluated in closed form ``state_k = a^k * state_0 mod m``,
with all powers ``a^k mod m`` built from a 2^16-block decomposition:
one table of ``a^r mod m`` (r < B) and one of ``a^(qB) mod m``. All
products fit in uint64 since both factors are < 2^31.

Breakdown restarts inside the Krylov factorization draw from a
``torch.Generator`` (:func:`uniform_m05_05`). The reference requires
only determinism there, not a particular bit stream (reference:
Util/SimpleRandom.h:17-27), so these vectors differ from the JAX
package's ``jax.random`` draws.
"""

import functools

import numpy as np
import torch

_A = 16807
_M = 2147483647  # 2^31 - 1
_BLOCK = 1 << 16


@functools.lru_cache(maxsize=1)
def _low_powers() -> np.ndarray:
    out = np.empty(_BLOCK, dtype=np.uint64)
    v = 1
    for i in range(_BLOCK):
        out[i] = v
        v = (v * _A) % _M
    return out


@functools.lru_cache(maxsize=8)
def _high_powers(nblocks: int) -> np.ndarray:
    a_block = pow(_A, _BLOCK, _M)
    out = np.empty(nblocks, dtype=np.uint64)
    v = 1
    for i in range(nblocks):
        out[i] = v
        v = (v * a_block) % _M
    return out


def _lcg_states(seed: int, count: int) -> np.ndarray:
    """States 1..count of the MINSTD LCG starting from ``seed``."""
    state0 = (seed & _M) if seed else 1
    k = np.arange(1, count + 1, dtype=np.uint64)
    lo = _low_powers()[k % _BLOCK]
    hi = _high_powers(int(k[-1] // _BLOCK) + 1)[k // _BLOCK]
    powers = (hi * lo) % _M
    return (powers * np.uint64(state0)) % _M


class SimpleRandom:
    """Bit-exact, vectorized reproduction of the reference's LCG."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._drawn = 0

    def _draw(self, count: int) -> np.ndarray:
        # Each random() call advances the state first, then maps the new
        # state to (-0.5, 0.5); we replay the whole stream from seed so
        # interleaved scalar/vector draws stay consistent.
        states = _lcg_states(self._seed, self._drawn + count)
        vals = states[self._drawn :].astype(np.float64) / _M - 0.5
        self._drawn += count
        return vals

    def random(self, dtype=np.float64):
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            v = self._draw(2)
            return np.dtype(dtype).type(complex(v[0], v[1]))
        return np.dtype(dtype).type(self._draw(1)[0])

    def random_vec(self, n: int, dtype=np.float64) -> np.ndarray:
        """Vector of Uniform(-0.5, 0.5) draws, identical to the reference."""
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            v = self._draw(2 * n)
            return (v[0::2] + 1j * v[1::2]).astype(dtype)
        return self._draw(n).astype(dtype)


def uniform_m05_05(
    generator: torch.Generator, n: int, dtype: torch.dtype, device
) -> torch.Tensor:
    """Uniform(-0.5, 0.5) vector of length ``n`` drawn from
    ``generator``, which must live on ``device``."""
    if dtype.is_complex:
        rdtype = dtype.to_real()
        re = torch.rand(n, generator=generator, dtype=rdtype, device=device)
        im = torch.rand(n, generator=generator, dtype=rdtype, device=device)
        return torch.complex(re - 0.5, im - 0.5)
    return torch.rand(n, generator=generator, dtype=dtype, device=device) - 0.5
