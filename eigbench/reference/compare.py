"""The comparison that decides ``correct`` (numpy and scipy only).

One solve's answer (its eigenvalues, eigenvectors, ``nconv`` and
whether it reported success) is held against the reference's wanted
eigenvalues and against the configuration's operands themselves, in f64
on the host. This is the comparison of a real symmetric problem, ``A u
= lambda u``, or ``A u = lambda B u`` where the configuration gives a
``B``. A configuration whose problem needs another (complex pairs, say)
defines its own ``compare`` with this signature in its module, with
``NUMBERS``, the names of the numbers it returns, and the harness takes
that one.

Both sides are sorted by value and paired in that order; each pair is
measured against the scale of its wanted value, ``|lambda_ref - sigma|``
(sigma the shift a "nearest" problem targets, else 0), which is
``||A||`` at the ends of the spectrum and the inverted value's scale
near a shift:

* ``value_err``: the largest ``|lambda - lambda_ref|`` over its scale;
* ``residual``: the largest ``||A u - lambda B u||_2`` over its scale;
* ``orthogonality``: the largest entry of ``|U^T B U - I|``;
* ``missing_pairs``: ``nev`` less the pairs returned;
* ``not_successful``: 1 where the solver did not report success.

A number that is not finite, or one of a missing pair, reads as
``None`` and fails. A cell's limits file names the numbers it holds.
"""

import math

import numpy as np

#: The names of the numbers :func:`compare` returns.
NUMBERS = ("value_err", "residual", "orthogonality", "missing_pairs", "not_successful")


def _finite(x):
    x = float(x)
    return x if math.isfinite(x) else None


def compare(operands, ref_values, values, vectors, nconv, successful, sigma=0.0):
    """The numbers of one answer. ``operands`` holds ``A`` and
    optionally ``B``; ``values`` (k,) and ``vectors`` (n, k) are numpy
    arrays; ``ref_values`` the reference's nev values."""
    A, B = operands["A"], operands.get("B")
    nev = len(ref_values)
    values = np.asarray(values, np.float64)
    U = np.asarray(vectors, np.float64)
    k = len(values)
    out = dict(missing_pairs=max(0, nev - min(int(nconv), k)),
               not_successful=0 if successful else 1)
    if k != nev or U.shape != (A.shape[0], nev):
        out.update(value_err=None, residual=None, orthogonality=None)
        return out
    order = np.argsort(values, kind="stable")
    values, U = values[order], U[:, order]
    ref = np.sort(np.asarray(ref_values, np.float64))
    scale = np.maximum(np.abs(ref - sigma), np.finfo(np.float64).tiny)
    out["value_err"] = _finite((np.abs(values - ref) / scale).max())
    BU = U if B is None else B @ U
    R = A @ U - BU * values[None, :]
    out["residual"] = _finite((np.linalg.norm(R, axis=0) / scale).max())
    out["orthogonality"] = _finite(np.abs(U.T @ BU - np.eye(nev)).max())
    return out


def fails(numbers, limits):
    """The names of the numbers above their limits (or not finite, or
    not given)."""
    return [k for k in limits
            if numbers.get(k) is None or numbers[k] > limits[k]]
