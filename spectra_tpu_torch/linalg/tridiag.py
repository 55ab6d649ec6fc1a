"""Shifted QR sweep and eigendecomposition of symmetric tridiagonal matrices.

Port of :mod:`spectra_tpu.linalg.tridiag`. These are the replicated
(ncv, ncv) pieces of the implicitly restarted Lanczos method. The port
runs them on the host in f64: CPU tensors in and out, and the
sequential sweeps as Python loops over floats (O(ncv) tiny dependent
steps, whose cost is latency). Semantics are rule-for-rule those of the
reference (include/Spectra/LinAlg/UpperHessenbergQR.h:459-709):

  * small subdiagonal entries are deflated to zero before the sweep
    when |e_i| <= eps * (|d_i| + |d_{i+1}|);
  * Q^T T Q is applied analytically to (diag, subdiag), so symmetry
    and tridiagonal form are exact;
  * the result is re-deflated with the same criterion.

The eigendecomposition is ``torch.linalg.eigh`` on the dense
embedding, as the JAX package routes it off the TPU
(``spectra_tpu/linalg/jacobi.py:157-169``).
"""

import torch

from spectra_tpu_torch.linalg.givens import givens_rotation


def _host(t):
    return torch.as_tensor(t, dtype=torch.float64)


def deflate_subdiag(diag, subdiag):
    """Zero out negligibly small subdiagonal entries."""
    eps = torch.finfo(diag.dtype).eps
    thresh = eps * (diag[:-1].abs() + diag[1:].abs())
    return torch.where(subdiag.abs() <= thresh, 0.0, subdiag)


def tridiag_qr(diag, subdiag, shift: float):
    """Givens rotations of the QR decomposition ``T - shift*I = QR``.

    Args:
      diag: (m,) diagonal of symmetric tridiagonal T.
      subdiag: (m-1,) subdiagonal of T.
      shift: scalar shift.

    Returns:
      (c, s, subdiag_deflated): rotation cosines/sines, each (m-1,), and
      the deflated subdiagonal actually used (needed by ``tridiag_qtq``).
    """
    e = deflate_subdiag(diag, subdiag)
    d = (diag - shift).tolist()
    el = e.tolist() + [0.0]
    # (rd, rs) = R[i, i] and R[i, i+1] entering step i; R[i+1, i] is
    # the untouched deflated subdiagonal e[i].
    rd, rs = d[0], el[0]
    c, s = [], []
    for i in range(len(d) - 1):
        ci, si, _ = givens_rotation(rd, el[i])
        rd, rs = si * rs + ci * d[i + 1], ci * el[i + 1]
        c.append(ci)
        s.append(si)
    return _host(c), _host(s), e


def tridiag_qtq(diag, subdiag_deflated, c, s):
    """Apply ``T -> Q^T T Q`` analytically on (diag, subdiag).

    ``subdiag_deflated`` must be the deflated subdiagonal returned by
    ``tridiag_qr``. Returns the new (diag, subdiag), re-deflated.
    """
    d = diag.tolist()
    e = subdiag_deflated.tolist()
    cl, sl = c.tolist(), s.tolist()
    m = len(d)
    # Each step rotates rows/cols (i, i+1) of the evolving matrix:
    #   x' = c^2 x - 2csy + s^2 z        (new diag[i])
    #   y' = cs(x - z) + (c^2 - s^2) y   (new subdiag[i], pre-correction)
    #   z' = s^2 x + 2csy + c^2 z        (carried as next x)
    # and the next rotation folds the fill-in o = -s*e[i+1] back into
    # y'' = c_{i+1} y' - s_{i+1} o; w' = c*e[i+1] is carried as next y.
    x, y = d[0], e[0]
    new_d, new_e = [], []
    for i in range(m - 1):
        c_i, s_i, z = cl[i], sl[i], d[i + 1]
        cn, sn = (cl[i + 1], sl[i + 1]) if i + 1 < m - 1 else (1.0, 0.0)
        en = e[i + 1] if i + 1 < m - 1 else 0.0
        cs = c_i * s_i
        c2 = c_i * c_i
        s2 = s_i * s_i
        xp = c2 * x - 2.0 * cs * y + s2 * z
        yp = cs * (x - z) + (c2 - s2) * y
        zp = s2 * x + 2.0 * cs * y + c2 * z
        o = -s_i * en
        new_d.append(xp)
        new_e.append(cn * yp - sn * o)
        x, y = zp, c_i * en
    new_diag = _host(new_d + [x])
    return new_diag, deflate_subdiag(new_diag, _host(new_e))


def apply_yq(Y, c, s):
    """Right-multiply ``Y`` by ``Q = G_0 G_1 ... G_{m-2}`` in order.

    Each rotation combines columns (i, i+1):
      new_col_i   = c*Y_i - s*Y_{i+1}
      new_col_i+1 = s*Y_i + c*Y_{i+1}
    (reference: UpperHessenbergQR.h:383-417, apply_YQ). Returns a new
    tensor.
    """
    Y = Y.clone()
    for i, (c_i, s_i) in enumerate(zip(c.tolist(), s.tolist())):
        a = Y[:, i].clone()
        b = Y[:, i + 1]
        Y[:, i] = c_i * a - s_i * b
        Y[:, i + 1] = s_i * a + c_i * b
    return Y


def tridiag_to_dense(diag, subdiag):
    return (
        torch.diag(diag)
        + torch.diag(subdiag, -1)
        + torch.diag(subdiag, 1)
    )


def tridiag_eigen(diag, subdiag):
    """Full eigendecomposition of a symmetric tridiagonal matrix:
    (eigenvalues ascending, eigenvectors as columns)."""
    return torch.linalg.eigh(tridiag_to_dense(diag, subdiag))
