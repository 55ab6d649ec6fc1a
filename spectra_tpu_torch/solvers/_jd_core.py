"""The Jacobi-Davidson iteration over fixed-width buffers.

Port of :mod:`spectra_tpu.solvers._jd_core`. The JAX package compiles
the whole iteration into one ``lax.while_loop`` over a padded basis; here
it is a host loop over the same buffers on the operator's device, step
for step the same schedule (reference loop:
include/Spectra/JDSymEigsBase.h:141-185):

* the basis V and ``W = A V`` live in (n, M2) buffers with an active
  width ``size``, where M2 is the widest point of the growth schedule
  i0, i0 + c, ...;
* when ``size > max_space`` the space collapses to the leading ``i0``
  Ritz vectors of the previous Rayleigh-Ritz; the newest c columns,
  never multiplied by A, are dropped (JDSymEigsBase.h:151-156,
  SearchSpace.h:70-74);
* the operator touches only the new columns, c an iteration
  (SearchSpace.h:57-63): the contiguous block that the extension
  produced is kept and multiplied in the next iteration unless that
  iteration restarts, one operator call a block;
* Rayleigh-Ritz on the padded (M2, M2) matrix ``P + diag(cap (1 + j))``
  over the pad, decomposed whole on the host (LAPACK through numpy, as
  the JAX package's CPU route), so that the pad's eigenvalues sort past
  the active ones. The n-length products use the active columns; the
  masked ones would add exact zeros;
* convergence on the residual column norms (RitzPairs.h:73-87);
* the extension is the correction block orthogonalized twice against
  the active columns (project, then QR; SearchSpace.h:80-85);
* the best snapshot (values, vectors and residues at the smallest
  largest residual norm) is kept, and the loop stops after ``patience``
  iterations without a 10 % improvement; the best snapshot is what is
  reported.

Over a row-sharded operator (one with a ``mesh``) the buffers hold
the rank's rows: the Rayleigh matrix and the residual norms are
all-reduced and the QR of the extension runs on the gathered block, so
every rank takes the same branches.

Status codes: 1 converged, 2 maxit or stagnation, 3 non-finite Ritz
values. The correction is a function ``correction_fn(vals_c,
residues_c, aux)`` on the device (the reference's CRTP seam).
"""

from typing import NamedTuple

import numpy as np
import torch

from spectra_tpu_torch.linalg.orthogonalization import qr_orthogonalisation
from spectra_tpu_torch.linalg.ritz_pairs import eigh_host
from spectra_tpu_torch.ops.gemv import col_norms
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.selection import SortRule, sort_target


class JDResult(NamedTuple):
    values: torch.Tensor  # (nev,) host f64
    vectors: torch.Tensor  # (n, nev) on the device
    residues: torch.Tensor  # (n, nev) on the device
    conv: torch.Tensor  # (nev,) host bool
    status: int
    niter: int
    nops: int  # operator column applications


def schedule(i0: int, c: int, max_space: int) -> list:
    """The widths the space takes before a restart: i0, i0 + c, ...,
    the first one above ``max_space`` last (the buffers' width M2)."""
    sizes = [i0]
    while sizes[-1] <= max_space:
        sizes.append(sizes[-1] + c)
    return sizes


def _gram(A, B, mesh):
    """``A^T B`` summed over the rows of every rank."""
    P = A.mT @ B
    return P if mesh is None else mesh.all_reduce(P)


def _rayleigh_ritz(V, W, size: int, selection: SortRule, mesh=None):
    """Ritz values (host) and small vectors (host, (M2, M2)) of the
    active space, sorted wanted first with the pad last."""
    with span("jd.rayleigh_ritz"):
        M2 = V.shape[1]
        P = torch.zeros((M2, M2), dtype=torch.float64)
        P[:size, :size] = _gram(V[:, :size], W[:, :size], mesh).cpu()
        P = 0.5 * (P + P.T)
        j = torch.arange(M2, dtype=torch.float64)
        pad = j >= size
        cap = 2.0 * P.abs().max() + 1.0
        with span("jd.eigh"):
            w, s = eigh_host(P + torch.diag(torch.where(pad, cap * (1.0 + j), 0.0)))
        key = torch.where(pad, torch.inf, sort_target(selection, w))
        ind = torch.argsort(key, stable=True)
        return w[ind], s[:, ind]


def _orth_extend(V, size: int, C, mesh=None):
    """C orthogonalized twice against the active columns of V (project,
    then QR), written at ``[size, size + c)`` (at ``M2 - c`` where that
    runs past the buffer, as ``dynamic_update_slice`` clamps). Returns
    the contiguous block."""
    with span("jd.orthogonalize"):
        Vs = V[:, :size]
        for _ in range(2):  # reference: Orthogonalization twice_is_enough
            C = C - Vs @ _gram(Vs, C, mesh)
            C = qr_orthogonalisation(C, mesh)
        start = min(size, V.shape[1] - C.shape[1])
        V[:, start : start + C.shape[1]] = C
        return C


def jd_compute(op, V0, aux, maxit: int, tol: float, *, max_space: int,
               i0: int, c: int, nev: int, selection: SortRule,
               correction_fn) -> JDResult:
    """Run the JD iteration from the (n, i0) orthonormal, contiguous
    initial space V0 on ``op``'s device; see the module docstring."""
    n = V0.shape[0]
    mesh = getattr(op, "mesh", None)
    sizes = schedule(i0, c, max_space)
    M2 = sizes[-1]
    dev, dtype = V0.device, V0.dtype
    V = torch.zeros((n, M2), dtype=dtype, device=dev)
    W = torch.zeros((n, M2), dtype=dtype, device=dev)
    V[:, :i0] = V0
    with span("jd.apply"):
        W[:, :i0] = op.perform_op(V0)
    vals, small = _rayleigh_ritz(V, W, i0, selection, mesh)
    # Stagnation patience: one full growth schedule (a restart can
    # unlock progress) plus slack.
    patience = 2 * len(sizes) + 6

    size = rr_size = i0
    it, nops, status, bad = 0, i0, 0, 0
    block = None  # the newest c columns, not yet multiplied by A
    best_vals = torch.zeros(nev, dtype=torch.float64)
    best_vecs = torch.zeros((n, nev), dtype=dtype, device=dev)
    best_res = torch.zeros((n, nev), dtype=dtype, device=dev)
    best_conv = torch.zeros(nev, dtype=torch.bool)
    best_resmax = np.inf
    while status == 0:
        with span("jd.iteration"):
            if size > max_space:
                with span("jd.collapse"):
                    lead = small[:rr_size, :i0].to(dev, dtype)
                    Vc, Wc = V[:, :rr_size] @ lead, W[:, :rr_size] @ lead
                    V.zero_()
                    W.zero_()
                    V[:, :i0], W[:, :i0] = Vc, Wc
                    size, block = i0, None
            elif it > 0:
                with span("jd.apply"):
                    W[:, size - c : size] = op.perform_op(block)
                nops += c

            vals, small = _rayleigh_ritz(V, W, size, selection, mesh)
            with span("jd.residual"):
                Vs, Ws = V[:, :size], W[:, :size]
                vals_d = vals.to(dev, dtype)
                lead = small[:size, :nev].to(dev, dtype)
                ritz = Vs @ lead
                resid = Ws @ lead - ritz * vals_d[None, :nev]
                norms = col_norms(resid, mesh).cpu()
                conv = norms < tol
                finite = bool(torch.isfinite(vals[:size]).all())
                it += 1
                resmax = float(norms.max())
                all_conv = bool(conv.all())
                take = finite and (resmax < best_resmax or all_conv)
                bad = 0 if finite and resmax < 0.9 * best_resmax else bad + 1
                if not finite:
                    status = 3
                elif all_conv:
                    status = 1
                elif it >= maxit or bad >= patience:
                    status = 2
                rr_size = size
                if take:
                    best_vals, best_vecs, best_res = vals[:nev], ritz, resid
                    best_conv, best_resmax = conv, resmax
            if status == 0:
                with span("jd.correction"):
                    if c <= nev:
                        ritz_c, resid_c = ritz[:, :c], resid[:, :c]
                    else:
                        lead_c = small[:size, :c].to(dev, dtype)
                        ritz_c = Vs @ lead_c
                        resid_c = Ws @ lead_c - ritz_c * vals_d[None, :c]
                    C = correction_fn(vals_d[:c], resid_c, aux).to(dtype)
                block = _orth_extend(V, size, C, mesh)
                size += c

    # The best snapshot, not the last iterate: the same when converged,
    # better when the loop stopped on maxit or stagnation.
    return JDResult(
        values=best_vals, vectors=best_vecs, residues=best_res,
        conv=best_conv, status=status, niter=it, nops=nops,
    )
