"""The Jacobi-Davidson iteration of the port.

Port of the JAX package's JD loops (:mod:`spectra_tpu.solvers._jd_core`
and the host loop of :mod:`spectra_tpu.solvers.jd_sym_eigs`): one host
loop over buffers on the operator's device (reference loop:
include/Spectra/JDSymEigsBase.h:141-185):

* the basis V and ``W = A V`` live in (n, M2) buffers with an active
  width ``size``, from the initial space's width k up by c an iteration;
  M2 = max(max_space, i0, k) + c is the widest it grows before a
  collapse. Only the active columns are ever read, so the buffers are
  not cleared;
* when ``size > max_space`` the space collapses to the leading ``i0``
  Ritz vectors of the previous Rayleigh-Ritz; the newest c columns,
  never multiplied by A, are dropped (JDSymEigsBase.h:151-156 and
  the reference search space's ``restart``);
* the operator touches only the new columns, c an iteration (the
  reference search space's ``update_operator_basis_product``): the
  contiguous block that the extension produced is kept and multiplied
  in the next iteration unless that iteration restarts, one operator
  call a block;
* Rayleigh-Ritz on the active (size, size) matrix ``V^T W``,
  symmetrized and decomposed on the host (:func:`eigh_host`), the pairs
  sorted wanted first by :func:`argsort` (``BothEnds`` interleaves the
  active values);
* convergence on the residual column norms (RitzPairs.h:73-87);
* the extension is the correction block orthogonalized twice against
  the active columns (project, then QR: the reference search space's
  ``extend_basis``), appended at ``[size, size + c)``;
* the best snapshot (values, vectors and residues at the smallest
  largest residual norm) is kept, and the loop stops after ``patience``
  iterations without a 10 % improvement; the best snapshot is what is
  reported.

Over a row-sharded operator (one with a ``mesh``) the buffers hold
the rank's rows: the Rayleigh matrix and the residual norms are
all-reduced and the QR of the extension runs on the gathered block, so
every rank takes the same branches.

Status codes: 1 converged, 2 maxit or stagnation, 3 non-finite Ritz
values. The correction is a function ``correction_fn(pairs)`` of the
leading c Ritz pairs (a :class:`RitzPairs` on the device) that returns
the correction block (the reference's CRTP seam).
"""

from typing import NamedTuple

import numpy as np
import torch

from spectra_tpu_torch.linalg.orthogonalization import qr_orthogonalisation
from spectra_tpu_torch.linalg.ritz_pairs import RitzPairs, eigh_host
from spectra_tpu_torch.ops.gemv import col_norms
from spectra_tpu_torch.util.profiling import span
from spectra_tpu_torch.util.selection import SortRule, argsort


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
    the first one above ``max_space`` last; its length sets the
    stagnation patience."""
    if c < 1:
        raise ValueError(f"correction size {c}: the search space must grow")
    sizes = [i0]
    while sizes[-1] <= max_space:
        sizes.append(sizes[-1] + c)
    return sizes


def _gram(A, B, mesh):
    """``A^T B`` summed over the rows of every rank."""
    P = A.mT @ B
    return P if mesh is None else mesh.all_reduce(P)


def _rayleigh_ritz(V, W, size: int, selection: SortRule, mesh=None):
    """Ritz values (host) and small vectors (host, (size, size)) of the
    active space, sorted wanted first."""
    with span("jd.rayleigh_ritz"):
        P = _gram(V[:, :size], W[:, :size], mesh).cpu()
        P = 0.5 * (P + P.T)
        with span("jd.eigh"):
            w, s = eigh_host(P)
        ind = argsort(selection, w)
        return w[ind], s[:, ind]


def _orth_extend(V, size: int, C, mesh=None):
    """C orthogonalized twice against the active columns of V (project,
    then QR), written at ``[size, size + c)``. Returns the contiguous
    block."""
    with span("jd.orthogonalize"):
        Vs = V[:, :size]
        for _ in range(2):  # reference: Orthogonalization twice_is_enough
            C = C - Vs @ _gram(Vs, C, mesh)
            C = qr_orthogonalisation(C, mesh)
        V[:, size : size + C.shape[1]] = C
        return C


def jd_compute(op, V0, maxit: int, tol: float, *, max_space: int,
               i0: int, c: int, nev: int, selection: SortRule,
               correction_fn) -> JDResult:
    """Run the JD iteration from the (n, k) orthonormal, contiguous
    initial space V0 on ``op``'s device; see the module docstring."""
    n, k = V0.shape
    mesh = getattr(op, "mesh", None)
    M2 = max(max_space, i0, k) + c
    dev, dtype = V0.device, V0.dtype
    V = torch.empty((n, M2), dtype=dtype, device=dev)
    W = torch.empty((n, M2), dtype=dtype, device=dev)
    V[:, :k] = V0
    with span("jd.apply"):
        W[:, :k] = op.perform_op(V0)
    vals, small = _rayleigh_ritz(V, W, k, selection, mesh)
    # Stagnation patience: one full growth schedule (a restart can
    # unlock progress) plus slack.
    patience = 2 * len(schedule(i0, c, max_space)) + 6

    size = rr_size = k
    it, nops, status, bad = 0, k, 0, 0
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
                    lead = small[:, :i0].to(dev, dtype)
                    Vc, Wc = V[:, :rr_size] @ lead, W[:, :rr_size] @ lead
                    V[:, :i0], W[:, :i0] = Vc, Wc
                    size, block = i0, None
            elif it > 0:
                with span("jd.apply"):
                    W[:, size - block.shape[1] : size] = op.perform_op(block)
                nops += block.shape[1]

            vals, small = _rayleigh_ritz(V, W, size, selection, mesh)
            with span("jd.residual"):
                Vs, Ws = V[:, :size], W[:, :size]
                vals_d = vals.to(dev, dtype)
                lead = small[:, :nev].to(dev, dtype)
                ritz = Vs @ lead
                resid = Ws @ lead - ritz * vals_d[None, :nev]
                norms = col_norms(resid, mesh).cpu()
                conv = norms < tol
                finite = bool(torch.isfinite(vals).all())
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
                        lead_c = small[:, :c].to(dev, dtype)
                        ritz_c = Vs @ lead_c
                        resid_c = Ws @ lead_c - ritz_c * vals_d[None, :c]
                    C = correction_fn(RitzPairs(
                        values=vals_d[:c], vectors=ritz_c, residues=resid_c,
                    )).to(dtype)
                block = _orth_extend(V, size, C, mesh)
                size += block.shape[1]

    # The best snapshot, not the last iterate: the same when converged,
    # better when the loop stopped on maxit or stagnation.
    return JDResult(
        values=best_vals, vectors=best_vecs, residues=best_res,
        conv=best_conv, status=status, niter=it, nops=nops,
    )
