"""Multi-process execution: one process per device.

Port of :mod:`spectra_tpu.distributed`. The JAX package connects one
JAX process per host and lets GSPMD route the Arnoldi ``psum`` and the
halo ``ppermute`` over the devices. The port runs one process per
device on ``torch.distributed`` (NCCL on GPUs, gloo on CPUs); every
rank runs the same solver on its own contiguous block of rows, every
reduction is one all-reduce and every remote x entry arrives by halo
exchange (:mod:`spectra_tpu_torch.parallel`).

Usage (one process per GPU, e.g. ``torchrun --nproc-per-node 4``):

    import spectra_tpu_torch.distributed as dist
    dist.initialize()                       # NCCL on cuda:<LOCAL_RANK>
    mesh = dist.global_row_mesh()
    op = ShardedEllMatProd.create(A_csr, mesh)   # halo-planned SpMV
    ...solvers as usual; eigenvectors() holds the rank's rows and
    dist.gather_rows(vecs, mesh) assembles them.

On the CPU pass ``device="cpu"`` (gloo). Nothing switches backend or
device on its own: a failed ``init_process_group`` raises.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as tdist

from spectra_tpu_torch.parallel.mesh import global_put  # noqa: F401  (re-export)
from spectra_tpu_torch.util.capabilities import resolve_device

#: The device :func:`initialize` chose for this process.
_DEVICE = None


def _local_index(local_device_ids, process_id) -> int:
    if local_device_ids is not None:
        ids = np.atleast_1d(local_device_ids)
        return int(ids[0])
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    return int(rank) % max(1, torch.cuda.device_count())


def initialize(
    init_method=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
    device=None,
    backend=None,
):
    """Join this process to the process group.

    ``init_method`` defaults to ``"env://"`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets
    them); ``num_processes`` and ``process_id`` override the world size
    and rank. ``device=None`` means the GPU ``local_device_ids`` names
    (default: ``LOCAL_RANK``, else the rank modulo the GPUs), with the
    NCCL backend; ``device="cpu"`` means gloo. ``backend`` overrides the
    backend (``"gloo"`` for several ranks on one GPU).
    """
    global _DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_index(local_device_ids, process_id))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    tdist.init_process_group(backend, init_method=init_method or "env://", **kwargs)
    _DEVICE = dev


def process_device(device=None) -> torch.device:
    """This process's device: ``device`` when given (``"cuda"`` meaning
    the local rank's GPU), else the one :func:`initialize` chose, else
    the local rank's GPU."""
    if device is None and _DEVICE is not None:
        return _DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_index(None, None))
    return dev


def global_row_mesh(axis: str = "rows"):
    """A 1-D row mesh over every rank of the process group."""
    from spectra_tpu_torch.parallel.mesh import row_mesh

    mesh = row_mesh()
    return mesh if axis == mesh.axis else dataclasses.replace(mesh, axis=axis)


def replicated_to_numpy(arr) -> np.ndarray:
    """A replicated tensor (identical on every rank) as host numpy."""
    return arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)


def gather_rows(local, mesh):
    """The global vector or block whose row blocks are every rank's
    ``local`` (e.g. ``eigenvectors()``), on every rank."""
    return mesh.all_gather(local)
