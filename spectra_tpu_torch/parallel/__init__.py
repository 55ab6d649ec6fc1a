"""The multi-device layer: row-partitioned solves over torch.distributed.

Port of :mod:`spectra_tpu.parallel`. The sparse matrix and every
n-length Krylov vector are row-partitioned over a 1-D mesh of ranks,
one process per device (NCCL on GPUs, gloo on CPUs); the small
replicated problem stays identical on every rank. The communication is

* the reductions of the inner products: one all-reduce each
  (:class:`~spectra_tpu_torch.matop.arnoldi_op.ArnoldiOp` on an
  operator that carries a ``mesh``), and
* the remote x entries each SpMV's rows reference: a halo exchange of
  ring neighbours for stencils (:mod:`.stencil_spmv`), one message per
  signed shard distance for general sparsity (:mod:`.halo_spmv`), or
  the all-gather that GSPMD's lowering makes (:func:`shard_operator`).

The JAX package gets these collectives from GSPMD; here they are
explicit (:class:`RowMesh`).
"""

from spectra_tpu_torch.parallel.halo_spmv import (
    HaloPlan,
    ShardedEllMatProd,
    plan_halo_partition,
)
from spectra_tpu_torch.parallel.mesh import (
    RowMesh,
    RowShardedMatProd,
    partition_report,
    replicated,
    row_mesh,
    row_sharded,
    shard_operator,
    shard_problem,
)
from spectra_tpu_torch.parallel.stencil_spmv import (
    ShardedStencilHiLoMatProd,
    ShardedStencilMatProd,
    sharded_stencil_op,
    sharded_stencil_shift_solve,
)

__all__ = [
    "partition_report",
    "row_mesh",
    "row_sharded",
    "replicated",
    "shard_operator",
    "shard_problem",
    "RowMesh",
    "RowShardedMatProd",
    "ShardedStencilHiLoMatProd",
    "ShardedStencilMatProd",
    "sharded_stencil_op",
    "sharded_stencil_shift_solve",
    "ShardedEllMatProd",
    "HaloPlan",
    "plan_halo_partition",
]
