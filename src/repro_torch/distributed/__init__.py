"""The multi-device layer of the port: sharded and overlapped SpMM,
SDDMM and attention over a ``torch.distributed`` ``DeviceMesh``
(:mod:`.sparse_shard`, :mod:`.sparse_shard_overlap`, the ring of
:mod:`.overlap`), and the ambient mesh (:mod:`.ctx`).  Counterpart of
``repro.distributed``'s sparse half."""

from .ctx import activation_mesh, current_mesh
from .overlap import ring_scatter_pipeline
from .sparse_shard import (ShardedSchedule, attention_sharded,
                           attention_sharded_local, batch_costs,
                           device_balance, partition_schedule,
                           segment_costs, sddmm_sharded, sddmm_sharded_local,
                           sharded_schedule, spmm_sharded,
                           spmm_sharded_local)
from .sparse_shard_overlap import (attention_sharded_overlap,
                                   sddmm_sharded_overlap,
                                   spmm_sharded_overlap)

__all__ = [
    "ShardedSchedule",
    "activation_mesh",
    "attention_sharded",
    "attention_sharded_local",
    "attention_sharded_overlap",
    "batch_costs",
    "current_mesh",
    "device_balance",
    "partition_schedule",
    "ring_scatter_pipeline",
    "sddmm_sharded",
    "sddmm_sharded_local",
    "sddmm_sharded_overlap",
    "segment_costs",
    "sharded_schedule",
    "spmm_sharded",
    "spmm_sharded_local",
    "spmm_sharded_overlap",
]
