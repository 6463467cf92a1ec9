"""The multi-device layer of the port, over a ``torch.distributed``
``DeviceMesh`` with the dims ``("data", "model")``.  Counterpart of
``repro.distributed``:

  * the sharded and overlapped SpMM, SDDMM and attention
    (:mod:`.sparse_shard`, :mod:`.sparse_shard_overlap`, the rings of
    :mod:`.overlap`);
  * the sharded LM: the logical sharding rules (:mod:`.sharding`), the
    ambient mesh and ``constrain`` (:mod:`.ctx`), elastic resharding of
    a train state (:mod:`.elastic`) and the collective matmul
    (:mod:`.overlap`, re-exported by :mod:`.collective_matmul`).
"""

from .ctx import ACT_RULES, activation_mesh, constrain, current_mesh
from .elastic import reshard_state, reshard_tree
from .overlap import (collective_matmul, ring_allgather_matmul,
                      ring_scatter_pipeline)
from .sharding import (LOGICAL_AXIS_RULES, batch_pspec, cache_shardings,
                       fit_pspec, logical_spec_for, param_shardings,
                       placements, serving_rules, shardings_like,
                       sparse_format_shardings, sparse_operand_pspec)
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
    "ACT_RULES",
    "LOGICAL_AXIS_RULES",
    "ShardedSchedule",
    "activation_mesh",
    "batch_pspec",
    "cache_shardings",
    "collective_matmul",
    "constrain",
    "fit_pspec",
    "logical_spec_for",
    "param_shardings",
    "placements",
    "reshard_state",
    "reshard_tree",
    "ring_allgather_matmul",
    "serving_rules",
    "shardings_like",
    "sparse_format_shardings",
    "sparse_operand_pspec",
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
