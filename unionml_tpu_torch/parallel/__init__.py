"""Parallelism layer on ``torch.distributed``: meshes, sharding strategies,
collectives.

The port of :mod:`unionml_tpu.parallel`. Strategies compose as named
dimensions of one :class:`~torch.distributed.device_mesh.DeviceMesh` (one
rank per device; NCCL on the card, gloo on the CPU); params and batches
are DTensors placed by the reference's partition rules, and the step runs
eagerly with DTensor inserting the collectives GSPMD inserts there.

- :mod:`unionml_tpu_torch.parallel.mesh` — mesh construction (with
  host-spanning ``dcn_axes``), process-group bring-up.
- :mod:`unionml_tpu_torch.parallel.sharding` — :class:`ShardingConfig`,
  partition rules, ``compile_step``.
- :mod:`unionml_tpu_torch.parallel.compat` — ``shard_map`` (local shards,
  axes bound) and the kernel boundary (``local_call``).
- :mod:`unionml_tpu_torch.parallel.collectives` — named collectives
  (differentiable: a rotation, an all-to-all and a psum each go back as
  their transpose) and the bucketed gradient all-reduce.
- :mod:`unionml_tpu_torch.parallel.pipeline` — the GPipe schedule
  (``pipeline_apply``, ``pipeline_spmd``, ``stack_stage_params``).
"""

from unionml_tpu_torch.parallel.collectives import bucketed_psum
from unionml_tpu_torch.parallel.compat import shard_map
from unionml_tpu_torch.parallel.mesh import (
    cpu_multiprocess_supported,
    make_mesh,
    mesh_devices,
    multihost_initialize,
)
from unionml_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_spmd,
    stack_stage_params,
)
from unionml_tpu_torch.parallel.sharding import (
    PartitionRule,
    ShardingConfig,
    compile_step,
    named_sharding,
    shard_pytree,
    state_shardings,
)

__all__ = [
    "bucketed_psum",
    "pipeline_apply",
    "pipeline_spmd",
    "stack_stage_params",
    "cpu_multiprocess_supported",
    "shard_map",
    "make_mesh",
    "mesh_devices",
    "multihost_initialize",
    "PartitionRule",
    "ShardingConfig",
    "compile_step",
    "named_sharding",
    "shard_pytree",
    "state_shardings",
]
