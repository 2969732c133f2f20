"""Attention, normalization and mixture-of-experts ops.

:mod:`~unionml_tpu_torch.ops.fused_norm`,
:mod:`~unionml_tpu_torch.ops.flash_attention`,
:mod:`~unionml_tpu_torch.ops.fused_attention`,
:mod:`~unionml_tpu_torch.ops.paged_attention` and
:mod:`~unionml_tpu_torch.ops.int4_matmul` wrap hand-written CUDA
kernels (``csrc/``, built by :mod:`~unionml_tpu_torch.ops._build`) beside
their plain PyTorch versions; :mod:`~unionml_tpu_torch.ops.attention`
(full-score and blockwise attention, the dispatcher) and
:mod:`~unionml_tpu_torch.ops.moe` (routing, dense and all-to-all expert
dispatch) are plain PyTorch, as their references run outside any Pallas
kernel; :mod:`~unionml_tpu_torch.ops.ring_attention` (the ring over the
flash kernels or the blockwise accumulation) and
:mod:`~unionml_tpu_torch.ops.ulysses` are sequence parallelism over the
collectives of :mod:`~unionml_tpu_torch.parallel.collectives`.
"""

# the dispatcher stays ``ops.attention.attention``: the package's
# ``attention`` name is the module (as the port's callers import it)
from unionml_tpu_torch.ops.attention import blockwise_attention, mha_reference
from unionml_tpu_torch.ops.moe import (
    MoEMlp,
    expert_capacity,
    expert_parallel_moe,
    expert_parallel_moe_sharded,
    make_dispatch,
    migrate_moe_router_params,
    top_k_routing,
)

__all__ = [
    "blockwise_attention", "mha_reference",
    "MoEMlp", "top_k_routing", "make_dispatch", "expert_capacity",
    "expert_parallel_moe", "expert_parallel_moe_sharded",
    "migrate_moe_router_params",
]
