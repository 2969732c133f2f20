"""Host batching and the host-to-device feed of the trainer: the batch
loader (the C++ host loader or its numpy path, one determinism contract)
and the pinned-memory prefetch, inline or on a feeder thread with its own
copy stream, with shard-aware placement of each rank's rows."""

from unionml_tpu_torch.data.native import BatchLoader, epoch_permutation, splitmix64
from unionml_tpu_torch.data.pipeline import (
    DeviceFeed,
    local_batches,
    prefetch_to_device,
    process_batch_slice,
)

__all__ = [
    "BatchLoader",
    "DeviceFeed",
    "epoch_permutation",
    "local_batches",
    "prefetch_to_device",
    "process_batch_slice",
    "splitmix64",
]
