"""Host batching and the host-to-device feed of the trainer: the batch
loader (the C++ host loader or its numpy path, one determinism contract)
and the pinned-memory prefetch, inline or on a feeder thread with its own
copy stream."""

from unionml_tpu_torch.data.native import BatchLoader, epoch_permutation, splitmix64
from unionml_tpu_torch.data.pipeline import prefetch_to_device

__all__ = ["BatchLoader", "epoch_permutation", "prefetch_to_device", "splitmix64"]
