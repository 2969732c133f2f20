"""Host batching and the host-to-device feed of the trainer: the numpy
batch loader (the reference's determinism contract) and the inline
pinned-memory prefetch."""

from unionml_tpu_torch.data.native import BatchLoader, epoch_permutation, splitmix64
from unionml_tpu_torch.data.pipeline import prefetch_to_device

__all__ = ["BatchLoader", "epoch_permutation", "prefetch_to_device", "splitmix64"]
