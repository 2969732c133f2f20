"""Checkpoints: single-file state artifacts and async step checkpoints.

The port of :mod:`unionml_tpu.checkpoint`:

- :func:`save_pytree` / :func:`load_pytree` — a single-file artifact of a
  state's tensors and numbers plus its hyperparameters, in the port's own
  :func:`torch.save` format (read with ``weights_only=True``);
- :mod:`unionml_tpu_torch.checkpoint.async_writer` — ``save`` stalls the
  caller for the device-to-host snapshot's enqueue only; the wait for the
  copies, the write and the commit run on a background thread with an
  atomic rename and a commit marker, so a kill mid-commit always leaves
  the previous checkpoint restorable (:func:`make_checkpoint_manager`);
- :mod:`unionml_tpu_torch.checkpoint.sharded` — sharded checkpoints of a
  placed state, each rank writing its blocks, restored onto any target
  placements (the reference's Orbax backend, in the port's own format).

The reference's ``registry`` module is not ported.
"""

from unionml_tpu_torch.checkpoint.async_writer import (
    AsyncCheckpointManager,
    AsyncCheckpointWriter,
    make_checkpoint_manager,
)
from unionml_tpu_torch.checkpoint.pytree_io import load_pytree, save_pytree
from unionml_tpu_torch.checkpoint.sharded import CheckpointManager, restore_sharded, save_sharded

__all__ = [
    "AsyncCheckpointManager",
    "AsyncCheckpointWriter",
    "CheckpointManager",
    "load_pytree",
    "make_checkpoint_manager",
    "restore_sharded",
    "save_pytree",
    "save_sharded",
]
