"""Checkpoint I/O telemetry, shared by pytree_io and async_writer.

The port of :mod:`unionml_tpu.checkpoint._metrics`, with the same series:
every save/restore publishes ``unionml_checkpoint_{save,restore}_ms{kind}``
histograms (the wall time the CALLER stalled — for the async manager the
wait for the previous commit plus the device-to-host snapshot, exactly
the piece that lands in the training loop's ``checkpoint`` badput bucket)
and ``unionml_checkpoint_{save,restore}_bytes_total{kind}`` counters
(``kind="pytree"`` for the single-file artifact, ``kind="async"`` for the
background commit writer). The async writer's background leg has its own
series — ``unionml_checkpoint_commit_ms{kind}`` (serialize + write +
atomic rename, off the loop) and the ``unionml_checkpoint_pending`` gauge
(launched commits not yet durable).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from unionml_tpu_torch import telemetry


def checkpoint_metrics(
    registry: Optional[telemetry.MetricsRegistry] = None,
) -> dict:
    """The checkpoint I/O families on ``registry`` (default: the
    process-global one), keyed ``save_ms`` / ``restore_ms`` /
    ``save_bytes`` / ``restore_bytes`` / ``commit_ms`` / ``pending``."""
    reg = registry if registry is not None else telemetry.get_registry()
    return {
        "save_ms": reg.histogram(
            "unionml_checkpoint_save_ms",
            "Caller-visible checkpoint save stall (async managers: wait "
            "for the previous commit + device->host snapshot/launch; the "
            "background disk leg is unionml_checkpoint_commit_ms).",
            ("kind",),
        ),
        "commit_ms": reg.histogram(
            "unionml_checkpoint_commit_ms",
            "Background commit leg of an async save: serialize + write + "
            "atomic rename, overlapped with training steps.",
            ("kind",),
        ),
        "pending": reg.gauge(
            "unionml_checkpoint_pending",
            "Launched async checkpoint commits not yet durable (a crash "
            "now loses only these; the previous commit stays restorable).",
        ),
        "restore_ms": reg.histogram(
            "unionml_checkpoint_restore_ms",
            "Checkpoint restore wall time.",
            ("kind",),
        ),
        "save_bytes": reg.counter(
            "unionml_checkpoint_save_bytes_total",
            "Bytes written to checkpoints (leaf bytes for async saves; "
            "serialized artifact bytes for pytree saves).",
            ("kind",),
        ),
        "restore_bytes": reg.counter(
            "unionml_checkpoint_restore_bytes_total",
            "Bytes restored from checkpoints.",
            ("kind",),
        ),
    }


def tree_nbytes(tree: Any) -> int:
    """Total tensor bytes of a tree (nested dicts / lists / tuples, on any
    device); leaves that are not tensors count 0."""
    from unionml_tpu_torch.models.train import tree_leaves

    return sum(leaf.nbytes for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor))
