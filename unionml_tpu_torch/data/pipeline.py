"""The host-to-device feed of the trainer.

The port of the inline form of :func:`unionml_tpu.data.pipeline
.prefetch_to_device`: ``buffer_size`` batches are kept in flight. For a
CUDA target each host array is staged in pinned memory and copied with
``non_blocking=True``, so the copy of batch N+1 overlaps the step on batch
N (PyTorch's pinned-memory allocator keeps a staging buffer alive until
its copy has run). The threaded ``double_buffer`` feed and sharded
placement are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device


def _put(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_put(v, device) for v in x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(
    iterator: Iterable[Any],
    *,
    buffer_size: int = 2,
    device: DeviceLike = None,
    sharding: Any = None,
    double_buffer: bool = False,
) -> Iterator[Any]:
    """Yield the items of ``iterator`` (trees of numpy arrays or tensors)
    as tensors on ``device`` (``None`` = CUDA), ``buffer_size`` copies in
    flight."""
    if sharding is not None:
        raise NotImplementedError(
            "sharded batch placement needs the parallelism port (ROADMAP.md, A11)"
        )
    if double_buffer:
        raise NotImplementedError(
            "the threaded double_buffer feed is not ported yet (ROADMAP.md)"
        )
    dev = resolve_device(device)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    queue.extend(_put(item, dev) for item in itertools.islice(it, buffer_size))
    while queue:
        yield queue.popleft()
        queue.extend(_put(item, dev) for item in itertools.islice(it, 1))
