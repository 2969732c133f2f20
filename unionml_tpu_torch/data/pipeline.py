"""The host-to-device feed of the trainer.

The port of :func:`unionml_tpu.data.pipeline.prefetch_to_device`:
``buffer_size`` batches are kept in flight. For a CUDA target each host
array is staged in pinned memory and copied with ``non_blocking=True``
(PyTorch's pinned-memory allocator keeps a staging buffer alive until its
copy has run).

The inline feed pulls, pins and enqueues each copy on the step loop's
thread. ``double_buffer=True`` moves all of that onto a feeder thread with
a copy stream of its own: the copies overlap the step's kernels instead
of queueing behind them on the consumer's stream, an event recorded after
each batch's copies orders the consumer's stream after them, and each
yielded tensor is marked as used on the consumer's stream
(``record_stream``) so the caching allocator never hands its memory to a
later copy while the step still reads it. Sharded placement waits for
the parallelism port (ROADMAP.md, A6).
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device

_EXHAUSTED = object()  # next(it) default at the end of the source


def _put(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _put(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_put(v, device) for v in x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _cuda_leaves(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _cuda_leaves(v)
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        yield x


def prefetch_to_device(
    iterator: Iterable[Any],
    *,
    buffer_size: int = 2,
    device: DeviceLike = None,
    sharding: Any = None,
    goodput: Any = None,
    double_buffer: bool = False,
) -> Iterator[Any]:
    """Yield the items of ``iterator`` (trees of numpy arrays or tensors)
    as tensors on ``device`` (``None`` = CUDA), ``buffer_size`` copies in
    flight.

    ``goodput`` (a :class:`~unionml_tpu_torch.goodput.GoodputTracker`, or
    any object with a ``phase(name)`` context manager) attributes the
    feed's wall time: inline, pulling the source lands in ``data_wait``
    and the pin and copy enqueue in ``host_to_device``.

    ``double_buffer=True`` runs the feed on a background thread (a copy
    stream of its own on CUDA). The batch order is the inline feed's,
    every yielded tensor is fresh, a raising source re-raises at the
    consumer, and an abandoned generator stops its feeder. Only the
    consumer's wait for a ready batch, its hand-off from the copy stream
    included, lands in ``data_wait``; the feeder's work overlaps the step,
    so ``host_to_device`` stays 0.
    """
    if sharding is not None:
        raise NotImplementedError(
            "sharded batch placement needs the parallelism port (ROADMAP.md, A6)"
        )
    dev = resolve_device(device)
    if double_buffer:
        return _threaded_prefetch(iterator, buffer_size=max(2, buffer_size), device=dev,
                                  goodput=goodput)
    return _inline_prefetch(iterator, buffer_size=buffer_size, device=dev, goodput=goodput)


def _inline_prefetch(iterator: Iterable[Any], *, buffer_size: int, device: torch.device,
                     goodput: Any) -> Iterator[Any]:
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def enqueue(k: int) -> None:
        for _ in range(k):
            if goodput is None:
                item = next(it, _EXHAUSTED)
            else:
                with goodput.phase("data_wait"):
                    item = next(it, _EXHAUSTED)
            if item is _EXHAUSTED:
                return
            if goodput is None:
                queue.append(_put(item, device))
            else:
                with goodput.phase("host_to_device"):
                    queue.append(_put(item, device))

    enqueue(buffer_size)
    while queue:
        yield queue.popleft()
        enqueue(1)


class _FeedError:
    """A failure of the feeder, re-raised at the consumer's next pull so a
    raising source behaves as in the inline feed."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _threaded_prefetch(iterator: Iterable[Any], *, buffer_size: int, device: torch.device,
                       goodput: Any) -> Iterator[Any]:
    copy_stream: Optional[torch.cuda.Stream] = (
        torch.cuda.Stream(device) if device.type == "cuda" else None
    )
    q: queue_mod.Queue = queue_mod.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def offer(item: Any) -> bool:
        # a bounded put that notices an abandoned consumer: the feeder must
        # never stay blocked (holding device batches) until process exit
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False

    def place(item: Any):
        if copy_stream is None:
            return _put(item, device), None
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            out = _put(item, device)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def producer() -> None:
        try:
            for item in iterator:
                if not offer(place(item)):
                    return
            offer(_EXHAUSTED)
        except BaseException as exc:  # re-raised at the consumer
            offer(_FeedError(exc))

    def take() -> Any:
        item = q.get()
        if item is _EXHAUSTED or isinstance(item, _FeedError):
            return item
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in _cuda_leaves(batch):
                # allocated on the copy stream, read on the consumer's
                t.record_stream(consumer)
        return batch

    thread = threading.Thread(target=producer, name="prefetch-feed", daemon=True)
    thread.start()
    try:
        while True:
            if goodput is None:
                item = take()
            else:
                # only the consumer's wait is badput: the feeder fell behind,
                # or holds the interpreter lock when the hand-off returns
                # (the event wait releases it, and the feeder, woken by the
                # freed slot, takes it for its next batch's host work)
                with goodput.phase("data_wait"):
                    item = take()
            if item is _EXHAUSTED:
                return
            if isinstance(item, _FeedError):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)
