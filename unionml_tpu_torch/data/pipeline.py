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
later copy while the step still reads it.

Under a :class:`~unionml_tpu_torch.parallel.ShardingConfig` each batch
lands as DTensors with the batch sharding (:class:`DeviceFeed`). With
several ranks, each feeds ONLY the rows it owns: the iterator yields
rank-local rows (:func:`local_batches` cuts a global-batch source down to
:func:`process_batch_slice`), and the global batch is assembled from
every rank's block by ``DTensor.from_local``; no rank holds it whole.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.parallel.compat import is_dtensor

_EXHAUSTED = object()  # next(it) default at the end of the source


def _batch_sharding(sharding: Any) -> Any:
    """A ShardingConfig's batch sharding, or a NamedSharding as given."""
    return sharding.batch_sharding() if hasattr(sharding, "batch_sharding") else sharding


def _batch_dim(sharding: Any) -> int:
    """The tensor dim the batch sharding splits (its first named entry;
    dim 1 for a microbatched ``[n_micro, batch, ...]`` spec)."""
    for d, entry in enumerate(tuple(sharding.spec)):
        if entry is not None:
            return d
    return 0


def process_batch_slice(sharding: Any, global_batch: int) -> slice:
    """The half-open row range of a global batch of ``global_batch`` rows
    that THIS rank feeds under ``sharding`` (a ShardingConfig or its
    batch NamedSharding): the block of the batch dim the rank's mesh
    coordinate owns, the whole range where the spec replicates it. Raises
    when the rank owns no rows."""
    from unionml_tpu_torch.parallel.sharding import local_slices

    sharding = _batch_sharding(sharding)
    dim = _batch_dim(sharding)
    shape = [1] * (dim + 1)
    shape[dim] = int(global_batch)
    rows = local_slices(shape, sharding.mesh, sharding.placements(dim + 1))[dim]
    if rows.stop <= rows.start:
        raise ValueError(
            "this rank owns no rows of the batch sharding: the global batch "
            f"({global_batch} rows) is smaller than its shard count"
        )
    return rows


class DeviceFeed:
    """Shard-aware device placement for host batches.

    Without a sharding, ``put`` copies a batch onto ``device``. With one,
    ``put`` receives THIS rank's rows (all of them in one process; see
    :func:`process_batch_slice`) and returns DTensors under the batch
    sharding, each assembled from every rank's block with
    ``DTensor.from_local``: the global batch is never materialised."""

    def __init__(self, sharding: Any = None, device: DeviceLike = None):
        self._sharding = _batch_sharding(sharding) if sharding is not None else None
        if self._sharding is not None:
            from unionml_tpu_torch.parallel.sharding import _mesh_device

            self._device = _mesh_device(self._sharding.mesh)
        else:
            self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def put(self, batch: Any) -> Any:
        local = _put(batch, self._device)
        if self._sharding is None:
            return local
        from torch.distributed.tensor import DTensor, Shard

        from unionml_tpu_torch.parallel.sharding import _contiguous_stride

        sharding = self._sharding
        mesh = sharding.mesh

        def assemble(t):
            if not isinstance(t, torch.Tensor) or is_dtensor(t):
                return t
            placements = sharding.placements(t.dim())
            shape = list(t.shape)
            for i, p in enumerate(placements):
                if isinstance(p, Shard):
                    shape[p.dim] *= mesh.size(i)
            return DTensor.from_local(t, mesh, placements, run_check=False,
                                      shape=torch.Size(shape), stride=_contiguous_stride(shape))

        from unionml_tpu_torch.models.train import tree_map

        return tree_map(assemble, local)


def local_batches(iterator: Iterable[Any], sharding: Any, global_batch: int) -> Iterator[Any]:
    """Cut an iterator of GLOBAL batches down to this rank's rows, for
    sources that produce the same global batch on every rank (seeded
    synthetic data, a shared file). Sources that can seek should read
    only their :func:`process_batch_slice` instead."""
    sharding = _batch_sharding(sharding)
    rows = process_batch_slice(sharding, global_batch)
    dim = _batch_dim(sharding)
    index = (slice(None),) * dim + (rows,)
    from unionml_tpu_torch.models.train import tree_map

    for batch in iterator:
        yield tree_map(lambda x: x[index], batch)


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
    elif is_dtensor(x):
        yield from _cuda_leaves(x.to_local())
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
    flight. With ``sharding`` (a ShardingConfig or a batch sharding) the
    items are this rank's rows and come out as DTensors on the mesh's
    device (:class:`DeviceFeed`; ``device`` is then unused).

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
    feed = DeviceFeed(sharding=sharding, device=device)
    if double_buffer:
        return _threaded_prefetch(iterator, buffer_size=max(2, buffer_size), feed=feed,
                                  goodput=goodput)
    return _inline_prefetch(iterator, buffer_size=buffer_size, feed=feed, goodput=goodput)


def _inline_prefetch(iterator: Iterable[Any], *, buffer_size: int, feed: DeviceFeed,
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
                queue.append(feed.put(item))
            else:
                with goodput.phase("host_to_device"):
                    queue.append(feed.put(item))

    enqueue(buffer_size)
    while queue:
        yield queue.popleft()
        enqueue(1)


class _FeedError:
    """A failure of the feeder, re-raised at the consumer's next pull so a
    raising source behaves as in the inline feed."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _threaded_prefetch(iterator: Iterable[Any], *, buffer_size: int, feed: DeviceFeed,
                       goodput: Any) -> Iterator[Any]:
    device = feed.device
    copy_stream: Optional[torch.cuda.Stream] = None
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
            return feed.put(item), None
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            out = feed.put(item)
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

    def start_and_take() -> Any:
        # the feed's start-up (its copy stream, its thread) is part of the
        # wait for the first batch
        nonlocal copy_stream
        if device.type == "cuda":
            copy_stream = torch.cuda.Stream(device)
        thread.start()
        return take()

    pull = start_and_take
    try:
        while True:
            if goodput is None:
                item = pull()
            else:
                # only the consumer's wait is badput: the feeder fell behind,
                # or holds the interpreter lock when the hand-off returns
                # (the event wait releases it, and the feeder, woken by the
                # freed slot, takes it for its next batch's host work)
                with goodput.phase("data_wait"):
                    item = pull()
            pull = take
            if item is _EXHAUSTED:
                return
            if isinstance(item, _FeedError):
                raise item.exc
            yield item
    finally:
        stop.set()
        if thread.ident is not None:
            thread.join(timeout=5.0)
