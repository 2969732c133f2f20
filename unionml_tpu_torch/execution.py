"""The synthesized trainer loop around a per-batch step.

The port of :mod:`unionml_tpu.execution`'s plain route:
:func:`run_step_trainer` drives ``step(state, batch) -> (state, metrics)``
over epochs of static-shape batches (remainders dropped), fed from the
deterministic :class:`~unionml_tpu_torch.data.native.BatchLoader` (the C++
host loader, or its numpy path; or from a stream) through
:func:`~unionml_tpu_torch.data.pipeline.prefetch_to_device`, inline or on
a feeder thread with its own copy stream (``double_buffer=True``), onto
the device of the state's params. PyTorch runs eagerly, so there is no
compile step: each step enqueues its kernels and returns; a window
boundary (or ``measure_device_time``) waits for the card. The loop
publishes the ``unionml_trainer_*`` metric families into the port's
telemetry registry, and with ``goodput=`` the
:class:`~unionml_tpu_torch.goodput.GoodputTracker`'s attribution of its
wall time.

``sharding=`` (a :class:`~unionml_tpu_torch.parallel.ShardingConfig`)
runs the step through :func:`~unionml_tpu_torch.parallel.compile_step` on
the placed state, each rank feeding only its batch rows;
``overlap_grads=True`` overlaps the gradient collectives of gradient
accumulation with the next microbatch (:func:`resolve_grad_overlap`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models.train import resolve_params, tree_device, tree_leaves, tree_map


def publish_memory_gauges(registry: Optional[Any] = None) -> int:
    """Publish each CUDA device's ``torch.cuda.memory_allocated`` as the
    ``unionml_trainer_hbm_bytes_in_use{device=...}`` gauge; returns the
    number of devices published (0 without a card)."""
    reg = registry if registry is not None else telemetry.get_registry()
    gauge = reg.gauge(
        "unionml_trainer_hbm_bytes_in_use",
        "Device memory allocated by tensors per CUDA device.",
        ("device",),
    )
    if not torch.cuda.is_available():
        return 0
    for i in range(torch.cuda.device_count()):
        gauge.labels(device=str(i)).set(float(torch.cuda.memory_allocated(i)))
    return torch.cuda.device_count()


def _publish_loss(metrics: Any, gauge: Any) -> None:
    """Set ``gauge`` from the first scalar metric whose key names 'loss'
    (a readback: call only where the loop waits anyway)."""
    if not isinstance(metrics, dict):
        return
    for key, leaf in metrics.items():
        if "loss" in str(key).lower() and np.ndim(leaf) == 0:
            gauge.set(float(leaf))
            return


def to_microbatches(batch: Any, accumulate_steps: int, batch_size: int) -> Any:
    """Reshape a fed batch's leaves to ``[accumulate_steps, batch_size,
    ...]``; raises when the leading dim is not their product."""
    feed_rows = accumulate_steps * batch_size

    def reshape(x):
        if not hasattr(x, "reshape"):
            x = np.asarray(x)
        if x.shape[0] != feed_rows:
            raise ValueError(
                f"accumulation batch has leading dim {x.shape[0]}, "
                f"expected accumulate_steps * batch_size = {feed_rows}"
            )
        return x.reshape((accumulate_steps, batch_size) + tuple(x.shape[1:]))

    return tree_map(reshape, batch)


def is_stream(features: Any) -> bool:
    """The trainer-feed streaming rule: callables (a fresh iterable per
    epoch), iterators (one pass) and re-iterable loader objects are
    streams; containers, arrays and tensors are not."""
    return callable(features) or (
        hasattr(features, "__iter__")
        and not isinstance(features, (dict, list, tuple, str, bytes))
        and not hasattr(features, "__array__")
        and not hasattr(features, "shape")
    )


def batch_indices(
    n: int, batch_size: int, *, shuffle: bool, seed: int, drop_remainder: bool = True
) -> Iterable[np.ndarray]:
    """Static-shape batch index generator (remainders dropped)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    if n_batches == 0 and n > 0:
        yield order
        return
    for i in range(n_batches):
        yield order[i * batch_size:(i + 1) * batch_size]


def resolve_grad_overlap(sharding: Any, accumulate_steps: int) -> Any:
    """The :class:`~unionml_tpu_torch.models.train.GradOverlap` for a
    trainer run with ``overlap_grads=True``, the reference's one selection
    rule shared by :func:`run_step_trainer` and the elastic trainer:

    - ``accumulate_steps == 1``: None (no microbatch pipeline to overlap);
    - pure data parallelism (every mesh axis but ``data`` trivial, no
      partition rules, ``data > 1``): ``mode="shard_map"``, explicit
      bucketed all-reduces over ``data``;
    - anything else (sharded params, or no mesh): ``mode="defer"``."""
    from unionml_tpu_torch.models.train import GradOverlap

    if accumulate_steps <= 1:
        logger.info(
            "overlap_grads: accumulate_steps=1 has no microbatch pipeline to overlap — "
            "running the serial step"
        )
        return None
    if sharding is None:
        return GradOverlap(mode="defer")
    shape = sharding.mesh_shape()
    model_axes = {name: size for name, size in shape.items() if name != "data" and size > 1}
    if not model_axes and not tuple(sharding.rules) and shape.get("data", 1) > 1:
        return GradOverlap(mode="shard_map", mesh=sharding.mesh(), axes=("data",))
    return GradOverlap(mode="defer")


def _num_examples(features: Any) -> int:
    leaves = tree_leaves(features)
    if not leaves or not hasattr(leaves[0], "shape"):
        raise ValueError("train_step features hold no array leaves")
    return int(leaves[0].shape[0])


def _is_plain_array(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple)) and (
        hasattr(x, "__array__") or isinstance(x, torch.Tensor)
    )


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _host(x: Any) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_step_trainer(
    *,
    step_fn: Callable,
    state: Any,
    features: Any,
    targets: Any = None,
    num_epochs: int = 1,
    batch_size: int = 32,
    seed: int = 0,
    sharding: Any = None,
    donate_state: bool = True,
    accumulate_steps: int = 1,
    overlap_grads: bool = False,
    double_buffer: bool = False,
    donate_batch: Optional[bool] = None,
    profile_dir: Optional[str] = None,
    registry: Optional[Any] = None,
    goodput: Any = None,
    measure_device_time: bool = False,
    skew_every: int = 50,
) -> Any:
    """Run ``step_fn(state, batch) -> (state, metrics)`` over ``num_epochs``
    of shuffled ``batch_size`` batches of ``(features, targets)`` (or of
    ``features`` alone) and return the final state.

    ``accumulate_steps=N``: each fed batch holds ``N * batch_size`` rows
    reshaped to ``[N, batch_size, ...]`` for a step that accumulates them
    into one update. ``features`` may instead be a stream: an iterator of
    ready batches (``num_epochs`` 1), a zero-argument callable returning a
    fresh iterable per epoch, or a re-iterable loader; ``targets`` must
    then be None. ``measure_device_time`` waits for the card after every
    step, so ``unionml_trainer_step_ms`` samples device step latency
    rather than the host's enqueue time. ``profile_dir`` writes a
    :mod:`torch.profiler` trace of the loop there.

    ``double_buffer=True`` runs the feed (host batch pull, pin, copy
    enqueue) on a feeder thread with its own copy stream, in the same
    batch order. ``goodput=True`` (or a
    :class:`~unionml_tpu_torch.goodput.GoodputTracker`) attributes the
    loop's wall time: the step, its waits for the card and the trailing
    drain in ``compute``, the feed in ``data_wait`` / ``host_to_device``;
    it publishes ``unionml_train_goodput_ratio`` and
    ``unionml_train_badput_seconds_total{cause}``, per-phase trace spans
    and the step-time regression detector. Every ``skew_every`` steps the
    step time is gathered across processes for the skew monitor (a no-op
    in one process).

    ``sharding``: the step runs over the config's mesh through
    :func:`~unionml_tpu_torch.parallel.compile_step` (the state placed
    once; ``donate_state`` updates it in place), under accumulation with
    the microbatch axis whole (:meth:`ShardingConfig.microbatched`); with
    several ranks each rank feeds only its rows of every batch.
    ``overlap_grads=True`` overlaps each microbatch's gradient collectives
    with the next microbatch's backward (:func:`resolve_grad_overlap`).
    ``donate_batch`` (default: ``double_buffer``) lets the step drop the
    fed batch.
    """
    streaming = is_stream(features)
    if streaming:
        if targets is not None:
            raise ValueError(
                "streaming trainers take batches from `features` alone — "
                "yield (x, y) tuples from the stream instead of passing targets"
            )
        if hasattr(features, "__next__") and num_epochs != 1:
            raise ValueError(
                "a one-shot batch iterator cannot be replayed for "
                f"num_epochs={num_epochs}; pass a callable returning a fresh "
                "iterable per epoch"
            )
    n = 0 if streaming else _num_examples(features)
    has_targets = targets is not None
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    feed_rows = batch_size * accumulate_steps
    if accumulate_steps > 1 and not streaming and n < feed_rows:
        raise ValueError(
            "gradient accumulation needs at least accumulate_steps * "
            f"batch_size = {feed_rows} examples per step, got {n}"
        )
    overlap = resolve_grad_overlap(sharding, accumulate_steps) if overlap_grads else None
    if donate_batch is None:
        donate_batch = double_buffer
    if sharding is not None and accumulate_steps > 1:
        sharding = sharding.microbatched()
    if sharding is not None:
        from unionml_tpu_torch.parallel import compile_step

        step_fn, state = compile_step(step_fn, state, sharding=sharding,
                                      donate_state=donate_state, donate_batch=donate_batch)
    device = tree_device(resolve_params(state))
    on_card = device.type == "cuda"

    def fed(out: Any) -> Any:
        return to_microbatches(out, accumulate_steps, batch_size) if accumulate_steps > 1 else out

    def host_batches():
        if streaming:
            for epoch in range(num_epochs):
                stream = features() if callable(features) else iter(features)
                got = 0
                for item in stream:
                    got += 1
                    yield fed(item)
                if got == 0:
                    raise ValueError(
                        "streaming source yielded no batches in epoch "
                        f"{epoch + 1}/{num_epochs}. A callable must return a "
                        "FRESH iterable per call (a lambda closing over one "
                        "generator replays an exhausted stream); an iterator "
                        "must not be consumed before training"
                    )
            return
        if (
            _is_plain_array(features)
            and (not has_targets or _is_plain_array(targets))
            and n >= feed_rows
        ):
            # plain arrays go through the host loader, whose stream is the
            # reference loader's: the same seed gives the same batch order.
            # The feed pins (so copies) each batch before it pulls the next,
            # so on the card the loader may lend its staging buffers
            # (copy=False); on the CPU the fed tensor shares the numpy
            # batch's memory, which must then be a fresh copy
            from unionml_tpu_torch.data.native import BatchLoader

            arrays = [_host(features)] + ([_host(targets)] if has_targets else [])
            loader = BatchLoader(arrays, batch_size=feed_rows, seed=seed, shuffle=True,
                                 drop_remainder=True, copy=not on_card)
            try:
                for epoch in range(num_epochs):
                    for batch in loader.epoch(epoch):
                        yield fed(batch if has_targets else batch[0])
            finally:
                loader.close()
            return
        for epoch in range(num_epochs):
            for idx in batch_indices(n, feed_rows, shuffle=True, seed=seed + epoch):
                xb = tree_map(lambda x: _host(x)[idx], features)
                yield fed((xb, tree_map(lambda x: _host(x)[idx], targets)) if has_targets else xb)

    from unionml_tpu_torch.data.pipeline import local_batches, prefetch_to_device
    from unionml_tpu_torch.diagnostics import StepTimer, trace
    from unionml_tpu_torch.goodput import GoodputTracker, allgather_step_times, phase_scope
    from unionml_tpu_torch.introspection import ProgramTracker
    from unionml_tpu_torch.models.train import grad_overlap_scope

    reg = registry if registry is not None else telemetry.get_registry()
    h_step = reg.histogram(
        "unionml_trainer_step_ms",
        "Per-step wall time. Default: the host's enqueue of the step "
        "(window boundaries wait for the card so windowed rates measure "
        "compute). With measure_device_time= every step waits, so samples "
        "are device step latency.",
    )
    g_loss = reg.gauge(
        "unionml_trainer_loss", "Last scalar 'loss' metric read back at a window boundary.",
    )
    g_rate = reg.gauge(
        "unionml_trainer_samples_per_sec",
        "Windowed training throughput (latest StepTimer window).",
    )
    c_steps = reg.counter("unionml_trainer_steps_total", "Train steps dispatched.")
    c_examples = reg.counter("unionml_trainer_examples_total", "Training examples consumed.")
    step = ProgramTracker(registry=reg, component="trainer").wrap("trainer.step", step_fn)
    tracker = None
    if goodput:
        tracker = goodput if isinstance(goodput, GoodputTracker) else GoodputTracker(registry=reg)

    def wait() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    timer = StepTimer()
    steps = 0
    metrics = None
    if tracker is not None:
        tracker.start()
    ctx = trace(profile_dir) if profile_dir else contextlib.nullcontext()
    overlap_ctx = grad_overlap_scope(overlap) if overlap is not None else contextlib.nullcontext()
    source = host_batches()
    if sharding is not None and _world_size() > 1:
        # the rows of the sharded batch dim: a microbatched batch shards
        # its second dim, of batch_size rows
        source = local_batches(source, sharding, batch_size)
    feed = prefetch_to_device(source, device=device, sharding=sharding, goodput=tracker,
                              double_buffer=double_buffer)
    # finish() runs on the exception path too: a raising stream must not
    # leave the trainer timeline open, nor a retry with the same tracker
    # count the gap as unattributed wall time
    try:
        with ctx, overlap_ctx, contextlib.closing(feed):
            for batch in feed:
                t_step = time.perf_counter()
                with phase_scope(tracker, "compute"):
                    state, metrics = step(state, batch)
                    window_closed = timer.closes_window()
                    if measure_device_time or window_closed:
                        wait()
                # the wait above is step time; the publishes below are host
                # bookkeeping and must not inflate the sample
                step_s = time.perf_counter() - t_step
                h_step.observe(step_s * 1e3)
                if tracker is not None:
                    # a window boundary's wait drains a whole window of
                    # enqueued steps into one sample: keep it out of the
                    # regression detector (with measure_device_time every
                    # sample is comparable)
                    tracker.step_complete(step_s, detect=measure_device_time or not window_closed)
                    if skew_every > 0 and (steps + 1) % skew_every == 0:
                        times = allgather_step_times(step_s)
                        if times is not None:
                            tracker.record_step_skew(steps + 1, times)
                if window_closed:
                    _publish_loss(metrics, g_loss)
                    publish_memory_gauges(reg)
                leaf = next((x for x in tree_leaves(batch) if getattr(x, "ndim", 0) >= 1), None)
                if leaf is None:
                    rows = batch_size
                elif accumulate_steps > 1 and leaf.ndim >= 2:
                    rows = leaf.shape[0] * leaf.shape[1]
                else:
                    rows = leaf.shape[0]
                timer.tick(rows)
                c_steps.inc()
                c_examples.inc(rows)
                if timer.rates:
                    g_rate.set(timer.rates[-1])
                steps += 1
        if steps:
            # the trailing wait is device compute still in flight
            with phase_scope(tracker, "compute"):
                wait()
            _publish_loss(metrics, g_loss)
            publish_memory_gauges(reg)
            rate = timer.summary().get("samples_per_sec_median")
            if rate:
                g_rate.set(rate)
            last = {k: float(v) if np.ndim(v) == 0 else v for k, v in metrics.items()} \
                if isinstance(metrics, dict) else metrics
            suffix = f", ~{rate:.0f} samples/sec" if rate else ""
            logger.info(f"step trainer: {steps} steps, final metrics: {last}{suffix}")
    finally:
        if tracker is not None:
            tracker.finish()
    return state
