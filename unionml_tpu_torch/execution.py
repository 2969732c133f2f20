"""The synthesized trainer loop around a per-batch step.

The port of :mod:`unionml_tpu.execution`'s plain route:
:func:`run_step_trainer` drives ``step(state, batch) -> (state, metrics)``
over epochs of static-shape batches (remainders dropped), fed from the
deterministic :class:`~unionml_tpu_torch.data.native.BatchLoader` (or from
a stream) through :func:`~unionml_tpu_torch.data.pipeline
.prefetch_to_device`, onto the device of the state's params. PyTorch runs
eagerly, so there is no compile step: each step enqueues its kernels and
returns; a window boundary (or ``measure_device_time``) waits for the card.
The loop publishes the ``unionml_trainer_*`` metric families into the
port's telemetry registry.

Not ported yet (each raises ``NotImplementedError``): ``sharding=`` and
``overlap_grads=True`` (parallelism, A11), ``goodput=`` (the
``GoodputTracker``) and ``double_buffer=True`` (the threaded feed).
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


def _num_examples(features: Any) -> int:
    leaves = tree_leaves(features)
    if not leaves or not hasattr(leaves[0], "shape"):
        raise ValueError("train_step features hold no array leaves")
    return int(leaves[0].shape[0])


def _is_plain_array(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple)) and (
        hasattr(x, "__array__") or isinstance(x, torch.Tensor)
    )


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
    accumulate_steps: int = 1,
    overlap_grads: bool = False,
    double_buffer: bool = False,
    profile_dir: Optional[str] = None,
    registry: Optional[Any] = None,
    goodput: Any = None,
    measure_device_time: bool = False,
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
    """
    if sharding is not None or overlap_grads:
        raise NotImplementedError(
            "sharding= and overlap_grads=True need the parallelism port (ROADMAP.md, A11)"
        )
    if goodput:
        raise NotImplementedError(
            "goodput= needs the GoodputTracker, not ported yet (ROADMAP.md)"
        )
    if double_buffer:
        raise NotImplementedError("the threaded double_buffer feed is not ported yet (ROADMAP.md)")
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
            # the reference's loader contract: the same seed gives the
            # same batch order
            from unionml_tpu_torch.data.native import BatchLoader

            arrays = [_host(features)] + ([_host(targets)] if has_targets else [])
            loader = BatchLoader(arrays, batch_size=feed_rows, seed=seed, shuffle=True,
                                 drop_remainder=True)
            for epoch in range(num_epochs):
                for batch in loader.epoch(epoch):
                    yield fed(batch if has_targets else batch[0])
            return
        for epoch in range(num_epochs):
            for idx in batch_indices(n, feed_rows, shuffle=True, seed=seed + epoch):
                xb = tree_map(lambda x: _host(x)[idx], features)
                yield fed((xb, tree_map(lambda x: _host(x)[idx], targets)) if has_targets else xb)

    from unionml_tpu_torch.data.pipeline import prefetch_to_device
    from unionml_tpu_torch.diagnostics import StepTimer, trace
    from unionml_tpu_torch.introspection import ProgramTracker

    device = tree_device(resolve_params(state))
    on_card = device.type == "cuda"
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

    def wait() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    timer = StepTimer()
    steps = 0
    metrics = None
    ctx = trace(profile_dir) if profile_dir else contextlib.nullcontext()
    with ctx:
        for batch in prefetch_to_device(host_batches(), device=device):
            t_step = time.perf_counter()
            state, metrics = step(state, batch)
            window_closed = timer.closes_window()
            if measure_device_time or window_closed:
                wait()
            step_s = time.perf_counter() - t_step
            h_step.observe(step_s * 1e3)
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
    return state
