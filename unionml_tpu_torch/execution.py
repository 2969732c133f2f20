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

:func:`jit_predictor` is the port's counterpart of ``jax.jit`` for a
predictor body (``@model.predictor(jit=True)``): one CUDA graph captured
per call signature and replayed after that (:func:`clear_jit_cache` drops
them). ``torch.compile`` cannot take its place: the hand-written kernels
are ``ctypes`` calls it cannot trace. A signature's warm-up call (before
its capture) is its compile event: its FLOPs and bytes are counted
(:class:`~unionml_tpu_torch.introspection.CostCounter`) and every replay
credits them, as it credits the captured kernels' launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._graphs import Graph, capture
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops import _build
from unionml_tpu_torch.models.train import (
    resolve_params,
    tree_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def publish_hbm_gauges(registry: Optional[Any] = None) -> int:
    """Publish each CUDA device's ``torch.cuda.memory_allocated`` as the
    ``unionml_trainer_hbm_bytes_in_use{device=...}`` gauge (the H100's
    memory is HBM3, so the reference's name holds); returns the number of
    devices published (0 without a card)."""
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


#: the reference's bound on its per-function jit cache
#: (``lru_cache(maxsize=128)``): predictors kept, and graphs kept a predictor
_JIT_CACHE_SIZE = 128


def _model_tensors(obj: Any) -> List[torch.Tensor]:
    """The tensors a model object holds, in a fixed order: a module's
    parameters and buffers, the leaves of a dict / list / tuple tree, the
    fields of a dataclass state (a ``TrainState``)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, dict):
        values: Iterable[Any] = obj.values()
    elif isinstance(obj, (list, tuple)):
        values = obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        values = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for v in values for t in _model_tensors(v)]


def _structure(tree: Any) -> Any:
    """A hashable form of a feature tree's structure (dict keys, list and
    tuple lengths)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _leaf_key(x: Any, device: torch.device) -> Any:
    """An array leaf by shape, dtype and device (its values are inputs); any
    other leaf by value (a constant of the captured program)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, np.ndarray):
        return ("array", x.shape, str(x.dtype), str(device))
    return ("value", type(x).__name__, repr(x))


def _signature(tensors: List[torch.Tensor], features: Any) -> Any:
    device = next((t.device for t in tensors if t.is_cuda), torch.device("cpu"))
    return (_structure(features),
            tuple(_leaf_key(x, device) for x in tree_leaves(features)),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors))


class _Graph:
    """One captured call: its static inputs and the captured body
    (:class:`~unionml_tpu_torch._graphs.Graph`: outputs, the kernel
    launches it replays and the cost its warm-up call counted)."""

    def __init__(self, captured: Graph, inputs: List[Any]):
        self.captured, self.inputs = captured, inputs
        self.cost = captured.cost

    def run(self, leaves: List[Any]) -> Any:
        # a cost counter around the replay is charged the eager call's cost
        # (the copies in and out are not the body's work)
        with _build.charged(lambda: self.cost):
            for dst, src in zip(self.inputs, leaves):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(torch.as_tensor(src))
            outputs = self.captured.replay()
            return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, outputs)


class GraphedPredictor:
    """A predictor body ``(model_object, features) -> preds`` run as CUDA
    graphs (:func:`jit_predictor`).

    The call signature is the features' tree structure, each array leaf's
    shape, dtype and device (other leaves by value), and the identity of
    the model object's tensors (their addresses, shapes and dtypes): a
    model object with other tensors captures anew, and an in-place update
    of the same tensors is read by the replay, as ``jax.jit`` reads new
    argument values. The first call of a signature runs the body once on
    a side stream (kernels built, lazy state set up), captures it into a
    graph with its own memory pool, and replays it; later calls copy the
    features into the graph's static inputs and replay. Outputs are
    cloned out of the graph's buffers. A kernel's launch count grows by the
    launches the graph captured at every replay (a capture launches
    nothing). A body that cannot be captured (a host sync: ``.item()``,
    ``.cpu()``, a Python branch on a tensor's value) raises, naming the
    predictor; nothing falls back to eager. A model object with no tensor
    on a CUDA device runs the body as called (the CPU path).

    :attr:`programs` tracks the body as ``predictor.jit``: the warm-up call
    of each signature is its compile event (its FLOPs and bytes counted),
    each replay a call credited that cost (on the CPU path: the first call
    of a signature, then each call)."""

    def __init__(self, fn: Callable):
        from unionml_tpu_torch.introspection import ProgramTracker

        self.fn = fn
        self._graphs: "OrderedDict[Any, _Graph]" = OrderedDict()
        self._lock = threading.Lock()
        self.programs = ProgramTracker(component=telemetry.instance_label("predictor"))
        self._eager = self.programs.wrap("predictor.jit", fn, sig_fn=self.signature)
        functools.update_wrapper(self, fn)
        _LIVE.add(self)

    def signature(self, model_object: Any, features: Any) -> Any:
        """The cache key of a call (see the class docstring)."""
        return _signature(_model_tensors(model_object), features)

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph (and with it its memory pool)."""
        with self._lock:
            self._graphs.clear()

    def __call__(self, model_object: Any, features: Any) -> Any:
        tensors = _model_tensors(model_object)
        device = next((t.device for t in tensors if t.is_cuda), None)
        if device is None:
            return self._eager(model_object, features)
        key = _signature(tensors, features)
        leaves = tree_leaves(features)
        with self._lock:
            entry = self._graphs.get(key)
            t0 = time.perf_counter()
            if entry is None:
                entry = self._capture(model_object, features, leaves, device)
                self._graphs[key] = entry
                while len(self._graphs) > _JIT_CACHE_SIZE:
                    self._graphs.popitem(last=False)
                out = entry.run(leaves)
                self.programs.record_compile("predictor.jit", key, entry.cost,
                                             (time.perf_counter() - t0) * 1e3)
            else:
                self._graphs.move_to_end(key)
                out = entry.run(leaves)
                self.programs.record_call("predictor.jit", key,
                                          (time.perf_counter() - t0) * 1e3)
        if _build.NAN_GUARD and _build.holds_nan(out):
            self._name_nan(model_object, features, leaves, device)
        return out

    def _name_nan(self, model_object: Any, features: Any, leaves: List[Any],
                  device: torch.device) -> None:
        """A replay under the NaN guard gave a NaN: re-run the call
        eagerly under the guard on the inputs the graph was given (copied
        to the card unchecked, as the replay's were), which raises naming
        the row or op that made it, as XLA re-runs the de-optimized
        program."""
        from torch.utils._python_dispatch import _disable_current_modes

        name = getattr(self.fn, "__qualname__", repr(self.fn))
        with _disable_current_modes():
            inputs = [torch.as_tensor(x).to(device) if _is_array(x) else x for x in leaves]
        with torch.cuda.device(device), _build.nan_scope():
            self.fn(model_object, tree_unflatten(features, inputs))
        raise _build.nan_error(f"predictor {name!r} (a CUDA graph replay; its eager re-run "
                               "made no NaN)")

    def _capture(self, model_object: Any, features: Any, leaves: List[Any],
                 device: torch.device) -> _Graph:
        inputs = [torch.as_tensor(x).to(device, copy=True) if _is_array(x) else x
                  for x in leaves]
        static = tree_unflatten(features, inputs)
        name = getattr(self.fn, "__qualname__", repr(self.fn))
        captured = capture(
            lambda: self.fn(model_object, static), device,
            f"predictor {name!r} (jit=True)",
            hint=" — a body with a host sync (.item(), .cpu(), a Python branch on a "
                 "tensor's value) runs with jit=False",
        )
        return _Graph(captured, inputs)


_LIVE: "weakref.WeakSet[GraphedPredictor]" = weakref.WeakSet()


@functools.lru_cache(maxsize=_JIT_CACHE_SIZE)
def _graphed(fn: Callable) -> GraphedPredictor:
    return GraphedPredictor(fn)


def jit_predictor(fn: Callable) -> GraphedPredictor:
    """Capture a predictor body ``(model_object, features) -> preds`` as
    CUDA graphs (:class:`GraphedPredictor`), from a bounded per-function
    cache (the reference's ``lru_cache(maxsize=128)``)."""
    return _graphed(fn)


def clear_jit_cache() -> None:
    """Drop every cached predictor's graphs, their memory pools and the
    per-function cache (the reference's call, for long-lived sessions that
    re-define predictors or swap models)."""
    for predictor in list(_LIVE):
        predictor.clear()
    _graphed.cache_clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


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
    tracker = None
    if goodput:
        tracker = goodput if isinstance(goodput, GoodputTracker) else GoodputTracker(registry=reg)
    # program introspection: the first step (the counted dispatch, the
    # port's compile event) records the step's FLOPs and bytes and its
    # time, which goodput debits into its `compile` bucket; the
    # unionml_program_mfu_ratio{component="trainer", program="trainer.step"}
    # gauge reports live MFU against the device peak
    step = ProgramTracker(
        registry=reg, component="trainer",
        on_compile=tracker.note_compile_ms if tracker is not None else None,
    ).wrap("trainer.step", step_fn)

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
                    publish_hbm_gauges(reg)
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
            publish_hbm_gauges(reg)
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
