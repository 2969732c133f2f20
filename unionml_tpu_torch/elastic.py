"""Preemption-safe training: periodic checkpoints and deterministic resume.

The port of :mod:`unionml_tpu.elastic`:

- the training position is a ``(epoch, step)`` coordinate, and the data
  order is a pure function of ``(seed, epoch)`` (the splitmix64
  permutation shared by the C++ host loader and its numpy path, see
  :mod:`unionml_tpu_torch.data.native`), so restoring the state and
  seeking the loader reproduces the exact batch stream;
- :func:`run_elastic_trainer` checkpoints every ``checkpoint_every`` steps
  (the global step in the checkpoint's name is the position) and at the
  end, and on start resumes from the newest checkpoint under
  ``checkpoint_dir``;
- a killed-and-relaunched run reaches the bit-identical final state of an
  uninterrupted run, the optimizer's counters included.

Checkpoints are async (:func:`~unionml_tpu_torch.checkpoint
.make_checkpoint_manager`): ``save`` stalls the loop for the snapshot's
enqueue only, and restore refuses torn checkpoints. Batches flow through
:func:`~unionml_tpu_torch.data.pipeline.prefetch_to_device` (``double_buffer``
moves the feed onto a feeder thread with its own copy stream).
``sharding=`` places the state on the mesh (:func:`~unionml_tpu_torch
.parallel.compile_step`) and checkpoints it with the sharded manager, each
rank feeding its rows; ``overlap_grads=True`` overlaps the gradient
collectives of accumulation.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.checkpoint.async_writer import make_checkpoint_manager
from unionml_tpu_torch.data.native import BatchLoader
from unionml_tpu_torch.data.pipeline import local_batches, prefetch_to_device
from unionml_tpu_torch.goodput import GoodputTracker
from unionml_tpu_torch.goodput import phase_scope as _phase
from unionml_tpu_torch.models.train import resolve_params, tree_device


class Preemption(RuntimeError):
    """Raised by fault injectors to simulate a preemption."""


_STREAM_END = object()  # next(it) default: exhaustion sentinel


def _drain(device: torch.device) -> None:
    """Wait for the device work still in flight (the loop's last steps)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_elastic_trainer(
    *,
    step_fn: Callable,
    state: Any,
    arrays: Optional[Sequence[np.ndarray]] = None,
    stream: Optional[Callable] = None,
    num_steps: Optional[int] = None,
    checkpoint_dir: str,
    num_epochs: int = 1,
    batch_size: int = 32,
    seed: int = 0,
    checkpoint_every: int = 100,
    max_to_keep: int = 3,
    checkpoint_backend: str = "auto",
    sharding: Any = None,
    donate_state: bool = True,
    accumulate_steps: int = 1,
    overlap_grads: bool = False,
    double_buffer: bool = False,
    donate_batch: Optional[bool] = None,
    fault_hook: Optional[Callable[[int], None]] = None,
    goodput: Any = None,
) -> Tuple[Any, int]:
    """Train with periodic checkpoints, resuming from the newest one.

    ``step_fn(state, batch) -> (state, metrics)``; ``arrays`` is
    ``(features,)`` or ``(features, targets)`` row-aligned numpy arrays.
    Returns ``(final_state, global_step)``. ``fault_hook(global_step)`` is a
    test seam: it runs after each step (and its checkpoint) and may raise
    to simulate a preemption.

    ``accumulate_steps=N``: each global step consumes ``N * batch_size``
    rows reshaped to a leading microbatch axis (the ``run_step_trainer``
    contract). The global step counts optimizer updates, so resume points
    stay aligned with them.

    The global step indexes the stream ``epoch * steps_per_epoch + batch``;
    checkpoints are written under ``checkpoint_dir/step_{global_step}``,
    where the state has consumed batch ``global_step - 1``.
    ``checkpoint_backend`` is ``"auto"`` / ``"async"`` (background commit),
    ``"sync"`` (inline commit) or ``"orbax"`` (the sharded manager, which
    ``"auto"`` picks under ``sharding``).

    ``sharding``: the step runs through :func:`~unionml_tpu_torch.parallel
    .compile_step` on the placed state (microbatched under accumulation),
    each rank feeding its rows; ``overlap_grads=True`` selects the
    :func:`~unionml_tpu_torch.execution.resolve_grad_overlap` strategy.

    **Streaming sources**: pass ``stream`` instead of ``arrays`` — a
    callable producing ready batches, treated as ONE step-indexed sequence
    (``num_epochs`` does not apply; bound it with ``num_steps`` or let it
    run to exhaustion). ``stream(start_step)`` is seekable: called with the
    resume step, it yields the batches from there. ``stream()`` is
    replayable: called from the top, and the first ``resume_step``
    batches are skipped on the host. A final checkpoint is written at
    exhaustion.

    **Goodput**: ``goodput=True`` (or a
    :class:`~unionml_tpu_torch.goodput.GoodputTracker`) attributes the
    loop's wall time — the step and the trailing wait for the card in
    ``compute``, the feed in ``data_wait`` / ``host_to_device``, the save
    stall on the loop in ``checkpoint`` (the background commit publishes
    ``unionml_checkpoint_commit_ms`` instead), and the restore and replay
    after a kill in ``preemption``.
    """
    if (arrays is None) == (stream is None):
        raise ValueError("pass exactly one of arrays= or stream=")
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    from unionml_tpu_torch.execution import _world_size, resolve_grad_overlap, to_microbatches
    from unionml_tpu_torch.models.train import grad_overlap_scope

    feed_rows = batch_size * accumulate_steps
    overlap = resolve_grad_overlap(sharding, accumulate_steps) if overlap_grads else None
    if donate_batch is None:
        donate_batch = double_buffer
    if sharding is not None:
        if accumulate_steps > 1:
            sharding = sharding.microbatched()
        from unionml_tpu_torch.parallel import compile_step

        step_fn, state = compile_step(step_fn, state, sharding=sharding,
                                      donate_state=donate_state, donate_batch=donate_batch)
        if checkpoint_backend == "auto":
            checkpoint_backend = "orbax"
    if overlap is not None:
        inner = step_fn

        def step_fn(state, batch):
            with grad_overlap_scope(overlap):
                return inner(state, batch)
    process_rows = None
    if sharding is not None and _world_size() > 1:
        # the rows of the sharded batch dim (a microbatched batch's second)
        process_rows = (sharding, batch_size)
    device = tree_device(resolve_params(state))
    tracker = None
    if goodput:
        tracker = goodput if isinstance(goodput, GoodputTracker) else GoodputTracker()
        # the wall window opens AFTER step construction, matching
        # run_step_trainer: compile_step's placement is build-time setup
        tracker.start()
        # the step's first (counted) dispatch is its compile event: its
        # FLOPs and bytes go to the program tracker and its time into
        # goodput's `compile` bucket, as the reference's jit compile does
        from unionml_tpu_torch.introspection import ProgramTracker

        step_fn = ProgramTracker(
            registry=tracker.registry, component="trainer",
            on_compile=tracker.note_compile_ms,
        ).wrap("trainer.elastic_step", step_fn)

    def prepare(batch: Any) -> Any:
        return to_microbatches(batch, accumulate_steps, batch_size) \
            if accumulate_steps > 1 else batch

    loop = dict(step_fn=step_fn, device=device, checkpoint_every=checkpoint_every,
                fault_hook=fault_hook, tracker=tracker, double_buffer=double_buffer,
                sharding=sharding, process_rows=process_rows)
    if stream is not None:
        return _run_stream(state, stream, checkpoint_dir=checkpoint_dir, num_steps=num_steps,
                           max_to_keep=max_to_keep, checkpoint_backend=checkpoint_backend,
                           prepare=prepare, **loop)

    # the feed pins (so copies) each batch before it pulls the next, so on
    # the card the loader may lend its staging buffers (copy=False); on the
    # CPU the fed tensor shares the numpy batch's memory, which must then
    # be a fresh copy
    loader = BatchLoader(list(arrays), batch_size=feed_rows, seed=seed, shuffle=True,
                         drop_remainder=True, copy=device.type != "cuda")
    steps_per_epoch = loader.num_batches
    if steps_per_epoch == 0:
        loader.close()
        if tracker is not None:
            tracker.finish()
        raise ValueError(
            f"elastic trainer needs at least one full batch: {loader.n_rows} rows < "
            f"accumulate_steps * batch_size = {feed_rows} — lower batch_size"
        )
    total_steps = steps_per_epoch * num_epochs
    single = len(arrays) == 1
    try:
        manager = make_checkpoint_manager(
            checkpoint_dir, max_to_keep=max_to_keep, backend=checkpoint_backend,
            registry=tracker.registry if tracker is not None else None,
        )
    except BaseException:
        loader.close()
        if tracker is not None:
            tracker.finish()
        raise
    try:
        global_step = 0
        resume_step = manager.latest_step()
        if resume_step is not None:
            # resuming after a kill: the restore is preemption badput
            with _phase(tracker, "preemption"):
                state = manager.restore(state, step=resume_step)
            global_step = resume_step
            logger.info(f"elastic trainer: resuming from step {global_step}")
        start_epoch, start_batch = divmod(global_step, steps_per_epoch)

        def host_batches() -> Iterator[Any]:
            for _epoch, _idx, batch in loader.epochs(num_epochs, start_epoch=start_epoch,
                                                     start_batch=start_batch):
                yield prepare(batch[0] if single else batch)

        state, global_step = _loop(
            state, host_batches(), manager, global_step=global_step,
            is_last=lambda s: s == total_steps, **loop,
        )
    finally:
        loader.close()
        # close() drains the background commit; best-effort, so a failed
        # commit never masks the exception that ended the loop
        with _phase(tracker, "checkpoint"):
            manager.close()
        if tracker is not None:
            tracker.finish()
    logger.info(f"elastic trainer: finished at step {global_step}/{total_steps}")
    return state, global_step


def _loop(state: Any, batches: Iterator[Any], manager: Any, *, step_fn: Callable,
          device: torch.device, global_step: int, checkpoint_every: int,
          is_last: Callable[[int], bool], fault_hook: Optional[Callable[[int], None]],
          tracker: Optional[GoodputTracker], double_buffer: bool, sharding: Any = None,
          process_rows: Any = None) -> Tuple[Any, int]:
    """The step loop shared by the array and stream routes: feed, step,
    checkpoint every ``checkpoint_every`` steps and at ``is_last``, then
    the fault hook. Stops after the step ``is_last`` names. With
    ``process_rows`` (``(sharding, global rows)``) each rank feeds only
    its rows of every batch."""
    if process_rows is not None:
        batches = local_batches(batches, *process_rows)
    feed = prefetch_to_device(batches, device=device, sharding=sharding, goodput=tracker,
                              double_buffer=double_buffer)
    with contextlib.closing(feed):
        for batch in feed:
            t_step = time.perf_counter()
            with _phase(tracker, "compute"):
                state, _metrics = step_fn(state, batch)
            if tracker is not None:
                tracker.step_complete(time.perf_counter() - t_step)
            global_step += 1
            last = is_last(global_step)
            if global_step % checkpoint_every == 0 or last:
                # the snapshot's copies are enqueued on the stream the next
                # step runs on, so the next step cannot change them
                with _phase(tracker, "checkpoint"):
                    manager.save(global_step, state)
            if fault_hook is not None:
                fault_hook(global_step)
            if last:
                break
    # the trailing wait is device compute still in flight
    with _phase(tracker, "compute"):
        _drain(device)
    return state, global_step


def _run_stream(state: Any, stream: Callable, *, checkpoint_dir: str,
                num_steps: Optional[int], max_to_keep: int, checkpoint_backend: str,
                prepare: Callable[[Any], Any], step_fn: Callable, device: torch.device,
                checkpoint_every: int, fault_hook: Optional[Callable[[int], None]],
                tracker: Optional[GoodputTracker], double_buffer: bool, sharding: Any = None,
                process_rows: Any = None) -> Tuple[Any, int]:
    """The step-indexed resumable loop over a streaming batch source."""
    try:
        manager = make_checkpoint_manager(
            checkpoint_dir, max_to_keep=max_to_keep, backend=checkpoint_backend,
            registry=tracker.registry if tracker is not None else None,
        )
    except BaseException:
        if tracker is not None:
            tracker.finish()
        raise
    try:
        global_step = 0
        resume_step = manager.latest_step()
        if resume_step is not None:
            with _phase(tracker, "preemption"):
                state = manager.restore(state, step=resume_step)
            global_step = resume_step
            logger.info(f"elastic trainer: resuming stream from step {global_step}")
        if num_steps is not None and global_step >= num_steps:
            return state, global_step

        params = inspect.signature(stream).parameters.values()
        required = [p for p in params if p.default is inspect.Parameter.empty
                    and p.kind is not inspect.Parameter.VAR_KEYWORD
                    and p.kind is not inspect.Parameter.VAR_POSITIONAL]
        if any(p.kind is inspect.Parameter.KEYWORD_ONLY for p in required):
            raise ValueError(
                "stream callables take the resume step as ONE positional argument "
                "(seekable form) or no required arguments (replayable form); a "
                "required keyword-only parameter fits neither — see "
                "run_elastic_trainer's streaming contract"
            )
        if required:
            it, skip = iter(stream(global_step)), 0
        else:
            it, skip = iter(stream()), global_step
            if skip:
                logger.info(
                    f"elastic trainer: replaying stream, skipping {skip} consumed batches "
                    "(pass stream(start_step) to seek instead)"
                )
        # producing the consumed batches again is preemption badput; doing
        # it before the feed starts keeps skipped batches off the device
        while skip:
            with _phase(tracker, "preemption"):
                batch = next(it, _STREAM_END)
            if batch is _STREAM_END:
                raise RuntimeError(
                    f"stream exhausted {skip} batches before the resume position "
                    f"(step {global_step}): the replayed stream must reproduce at least "
                    "the batches already consumed"
                )
            skip -= 1
        start = global_step
        state, global_step = _loop(
            state, (prepare(batch) for batch in it), manager, global_step=global_step,
            is_last=lambda s: num_steps is not None and s >= num_steps, step_fn=step_fn,
            device=device, checkpoint_every=checkpoint_every, fault_hook=fault_hook,
            tracker=tracker, double_buffer=double_buffer, sharding=sharding,
            process_rows=process_rows,
        )
        bounded = num_steps is not None and global_step >= num_steps
        if not bounded and global_step > start and global_step % checkpoint_every != 0:
            # exhausted: persist the terminal position so a restart resumes
            # after the last consumed batch instead of training it again
            with _phase(tracker, "checkpoint"):
                manager.save(global_step, state)
    finally:
        with _phase(tracker, "checkpoint"):
            manager.close()
        if tracker is not None:
            tracker.finish()
    logger.info(f"elastic trainer: stream finished at step {global_step}")
    return state, global_step
