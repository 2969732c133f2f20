"""Async checkpointing: host snapshot now, durable commit in the background.

The port of :mod:`unionml_tpu.checkpoint.async_writer`. ``save`` snapshots
the state to host memory — the only cost on the caller's thread — and a
background thread serializes, writes and **commits atomically** (write
into a ``*.tmp-*`` dir, fsync, drop a ``_COMMITTED`` marker, then
``os.replace`` onto the final name). A kill at ANY point therefore leaves
either the previous complete checkpoint or the new complete one, never a
torn one:

- crash before the rename → only an uncommitted ``*.tmp-*`` dir exists;
  :meth:`AsyncCheckpointManager.latest_step` ignores it and a restart
  resumes from the previous step (stale tmp dirs are swept when the next
  manager is built);
- a ``step_N`` dir missing its ``_COMMITTED`` marker (external
  interference, a partial copy) is **refused** by restore and skipped by
  ``latest_step``.

The snapshot is stream-ordered. For a CUDA leaf, ``save`` enqueues a
non-blocking copy into a pinned host buffer on the current stream and
records one event after the copies; the writer thread waits on that
event (``Event.synchronize`` releases the interpreter lock) before it
serializes. Whatever the caller enqueues next on that stream — an
in-place update included, or a kernel reusing the memory of a tensor the
caller dropped — runs after the copies, so ``save`` returns without
waiting for the card and the snapshot still cannot change. (A copy on a
side stream would not be ordered so.) A CPU leaf is cloned.

The format is the port's own (the card's machine has no flax, msgpack or
orbax): ``state.pt``, a :func:`torch.save` of the state's tree of tensors
and numbers, read with ``weights_only=True``. Restore puts each leaf on
its target leaf's device and dtype.

Telemetry splits the two legs: ``unionml_checkpoint_save_ms{kind="async"}``
records the caller stall (the wait for the previous commit + the
snapshot), ``unionml_checkpoint_commit_ms{kind="async"}`` the background
wait for the copies, serialize, write and rename, and the
``unionml_checkpoint_pending`` gauge the launched commits not yet
durable. A failed background commit is logged, counted out of
``pending`` and re-raised by the strict barrier
(:meth:`~AsyncCheckpointWriter.wait`); ``close`` only logs, so a
trainer's ``finally`` never masks the real exception with a checkpoint
one. Sharded multi-process checkpoints are
:mod:`unionml_tpu_torch.checkpoint.sharded` (:func:`make_checkpoint_manager`
picks them).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.checkpoint._metrics import checkpoint_metrics, tree_nbytes
from unionml_tpu_torch.checkpoint.pytree_io import restore_into, state_tree
from unionml_tpu_torch.models.train import tree_map

__all__ = [
    "AsyncCheckpointManager",
    "AsyncCheckpointWriter",
    "COMMIT_MARKER",
    "is_committed",
    "make_checkpoint_manager",
]

#: Marker file a committed checkpoint dir must contain. Written inside the
#: tmp dir BEFORE the atomic rename, so a final-named dir without it can
#: only mean external interference — restore refuses it.
COMMIT_MARKER = "_COMMITTED"

_DATA_FILE = "state.pt"


def is_committed(path: Union[str, os.PathLike]) -> bool:
    """True iff ``path`` is a fully committed checkpoint dir."""
    p = Path(path)
    return (p / COMMIT_MARKER).is_file() and (p / _DATA_FILE).is_file()


def _fsync_dir(path: Path) -> None:
    """fsync a DIRECTORY's entries: file-content fsyncs alone do not make
    creations/renames inside it durable across power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host_snapshot(state: Any) -> Tuple[Any, List[torch.cuda.Event]]:
    """The state's tree with every tensor copied to the host: CUDA leaves
    into pinned buffers by copies enqueued on each device's current stream
    (waited for by the returned events, one per device), CPU leaves
    cloned. Returns before the copies have run."""
    devices = set()

    def snap(x: Any) -> Any:
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_cuda:
            devices.add(x.device)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            # the source's memory is not reused before the copy, whichever
            # stream it was allocated on
            x.record_stream(torch.cuda.current_stream(x.device))
            return host
        return x.detach().clone()

    with torch.no_grad():
        host_state = tree_map(snap, state_tree(state))
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return host_state, events


class AsyncCheckpointWriter:
    """One-at-a-time background committer for host-snapshotted states.

    ``save(path, state)`` blocks only for (1) the previous commit —
    normally already durable, it ran during the intervening training
    steps — and (2) the snapshot's enqueue, then launches the wait,
    serialize, write and rename on a daemon thread and returns. ``wait()``
    is the strict barrier: it blocks until the launched commit is durable
    and re-raises its failure, if any.

    ``commit_hook(final_path)`` is a test seam: it runs on the background
    thread just before the atomic rename, so a kill mid-commit is an
    injected raise — the tmp dir stays uncommitted and the previous
    checkpoint remains the newest restorable one.
    """

    kind = "async"   # the metric label of this writer's series

    def __init__(
        self,
        *,
        registry: Optional[Any] = None,
        commit_hook: Optional[Callable[[Path], None]] = None,
    ):
        self.commit_hook = commit_hook
        self._metrics = checkpoint_metrics(registry)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = 0
        self._lock = threading.Lock()
        self._seq = 0

    def save(self, path: Union[str, os.PathLike], state: Any, *, inline: bool = False) -> None:
        """Snapshot ``state`` to host and launch the background commit of
        ``path`` (a directory). The caller's stall (wait for the previous
        commit + snapshot enqueue) is observed as ``save_ms{kind}``. With
        ``inline=True`` the commit runs on the caller's thread, inside the
        ``save_ms`` window (the overlap-off baseline); its failure, if any,
        surfaces on the next :meth:`wait`, as in the background form."""
        t0 = time.perf_counter()
        # one commit in flight at a time: a second writer would contend for
        # host I/O (and interleaved commits would reorder durability)
        self.wait()
        host_state, events = _host_snapshot(state)
        final = Path(path).absolute()
        self._seq += 1
        tmp = final.parent / f"{final.name}.tmp-{os.getpid()}-{self._seq}"
        with self._lock:
            self._pending += 1
            self._metrics["pending"].set(float(self._pending))
        if inline:
            self._commit(tmp, final, host_state, events)
        else:
            self._thread = threading.Thread(
                target=self._commit, args=(tmp, final, host_state, events),
                name=f"ckpt-commit-{final.name}", daemon=True,
            )
            self._thread.start()
        self._metrics["save_ms"].labels(self.kind).observe((time.perf_counter() - t0) * 1e3)
        self._metrics["save_bytes"].labels(self.kind).inc(tree_nbytes(host_state))

    def _commit(self, tmp: Path, final: Path, host_state: Any,
                events: List[torch.cuda.Event]) -> None:
        t0 = time.perf_counter()
        try:
            for event in events:
                event.synchronize()  # the snapshot's copies have landed
            tmp.mkdir(parents=True, exist_ok=True)
            with open(tmp / _DATA_FILE, "wb") as f:
                torch.save(host_state, f)
                f.flush()
                os.fsync(f.fileno())
                nbytes = f.tell()
            with open(tmp / COMMIT_MARKER, "w") as f:
                json.dump({"nbytes": nbytes}, f)
                f.flush()
                os.fsync(f.fileno())
            # directory entries need their own fsync to survive power
            # loss: the tmp dir's before the rename, the parent's after
            _fsync_dir(tmp)
            if self.commit_hook is not None:
                self.commit_hook(final)
            # the atomic point: a crash strictly before this leaves only the
            # tmp dir (ignored by restore); after it, the final dir is
            # complete WITH its marker. Re-saving an existing step:
            # os.replace cannot replace a non-empty directory, so the
            # committed dir is first moved aside onto the tmp namespace
            # (restore ignores *.tmp-* names; a crash between the two
            # renames loses only this step)
            if final.is_dir():
                stale = final.parent / f"{final.name}.tmp-resave"
                shutil.rmtree(stale, ignore_errors=True)
                os.replace(final, stale)
                os.replace(tmp, final)
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.replace(tmp, final)
            _fsync_dir(final.parent)
            self._metrics["commit_ms"].labels(self.kind).observe(
                (time.perf_counter() - t0) * 1e3
            )
        except BaseException as exc:  # surfaces on the next wait()/save()
            with self._lock:
                self._error = exc
            shutil.rmtree(tmp, ignore_errors=True)
            logger.warning(f"async checkpoint commit of {final.name} failed: {exc!r}")
        finally:
            with self._lock:
                self._pending -= 1
                self._metrics["pending"].set(float(self._pending))

    def wait(self) -> None:
        """Block until the launched commit (if any) is durable; re-raises
        a background commit failure exactly once."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(
                "async checkpoint commit failed (the previous checkpoint is still the "
                "newest restorable one)"
            ) from error

    def close(self) -> None:
        """Best-effort drain: waits for the in-flight commit but only LOGS a
        failure — safe inside a trainer's ``finally``."""
        try:
            self.wait()
        except RuntimeError as exc:
            logger.warning(f"async checkpoint writer closed dirty: {exc}")

    def restore(self, path: Union[str, os.PathLike], target: Any) -> Any:
        """Restore a committed checkpoint dir into ``target``'s structure,
        each tensor on its target leaf's device and dtype. Refuses torn
        checkpoints: a dir without its commit marker raises."""
        t0 = time.perf_counter()
        self.wait()
        final = Path(path).absolute()
        if not final.is_dir():
            raise FileNotFoundError(f"no checkpoint at {final}")
        if not is_committed(final):
            raise ValueError(
                f"refusing torn checkpoint {final}: commit marker {COMMIT_MARKER!r} "
                "missing (crash mid-write or partial copy) — restore an earlier "
                "committed step instead"
            )
        data = final / _DATA_FILE
        saved = torch.load(data, map_location="cpu", weights_only=True)
        out = restore_into(target, saved)
        self._metrics["restore_ms"].labels(self.kind).observe((time.perf_counter() - t0) * 1e3)
        self._metrics["restore_bytes"].labels(self.kind).inc(data.stat().st_size)
        return out


class AsyncCheckpointManager:
    """Step-indexed checkpoint rotation over :class:`AsyncCheckpointWriter`
    (``save/restore/latest_step/wait/close``).

    - ``save`` stalls the caller for the snapshot only; the disk write
      overlaps the following training steps (``async_commit=False``
      commits inline — the overlap-off baseline);
    - ``latest_step``/``restore`` see only COMMITTED checkpoints, so a
      kill mid-commit resumes from the previous step (uncommitted
      ``*.tmp-*`` leftovers are swept at construction);
    - ``restore`` requires a ``state_target`` (the freshly initialized
      state) to restore into.
    """

    def __init__(
        self,
        root: Union[str, os.PathLike],
        *,
        max_to_keep: int = 3,
        async_commit: bool = True,
        registry: Optional[Any] = None,
        commit_hook: Optional[Callable[[Path], None]] = None,
    ):
        if max_to_keep is not None and max_to_keep < 0:
            raise ValueError(f"max_to_keep must be >= 0 or None, got {max_to_keep}")
        self.root = Path(root).absolute()
        self.max_to_keep = max_to_keep
        self.async_commit = async_commit
        self.root.mkdir(parents=True, exist_ok=True)
        self._writer = AsyncCheckpointWriter(registry=registry, commit_hook=commit_hook)
        # a crashed predecessor leaves *.tmp-* dirs: uncommitted, safe to
        # sweep (the atomic rename means a commit either fully happened or
        # left only this)
        for stale in self.root.glob("step_*.tmp-*"):
            shutil.rmtree(stale, ignore_errors=True)
        # a directory holding ONLY marker-less step dirs is another format
        # (the reference's Orbax checkpoints): resuming here would silently
        # restart from step 0, so refuse. With at least one committed step
        # the directory is ours, and a stray marker-less dir is a torn
        # copy, skipped per the restore contract
        markerless = [
            p.name for p in self.root.glob("step_*")
            if p.is_dir() and "tmp" not in p.name and not is_committed(p)
        ]
        if markerless and not self._steps():
            raise ValueError(
                f"{self.root} holds checkpoint dirs without commit markers "
                f"({sorted(markerless)[:3]}…): a format this manager cannot restore "
                "(sharded checkpoints: open them with make_checkpoint_manager(backend="
                "'orbax')) — "
                "resuming here would silently restart from step 0"
            )

    def _steps(self) -> List[int]:
        steps = []
        for p in self.root.glob("step_*"):
            try:
                step = int(p.name.split("_", 1)[1])
            except ValueError:
                continue  # in-flight *.tmp-* dirs and strangers
            if is_committed(p):
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest COMMITTED step (torn/in-flight dirs never count)."""
        steps = self._steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        if not self.max_to_keep:
            return  # 0/None keep everything
        # only COMMITTED dirs are counted and removed, never an in-flight
        # rename target
        for victim in self._steps()[: -self.max_to_keep or None]:
            shutil.rmtree(self.root / f"step_{victim}", ignore_errors=True)

    def save(self, step: int, state: Any) -> None:
        """Launch the commit of ``step``; the caller pays the snapshot (plus
        the wait for the previous commit, normally already done). With
        ``async_commit=False`` the commit runs inline on the caller's
        thread and its failure raises here."""
        self._prune()
        self._writer.save(self.root / f"step_{step}", state, inline=not self.async_commit)
        if not self.async_commit:
            self._writer.wait()

    def wait(self) -> None:
        """Strict barrier: block until every launched save is durable
        (re-raising background failures), then prune."""
        self._writer.wait()
        self._prune()

    def restore(self, state_target: Any = None, step: Optional[int] = None) -> Any:
        if state_target is None:
            raise ValueError(
                "AsyncCheckpointManager.restore needs a state_target: the checkpoint "
                "restores INTO a state (pass the freshly initialized state)"
            )
        self._writer.close()  # drain, but let restore pick the survivor
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {self.root}")
        return self._writer.restore(self.root / f"step_{step}", state_target)

    def close(self) -> None:
        """Best-effort drain + prune (logs, never raises)."""
        self._writer.close()
        self._prune()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_checkpoint_manager(
    root: Union[str, os.PathLike],
    *,
    max_to_keep: int = 3,
    backend: str = "auto",
    async_commit: bool = True,
    registry: Optional[Any] = None,
):
    """The checkpoint manager the trainer loops use.

    ``"auto"`` gives :class:`AsyncCheckpointManager` in one process and the
    sharded :class:`~unionml_tpu_torch.checkpoint.sharded.CheckpointManager`
    when the default process group has several ranks (each rank writes
    only its blocks), and stays sharded when ``root`` already holds
    sharded step dirs, so resuming an existing run never silently restarts
    from step 0. ``"async"`` / ``"orbax"`` force a side: ``"orbax"`` is the
    reference's name for the sharded manager, kept so app code carries
    over (the port writes its own format, not Orbax's). ``"sync"`` (or
    ``async_commit=False``) commits inline: the caller pays serialize +
    write + rename, the overlap-off baseline."""
    if backend not in ("auto", "async", "orbax", "sync"):
        raise ValueError(
            f"unknown checkpoint backend {backend!r}: expected 'auto', 'async', "
            "'orbax' or 'sync'"
        )
    if backend == "sync":
        backend, async_commit = "async", False
    if backend == "auto":
        import torch.distributed as dist

        multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        backend = "orbax" if multi else "async"
        if backend == "async":
            for p in Path(root).absolute().glob("step_*"):
                if "tmp" in p.name or not p.is_dir():
                    continue
                if not is_committed(p):
                    # pre-existing sharded checkpoints: stay sharded
                    backend = "orbax"
                    break
    if backend == "async":
        return AsyncCheckpointManager(root, max_to_keep=max_to_keep,
                                      async_commit=async_commit, registry=registry)
    from unionml_tpu_torch.checkpoint.sharded import CheckpointManager

    return CheckpointManager(root, max_to_keep=max_to_keep, async_save=async_commit,
                             registry=registry)
