"""Sharded checkpoints for mid-training checkpoint/resume on a mesh.

The port of :mod:`unionml_tpu.checkpoint.sharded` in the port's own
format (no Orbax): a step directory holds one ``shard_<rank>.pt`` per
rank with the blocks of the state that rank owns (``torch.save``, read
with ``weights_only=True``), a ``meta.json`` (every leaf's path, global
shape and dtype, and the non-tensor leaves' values) and the commit
marker. A block that several ranks hold (a replicated dimension) is
written once, by the rank at coordinate 0 of those mesh dimensions.

Saves are asynchronous: ``save`` stalls the caller for the previous
commit and the device-to-host snapshot's enqueue; a background thread
waits for the copies and writes this rank's file into
``step_N.tmp-sharded``. Rank 0 then waits for every rank's file, writes
the metadata and the marker, and renames the directory to ``step_N``: a
preemption mid-write leaves only the tmp directory, and restore finds the
previous committed step. Restore re-places every leaf onto the target's
placements, whatever the saving mesh was: each rank reads the blocks
that overlap its own.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.checkpoint._metrics import checkpoint_metrics
from unionml_tpu_torch.parallel.compat import is_dtensor

__all__ = ["CheckpointManager", "restore_sharded", "save_sharded"]

COMMIT_MARKER = "_COMMITTED"
META_FILE = "meta.json"
KIND = "sharded"
#: How long rank 0 waits for the other ranks' files before the commit fails.
GATHER_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank_world() -> Tuple[int, int]:
    dist = _dist()
    return (dist.get_rank(), dist.get_world_size()) if dist is not None else (0, 1)


def _leaves(state: Any) -> List[Tuple[str, Any]]:
    from unionml_tpu_torch.parallel.sharding import _map_with_path

    out: List[Tuple[str, Any]] = []
    _map_with_path(lambda path, leaf: out.append((path, leaf)), state)
    return out


def _block(t: torch.Tensor) -> Tuple[List[Tuple[int, int]], bool]:
    """``(global bounds of this rank's block, whether this rank writes
    it)``: a DTensor's block is written by the rank at coordinate 0 of each
    mesh dim that does not shard it; a plain tensor by rank 0."""
    if not is_dtensor(t):
        return [(0, n) for n in t.shape], _rank_world()[0] == 0
    from torch.distributed.tensor import Shard

    from unionml_tpu_torch.parallel.sharding import local_slices

    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    owner = all(c == 0 for c, p in zip(coord, t.placements) if not isinstance(p, Shard))
    slices = local_slices(t.shape, mesh, t.placements)
    return [(s.start, s.stop) for s in slices], owner


def _snapshot(state: Any):
    """This rank's blocks on the host (copies enqueued on the current
    stream, waited for by the returned events), the metadata of every
    leaf, and the bytes this rank writes."""
    blocks: Dict[str, Tuple[List[Tuple[int, int]], torch.Tensor]] = {}
    meta: List[dict] = []
    devices = set()
    nbytes = 0
    with torch.no_grad():
        for path, leaf in _leaves(state):
            if not isinstance(leaf, torch.Tensor):
                meta.append({"path": path, "value": leaf})
                continue
            meta.append({"path": path, "shape": list(leaf.shape),
                         "dtype": str(leaf.dtype).replace("torch.", "")})
            bounds, owner = _block(leaf)
            if not owner:
                continue
            local = leaf.to_local() if is_dtensor(leaf) else leaf
            if local.is_cuda:
                devices.add(local.device)
                host = torch.empty(local.shape, dtype=local.dtype, pin_memory=True)
                host.copy_(local.detach(), non_blocking=True)
                local.record_stream(torch.cuda.current_stream(local.device))
            else:
                host = local.detach().clone()
            blocks[path] = (bounds, host)
            nbytes += host.nbytes
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return blocks, meta, events, nbytes


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def is_committed(path: Union[str, os.PathLike]) -> bool:
    """True iff ``path`` is a committed sharded checkpoint."""
    p = Path(path)
    return (p / COMMIT_MARKER).is_file() and (p / META_FILE).is_file()


def _write(final: Path, blocks, meta, events, rank: int, world: int,
           timeout_s: float = GATHER_TIMEOUT_S) -> None:
    """Write this rank's file; rank 0 then commits the step."""
    for event in events:
        event.synchronize()
    tmp = final.parent / f"{final.name}.tmp-sharded"
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / f"shard_{rank}.pt", "wb") as f:
        torch.save({path: {"bounds": bounds, "data": data}
                    for path, (bounds, data) in blocks.items()}, f)
        f.flush()
        os.fsync(f.fileno())
    (tmp / f"shard_{rank}.done").write_text("ok")
    if rank != 0:
        return
    deadline = time.monotonic() + timeout_s
    while not all((tmp / f"shard_{r}.done").is_file() for r in range(world)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{final.name}: not every rank wrote its shard in {timeout_s} s")
        time.sleep(0.01)
    with open(tmp / META_FILE, "w") as f:
        json.dump({"world": world, "leaves": meta}, f)
        f.flush()
        os.fsync(f.fileno())
    for r in range(world):
        (tmp / f"shard_{r}.done").unlink()
    (tmp / COMMIT_MARKER).write_text("ok")
    _fsync_dir(tmp)
    if final.is_dir():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(final.parent)


def _barrier() -> None:
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def _restore(path: Path, target: Any) -> Tuple[Any, int]:
    """``target`` (a state or tree) holding the checkpoint's values, each
    tensor leaf at its target placements and device; also the bytes read."""
    from torch.distributed.tensor import DTensor

    from unionml_tpu_torch.parallel.sharding import _map_with_path, local_slices

    if not is_committed(path):
        raise ValueError(
            f"refusing torn checkpoint {path}: commit marker {COMMIT_MARKER!r} or "
            f"{META_FILE} missing — restore an earlier committed step instead"
        )
    info = json.loads((path / META_FILE).read_text())
    meta = {m["path"]: m for m in info["leaves"]}
    shards = [torch.load(path / f"shard_{r}.pt", map_location="cpu", weights_only=True,
                         mmap=True) for r in range(info["world"])]
    read = 0

    def assemble(name: str, region: List[Tuple[int, int]], dtype) -> torch.Tensor:
        nonlocal read
        out = torch.empty([hi - lo for lo, hi in region], dtype=dtype)
        filled = 0
        for shard in shards:
            piece = shard.get(name)
            if piece is None:
                continue
            src, dst, count = [], [], 1
            for (lo, hi), (plo, phi) in zip(region, piece["bounds"]):
                a, b = max(lo, plo), min(hi, phi)
                if a >= b:
                    break
                src.append(slice(a - plo, b - plo))
                dst.append(slice(a - lo, b - lo))
                count *= b - a
            else:
                block = piece["data"][tuple(src)]
                out[tuple(dst)] = block.to(dtype)
                filled += count
                read += block.nbytes
        if filled != out.numel():
            raise ValueError(f"checkpoint {path} does not cover leaf {name!r}")
        return out

    def take(name: str, leaf: Any) -> Any:
        if name not in meta:
            raise ValueError(f"checkpoint {path} has no leaf {name!r} of the target state")
        saved = meta[name]
        if not isinstance(leaf, torch.Tensor):
            return saved.get("value", leaf)
        if list(leaf.shape) != saved.get("shape"):
            raise ValueError(
                f"checkpoint leaf {name!r} {saved.get('shape')} does not fit the "
                f"target's {list(leaf.shape)}"
            )
        if is_dtensor(leaf):
            slices = local_slices(leaf.shape, leaf.device_mesh, leaf.placements)
            local = assemble(name, [(s.start, s.stop) for s in slices], leaf.dtype)
            local = local.to(leaf.to_local().device)
            return DTensor.from_local(local, leaf.device_mesh, leaf.placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())
        return assemble(name, [(0, n) for n in leaf.shape], leaf.dtype).to(leaf.device)

    if target is None:
        out: Dict[str, Any] = {}
        for name, saved in meta.items():
            node = out
            *parents, last = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = saved["value"] if "value" in saved else assemble(
                name, [(0, n) for n in saved["shape"]], getattr(torch, saved["dtype"]))
        return out, read
    return _map_with_path(take, target), read


def save_sharded(path: Union[str, os.PathLike], state: Any, *, step: Optional[int] = None,
                 force: bool = True) -> None:
    """Write a sharded checkpoint of ``state`` (params + optimizer state),
    blocking; every rank calls it. Training loops use
    :class:`CheckpointManager` for overlapped saves."""
    path = Path(path).absolute()
    if step is not None:
        path = path / f"step_{step}"
    if path.exists() and not force:
        raise FileExistsError(f"checkpoint {path} exists (pass force=True to overwrite)")
    t0 = time.perf_counter()
    rank, world = _rank_world()
    blocks, meta, events, nbytes = _snapshot(state)
    _write(path, blocks, meta, events, rank, world)
    _barrier()
    metrics = checkpoint_metrics()
    metrics["save_ms"].labels(KIND).observe((time.perf_counter() - t0) * 1e3)
    metrics["save_bytes"].labels(KIND).inc(nbytes)


def restore_sharded(path: Union[str, os.PathLike], target: Any = None, *,
                    step: Optional[int] = None) -> Any:
    """Restore a sharded checkpoint onto ``target``'s placements and
    devices (a placed state, or a plain one); with no target, a nested dict
    of whole CPU tensors by path."""
    path = Path(path).absolute()
    if step is not None:
        path = path / f"step_{step}"
    t0 = time.perf_counter()
    out, read = _restore(path, target)
    metrics = checkpoint_metrics()
    metrics["restore_ms"].labels(KIND).observe((time.perf_counter() - t0) * 1e3)
    metrics["restore_bytes"].labels(KIND).inc(read)
    return out


class CheckpointManager:
    """Step-indexed rotation of sharded checkpoints under ``root``.

    Keeps the newest ``max_to_keep`` committed steps (``0`` or ``None``
    keeps all); ``latest_step()`` is the newest committed one. With
    ``async_save`` (default) ``save`` returns once the snapshot's copies
    are enqueued and the write runs on a background thread; one commit is
    in flight at a time, and pruning (rank 0) runs only after it. Call
    :meth:`wait` (or ``close``) before reading the newest step back. Every
    rank of the group calls every method. Publishes the
    ``unionml_checkpoint_*`` series with ``kind="sharded"``."""

    kind = KIND

    def __init__(self, root: Union[str, os.PathLike], *, max_to_keep: int = 3,
                 async_save: bool = True, registry: Optional[Any] = None):
        if max_to_keep is not None and max_to_keep < 0:
            raise ValueError(f"max_to_keep must be >= 0 or None, got {max_to_keep}")
        self.root = Path(root).absolute()
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.root.mkdir(parents=True, exist_ok=True)
        self._metrics = checkpoint_metrics(registry)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = 0
        self._lock = threading.Lock()

    def _steps(self) -> List[int]:
        steps = []
        for p in self.root.glob("step_*"):
            # in-flight writes live in `step_N.tmp-sharded`: the int()
            # parse skips them until the commit renames
            try:
                step = int(p.name.split("_", 1)[1])
            except ValueError:
                continue
            if is_committed(p):
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        if not self.max_to_keep or _rank_world()[0] != 0:
            return
        for victim in self._steps()[: -self.max_to_keep or None]:
            shutil.rmtree(self.root / f"step_{victim}", ignore_errors=True)

    def _join(self) -> None:
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(
                "sharded checkpoint commit failed (the previous checkpoint is still the "
                "newest restorable one)"
            ) from error

    def _commit(self, final: Path, blocks, meta, events, rank: int, world: int) -> None:
        t0 = time.perf_counter()
        try:
            _write(final, blocks, meta, events, rank, world)
            self._metrics["commit_ms"].labels(self.kind).observe(
                (time.perf_counter() - t0) * 1e3)
        except BaseException as exc:  # surfaces on the next wait()/save()
            with self._lock:
                self._error = exc
            logger.warning(f"sharded checkpoint commit of {final.name} failed: {exc!r}")
        finally:
            with self._lock:
                self._pending -= 1
                self._metrics["pending"].set(float(self._pending))

    def save(self, step: int, state: Any) -> None:
        """Snapshot this rank's blocks of ``state`` and launch their write
        as ``step_<step>``. The caller's stall is ``save_ms{kind="sharded"}``."""
        t0 = time.perf_counter()
        self._join()
        self._prune()
        rank, world = _rank_world()
        final = self.root / f"step_{step}"
        if rank == 0:
            shutil.rmtree(final.parent / f"{final.name}.tmp-sharded", ignore_errors=True)
        _barrier()  # no rank writes into a stale tmp dir
        blocks, meta, events, nbytes = _snapshot(state)
        with self._lock:
            self._pending += 1
            self._metrics["pending"].set(float(self._pending))
        if self.async_save:
            self._thread = threading.Thread(
                target=self._commit, args=(final, blocks, meta, events, rank, world),
                name=f"ckpt-sharded-{final.name}", daemon=True)
            self._thread.start()
        else:
            self._commit(final, blocks, meta, events, rank, world)
        self._metrics["save_ms"].labels(self.kind).observe((time.perf_counter() - t0) * 1e3)
        self._metrics["save_bytes"].labels(self.kind).inc(nbytes)

    def wait(self) -> None:
        """Block until every launched save has committed on every rank,
        then prune."""
        try:
            self._join()
        finally:
            _barrier()
        self._prune()
        _barrier()  # every rank sees the pruned directory

    def restore(self, state_target: Any = None, step: Optional[int] = None) -> Any:
        """The newest (or ``step``'s) checkpoint onto ``state_target``'s
        placements (see :func:`restore_sharded`)."""
        t0 = time.perf_counter()
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        out, read = _restore(self.root / f"step_{step}", state_target)
        self._metrics["restore_ms"].labels(self.kind).observe((time.perf_counter() - t0) * 1e3)
        self._metrics["restore_bytes"].labels(self.kind).inc(read)
        return out

    def close(self) -> None:
        """Drain the in-flight commit and prune; a failed commit is logged,
        never raised (safe in ``finally`` blocks)."""
        try:
            self.wait()
        except RuntimeError as exc:
            logger.warning(f"sharded checkpoint manager closed dirty: {exc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
