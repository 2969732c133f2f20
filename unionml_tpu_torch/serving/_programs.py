"""The decode engine's compiled programs: one CUDA graph per signature.

The reference compiles each of its engine's device programs once per
static signature (``jax.jit`` with the resident state donated); the port
captures each as a CUDA graph the first time a signature runs on the card
and replays it after that (:class:`EnginePrograms`). A program is a
function of tensors that updates the resident state in place, so its
graph reads and writes the same buffers on every replay: the state, the
per-bucket fresh caches and the weights are arguments whose identity is
part of the signature, and the host inputs of a call (the active-slot
mask, the block table, an admission's slot, pool block ids, tokens,
offset and length) are copied into the graph's static input buffers on
the replay's stream. Every graph of an engine allocates from one memory
pool; the state and the fresh caches are allocated before any capture,
outside it.

On the CPU, under :func:`~unionml_tpu_torch.diagnostics.nan_guard` (whose
checks read values on the host; ROADMAP.md C17), and with the private
seam ``EnginePrograms.eager`` set, the same programs run eagerly.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from unionml_tpu_torch import _graphs
from unionml_tpu_torch.ops import _build


def _host(arr: np.ndarray) -> torch.Tensor:
    # np.ascontiguousarray makes a 0-d array 1-d: keep the shape
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(np.shape(arr)))


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: a FRESH
    pinned copy per call, sent with ``non_blocking`` (PyTorch's pinned
    allocator keeps the block from reuse until the copy has run, so an
    upload still in flight can never see its source overwritten)."""
    host = _host(arr)
    if device.type != "cuda":
        return host.clone().to(device)
    return host.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, arr: np.ndarray) -> None:
    """A host array copied into the device buffer ``dst`` on the current
    stream without waiting for the device (a fresh pinned copy, as
    :func:`upload`)."""
    host = _host(arr)
    if dst.is_cuda:
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


class _Entry:
    """A captured program and what its graph holds: the static input
    buffers and the arguments (params, state, fresh caches) it read, kept
    alive so their identities in the key are never reused."""

    __slots__ = ("graph", "inputs", "refs", "capture_ms", "replays")

    def __init__(self, graph, inputs, refs, capture_ms: float):
        self.graph, self.inputs, self.refs = graph, inputs, refs
        self.capture_ms = capture_ms
        self.replays = 0


class EnginePrograms:
    """One engine's program cache (see the module docstring).

    :meth:`run` runs program ``fn(*args, *inputs)``: on the card, the
    graph of its signature (captured at the first call, whose warm-up is
    that call's work and the tracker's compile event), else eagerly.
    ``capture`` is the function that captures (a test replaces it to
    check the bookkeeping without a card, with ``capturable`` set)."""

    def __init__(self, device: torch.device, name: str,
                 generators: Sequence[torch.Generator] = ()):
        self.device = device
        self.name = name
        self.generators = tuple(generators)
        self.capturable = device.type == "cuda"
        #: the private seam: run every program eagerly (tests, the smoke's
        #: eager-vs-replayed comparison)
        self.eager = False
        self.capture: Callable[..., Any] = _graphs.capture
        self._graphs: Dict[Any, _Entry] = {}
        self._lock = threading.Lock()
        self._pool = None

    def active(self) -> bool:
        """Whether programs run as graphs now: on the card, no NaN guard
        open (its checks read values, which a replay cannot: C17), and the
        eager seam unset."""
        return self.capturable and not self.eager and not _build.NAN_GUARD

    @property
    def pool(self):
        """The memory pool handle every graph of the engine shares (None
        before the first capture and whenever no graph is held)."""
        return self._pool

    def keys(self) -> list:
        with self._lock:
            return list(self._graphs)

    def __len__(self) -> int:
        with self._lock:
            return len(self._graphs)

    def stats(self) -> dict:
        """Captures, their host ms and replays per program."""
        out: Dict[str, dict] = {}
        with self._lock:
            entries = list(self._graphs.items())
        for key, e in entries:
            s = out.setdefault(key[0], {"graphs": 0, "capture_ms": [], "replays": 0})
            s["graphs"] += 1
            s["capture_ms"].append(e.capture_ms)
            s["replays"] += e.replays
        return out

    def run(self, program: str, key: tuple, fn: Callable, args: tuple,
            host: Sequence[np.ndarray], *, tracker=None, sig: Any = None) -> Any:
        """Program ``fn`` on ``args`` and the host arrays ``host`` (each put
        on the device). ``key`` is the signature beyond the arguments'
        identities; ``tracker`` / ``sig`` the program's
        :class:`~unionml_tpu_torch.introspection.ProgramTracker` entry (the
        eager path's own wrapper records it there)."""
        if not self.active():
            return fn(*args, *(upload(h, self.device) for h in host))
        key = (program, *key, *(id(a) for a in args))
        body_fn = getattr(fn, "__wrapped__", fn)
        with self._lock:
            entry = self._graphs.get(key)
        t0 = time.perf_counter()
        if entry is None:
            inputs = [upload(h, self.device) for h in host]
            if self._pool is None:
                # (a stubbed capture off the card gets a stand-in handle)
                cuda = self.device.type == "cuda"
                self._pool = torch.cuda.graph_pool_handle() if cuda else object()
            try:
                graph = self.capture(
                    lambda: body_fn(*args, *inputs), self.device,
                    f"engine program {program!r} of {self.name}",
                    pool=self._pool, generators=self.generators,
                    mode="thread_local",
                )
            except BaseException:
                # a pool no graph holds cannot be shared (see drop)
                with self._lock:
                    if not self._graphs:
                        self._pool = None
                raise
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._graphs[key] = _Entry(graph, inputs, args, ms)
            if tracker is not None:
                tracker.record_compile(program, sig, graph.cost, ms)
            # the warm-up ran this call's work; the capture only recorded it
            return graph.warm
        for dst, h in zip(entry.inputs, host):
            upload_into(dst, h)
        out = entry.graph.replay()
        entry.replays += 1
        if tracker is not None:
            tracker.record_call(program, sig, (time.perf_counter() - t0) * 1e3)
        return out

    def drop(self, keep: Optional[Callable[[Any, tuple], bool]] = None) -> int:
        """Drop every graph (or those ``keep(key, refs)`` rejects); returns
        how many went. A graph in flight on the card finishes first. With
        no graph left the pool handle goes too: the allocator refuses to
        share a pool that no live graph holds, so the next capture takes a
        new one (the old pool's segments go at the next ``empty_cache``)."""
        with self._lock:
            gone = [k for k, e in self._graphs.items() if keep is None or not keep(k, e.refs)]
            for k in gone:
                del self._graphs[k]
            if not self._graphs:
                self._pool = None
        return len(gone)

    def close(self) -> None:
        """Drop every graph and the pool (its segments are freed at the
        allocator's next ``empty_cache``)."""
        self.drop()


def pool_bytes(pool) -> int:
    """Bytes of the card's memory segments in the graph memory pool
    ``pool`` (an :attr:`EnginePrograms.pool` handle taken while it was
    live): what its graphs hold, and after they are dropped and the
    allocator's ``empty_cache`` has run, 0."""
    if pool is None or not isinstance(pool, tuple):
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))
