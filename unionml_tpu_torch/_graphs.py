"""CUDA graphs: the capture shared by the captured predictor
(:class:`~unionml_tpu_torch.execution.GraphedPredictor`) and the decode
engine's compiled programs (:mod:`unionml_tpu_torch.serving._programs`).

:func:`capture` is the port's compile step, ``jax.jit``'s one executable
per static signature: the body runs once on a side stream (kernels built,
lazy state set up, cuBLAS's workspace for that stream made) under a
:class:`~unionml_tpu_torch.introspection.CostCounter`, then is recorded
into a CUDA graph on the same stream: one capture stream a device for
the process, taken by one capture at a time, as ``torch.cuda.graph``
shares one. cuBLAS keeps a workspace for every stream it has run on for
the life of the process, and a graph replays with the workspace of the
stream it was captured on: a stream for each capture or each owner
would leave one behind for every owner that came and went (a rollout's
canaries, an autoscaler's replicas). A :class:`Graph`'s replay credits
each kernel the launches its capture recorded (a capture launches
nothing) and charges a cost counter around it the warm-up's counted cost.
A body that cannot be captured raises, naming what was captured; nothing
falls back to running eagerly.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from unionml_tpu_torch.ops import _build

_STREAMS: Dict[int, torch.cuda.Stream] = {}
#: one capture at a time on the shared streams
_CAPTURING = threading.Lock()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class Graph:
    """One captured body: the graph, what its capture returned
    (``outputs``, the tensors a replay rewrites), what the warm-up call
    returned (``warm``), the kernel launches a replay makes and the
    ``(flops, bytes)`` the warm-up counted."""

    __slots__ = ("graph", "outputs", "warm", "launches", "cost")

    def __init__(self, graph, outputs: Any, warm: Any, launches: Dict[Any, int],
                 cost: tuple):
        self.graph, self.outputs, self.warm = graph, outputs, warm
        self.launches, self.cost = launches, cost

    def replay(self) -> Any:
        """Launch the graph on the current stream; returns ``outputs``."""
        with _build.charged(lambda: self.cost):
            self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n
        return self.outputs


def capture(body: Callable[[], Any], device: torch.device, what: str, *,
            pool: Optional[Any] = None, generators: Sequence[torch.Generator] = (),
            mode: str = "global", hint: str = "") -> Graph:
    """Warm ``body`` up and capture it (see the module docstring).

    ``pool``: a memory pool handle (``torch.cuda.graph_pool_handle()``)
    the graph allocates from, shared with other graphs of its owner; None
    gives it a pool of its own. ``generators``: CUDA generators the
    body draws from, registered with the graph so each replay draws fresh
    numbers. ``mode``: the capture's error mode (``"thread_local"`` lets
    other threads keep calling CUDA while this one captures). A failure
    raises ``RuntimeError`` naming ``what`` and the cause, then ``hint``.
    """
    with _CAPTURING:
        return _capture(body, device, what, pool, generators, mode, hint)


def _capture(body, device, what, pool, generators, mode, hint) -> Graph:
    from torch.utils._python_dispatch import _disable_current_modes

    from unionml_tpu_torch.introspection import CostCounter

    current = torch.cuda.current_stream(device)
    side = _capture_stream(device)
    side.wait_stream(current)
    counter = CostCounter()
    # the warm-up is counted alone: a counter of the caller's is charged at
    # the replays, as every later replay charges it
    with _disable_current_modes():
        with torch.cuda.device(device), torch.cuda.stream(side), counter:
            warm = body()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            for gen in generators:
                graph.register_generator_state(gen)
            with torch.cuda.device(device), torch.cuda.stream(side), \
                    _build.launches_recorded() as launched:
                graph.capture_begin(pool=pool, capture_error_mode=mode)
                try:
                    outputs = body()
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:
                        pass   # the body's error is the one to report
                    raise
                graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"{what} cannot be captured as a CUDA graph: {type(exc).__name__}: {exc}{hint}"
            ) from exc
    return Graph(graph, outputs, warm, launched, counter.cost)
