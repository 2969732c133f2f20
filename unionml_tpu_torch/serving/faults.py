"""Fault-tolerance primitives for the serving layer.

The reference delegates every failure to Flyte retries and has no
overload story at all (SURVEY.md §5.3); this module is the serving-side
analog of the elastic trainer's ``fault_hook`` seam
(:mod:`unionml_tpu_torch.elastic`): a small, dependency-free vocabulary that
makes every failure mode **typed**, **deterministic**, and therefore
**CPU-testable**:

- typed serving errors the transports map to HTTP statuses —
  :class:`Overloaded` (429 + ``Retry-After``),
  :class:`EngineUnavailable` (503: circuit breaker open or draining),
  :class:`DeadlineExceeded` (504: the request's deadline expired before
  the device ran it);
- a request-deadline **propagation channel**
  (:func:`deadline_scope` / :func:`current_deadline_ms`): the HTTP
  layer parses ``X-Deadline-Ms`` and opens a scope around the
  predictor call, so the engine and batcher pick the deadline up
  without every predictor wrapper in between having to thread a
  kwarg through its signature (submissions happen on the request's
  own thread in both transports);
- :class:`FaultInjector` — the chaos harness. Deterministic, seeded
  injection points the engine and batcher ``fire()`` at their
  structurally interesting moments (program dispatch, harvest,
  dequeue), so tier-1 tests can reproduce a device-program crash, a
  slow harvest, a queue stall, or an OOM-shaped XLA error on CPU,
  byte-for-byte the same on every run (docs/robustness.md).
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

__all__ = [
    "DeadlineExceeded",
    "EngineUnavailable",
    "FaultInjector",
    "INJECTION_POINTS",
    "Overloaded",
    "current_deadline_ms",
    "deadline_scope",
    "http_fault_response",
    "parse_deadline_header",
    "xla_oom_error",
]

# the injection points the engine/batcher fire, for discoverability
# (arming an unknown point is an error — a typo'd chaos test would
# otherwise silently inject nothing and pass vacuously)
INJECTION_POINTS = (
    "engine.prefill",    # before a prefill/admission program dispatch
    "engine.dispatch",   # before a decode-chunk program dispatch
    "engine.harvest",    # before a readback is materialized
    "engine.dequeue",    # before the dispatcher pops the next request
    "batcher.predict",   # before the batcher's shared device call
)


class Overloaded(RuntimeError):
    """Admission refused: the bounded queue is full. Retry later.

    ``retry_after_s`` is the transport's ``Retry-After`` hint."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class EngineUnavailable(RuntimeError):
    """Admission refused fast: circuit breaker open, or draining.

    ``reason`` is ``"breaker_open"`` or ``"draining"``;
    ``retry_after_s`` is the transport's ``Retry-After`` hint (the
    breaker's remaining cooldown, or a drain-poll interval)."""

    def __init__(
        self, message: str, *, reason: str = "unavailable",
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before the device served it.

    Raised at **dequeue**, not submit: an expired request is shed before
    it consumes prefill, which is the whole point of deadlines under
    overload (finishing it would burn device time on an answer the
    client already stopped waiting for)."""

    def __init__(self, message: str, *, deadline_ms: Optional[float] = None):
        super().__init__(message)
        self.deadline_ms = deadline_ms


def http_fault_response(exc: BaseException):
    """Map a typed serving error to ``(status, extra_headers)`` — the
    ONE definition of the HTTP contract, consumed by both transports so
    they cannot drift: :class:`Overloaded` → 429 + ``Retry-After``,
    :class:`EngineUnavailable` → 503 + ``Retry-After``,
    :class:`DeadlineExceeded` → 504. Returns ``None`` for anything
    else. ``Retry-After`` is whole seconds >= 1 (the header is
    integer-valued)."""
    if isinstance(exc, (Overloaded, EngineUnavailable)):
        retry = str(max(1, math.ceil(getattr(exc, "retry_after_s", 1.0))))
        return (
            429 if isinstance(exc, Overloaded) else 503,
            {"Retry-After": retry},
        )
    if isinstance(exc, DeadlineExceeded):
        return 504, {}
    return None


def xla_oom_error(nbytes: int = 8 << 30) -> RuntimeError:
    """An OOM-shaped device error for chaos tests: the message matches
    what benchmarks/serve_latency.py's OOM detection looks for in real
    XLA ``RESOURCE_EXHAUSTED`` failures, so harness-injected OOMs walk
    the same string-matching paths production errors do."""
    return RuntimeError(
        f"RESOURCE_EXHAUSTED: Out of memory allocating {nbytes} bytes "
        "(injected by unionml_tpu_torch.serving.faults.FaultInjector)"
    )


# --------------------------------------------------------------------- #
# deadline propagation (thread-local: submissions run on the request's
# own thread in both the stdlib and FastAPI-sync transports)
# --------------------------------------------------------------------- #

_deadline_tls = threading.local()


@contextmanager
def deadline_scope(deadline_ms: Optional[float]) -> Iterator[None]:
    """Expose ``deadline_ms`` to engine/batcher submissions made on this
    thread (``None`` is a no-op scope). Scopes nest; the innermost wins."""
    if deadline_ms is not None and deadline_ms <= 0:
        raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
    prev = getattr(_deadline_tls, "deadline_ms", None)
    _deadline_tls.deadline_ms = deadline_ms
    try:
        yield
    finally:
        _deadline_tls.deadline_ms = prev


def current_deadline_ms() -> Optional[float]:
    """The innermost :func:`deadline_scope` value on this thread."""
    return getattr(_deadline_tls, "deadline_ms", None)


def parse_deadline_header(raw: Optional[str]) -> Optional[float]:
    """Parse an ``X-Deadline-Ms`` header value — the ONE parser both
    HTTP transports use, so the header contract cannot drift between
    them. ``None`` (absent header) passes through; anything that is not
    a finite positive number raises ``ValueError`` (NaN/inf would
    silently disable shedding — a malformed deadline must be a 422, not
    a no-deadline)."""
    if raw is None:
        return None
    try:
        value = float(raw)
    except ValueError:
        value = math.nan
    if not math.isfinite(value) or value <= 0:
        raise ValueError(
            "X-Deadline-Ms must be a positive number of milliseconds, "
            f"got {raw!r}"
        )
    return value


# --------------------------------------------------------------------- #
# chaos injection
# --------------------------------------------------------------------- #


class _Plan:
    __slots__ = ("after", "count", "exc", "delay_s", "injected")

    def __init__(self, after: int, count: int,
                 exc: Optional[BaseException], delay_s: float):
        self.after = after      # absolute hit index the plan starts at
        self.count = count      # injections before the plan disarms
        self.exc = exc
        self.delay_s = delay_s
        self.injected = 0


class FaultInjector:
    """Deterministic, seeded chaos-injection points.

    The engine and batcher call :meth:`fire` at fixed structural points
    (:data:`INJECTION_POINTS`); a test :meth:`arm`\\ s a point to raise
    an exception and/or sleep on the *nth subsequent* firing. All
    scheduling is hit-count based — never wall-clock or RNG draws at
    fire time — so a chaos test replays identically on every run and
    every host. (``seed`` is reserved for future probabilistic plans;
    the deterministic counters are what tier-1 relies on.)

    Thread-safe: fire sites live on the engine's dispatcher/harvester
    threads while tests arm from the main thread.

    Example::

        fi = FaultInjector()
        engine = DecodeEngine(module, ..., fault_injector=fi)
        ...                       # traffic running
        fi.arm("engine.dispatch", exc=faults.xla_oom_error())
        # the NEXT decode-chunk dispatch raises the OOM-shaped error;
        # the engine fails only the poisoned batch and recovers.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._injections: Dict[str, int] = {}
        self._plans: Dict[str, _Plan] = {}

    def arm(
        self,
        point: str,
        *,
        nth: int = 1,
        count: int = 1,
        exc: Optional[BaseException] = None,
        delay_s: float = 0.0,
    ) -> None:
        """Schedule an injection at ``point``: the ``nth`` firing after
        this call (1 = the very next) injects, and the following
        ``count - 1`` firings do too. ``exc`` raises (after sleeping
        ``delay_s`` — both together model a slow-then-dead program);
        ``delay_s`` alone models a stall (slow harvest, queue stall)."""
        if point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {point!r} — known points: "
                f"{INJECTION_POINTS}"
            )
        if nth < 1 or count < 1:
            raise ValueError("nth and count must be >= 1")
        if exc is None and delay_s <= 0.0:
            raise ValueError("arm() needs an exc and/or a positive delay_s")
        with self._lock:
            self._plans[point] = _Plan(
                after=self._hits.get(point, 0) + nth - 1,
                count=count, exc=exc, delay_s=delay_s,
            )

    def disarm(self, point: Optional[str] = None) -> None:
        """Cancel the plan at ``point`` (all points when ``None``)."""
        with self._lock:
            if point is None:
                self._plans.clear()
            else:
                self._plans.pop(point, None)

    def fire(self, point: str) -> None:
        """An injection site: count the hit, inject if a plan says so.
        Cheap and lock-short when nothing is armed (the production
        no-injector path never even gets here — the engine guards on
        ``fault_injector is None``)."""
        with self._lock:
            self._hits[point] = self._hits.get(point, 0) + 1
            plan = self._plans.get(point)
            if plan is None or self._hits[point] <= plan.after:
                return
            plan.injected += 1
            self._injections[point] = self._injections.get(point, 0) + 1
            if plan.injected >= plan.count:
                del self._plans[point]
            exc, delay_s = plan.exc, plan.delay_s
        if delay_s > 0.0:
            time.sleep(delay_s)
        if exc is not None:
            raise exc

    def fired(self, point: str) -> int:
        """Hits observed at ``point`` (armed or not)."""
        with self._lock:
            return self._hits.get(point, 0)

    def injected(self, point: str) -> int:
        """Injections actually performed at ``point``."""
        with self._lock:
            return self._injections.get(point, 0)
