"""On-device micro-batcher: coalesce requests, pad to buckets, one call.

No reference counterpart — unionml/fastapi.py:50-64 runs one predictor
call per HTTP request. On TPU that wastes the MXU (batch-1 matmuls) and
pays dispatch latency per request. This batcher:

1. queues concurrent requests,
2. drains up to ``max_batch_size`` of them (waiting at most
   ``max_wait_ms`` after the first arrival),
3. concatenates features along the batch axis and right-pads to the next
   **bucket size** so XLA compiles exactly ``len(buckets)`` executables
   (SURVEY.md §7 hard part (e): bucketed shapes vs. recompilation),
4. runs the predictor once, splits results back per-request.

Thread-based (works under any transport, stdlib or ASGI); the device call
itself is serialized, which is the desired behavior on a single chip.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops._build import nan_scope
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    current_deadline_ms,
)
from unionml_tpu_torch.serving.usage import DEFAULT_TENANT, current_tenant

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# batch-size histogram bounds: the row counts are small powers of two
# (bucketed shapes), so the ms buckets would waste resolution
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _tree_leaves(tree: Any) -> list:
    """Leaves of a nested list/tuple/dict structure (any other object,
    arrays included, is a leaf) in depth-first order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise across structurally identical nested
    list/tuple/dict trees, keeping the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)
        )
    return fn(tree, *rest)


def _leading_dim(features: Any, row_lists: bool) -> int:
    if row_lists:
        return len(features)
    leaves = _tree_leaves(features)
    return int(leaves[0].shape[0]) if leaves else 0


def _concat(items: Sequence[Any], row_lists: bool) -> Any:
    if row_lists:
        out: list = []
        for i in items:
            out.extend(i)
        return out
    return _tree_map(lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0), *items)


def _pad_to(features: Any, n: int, row_lists: bool) -> Any:
    if row_lists:
        # replicate the last row; the split below drops padded results
        return list(features) + [features[-1]] * (n - len(features))

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] >= n:
            return x
        pad_width = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width, mode="edge")

    return _tree_map(pad, features)


def _slice_rows(result: Any, start: int, stop: int, row_lists: bool) -> Any:
    if row_lists:
        return list(result)[start:stop]
    # array mode: lists/tuples/dicts are tree STRUCTURE; every leaf
    # slices along its batch axis
    return _tree_map(lambda x: np.asarray(x)[start:stop], result)


@dataclass
class _Pending:
    features: Any
    rows: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    submitted: float = 0.0
    queue_wait_ms: float = 0.0
    device_ms: float = 0.0
    # waiter gave up (submit timeout): skip at drain time instead of
    # burning a device call on a result nobody will read (mirrors the
    # engine's req.abandoned convention)
    abandoned: bool = False
    # absolute perf_counter deadline (None = none): enforced at drain,
    # so an expired entry is shed before joining a device batch
    deadline: Optional[float] = None
    # telemetry trace timeline (created on the submitting thread, so it
    # inherits the transport's W3C trace scope): queue + predict spans
    rid: str = ""
    # usage metering: the validated tenant this entry's share of the
    # batched device call is billed to (the ambient tenant_scope)
    tenant: str = DEFAULT_TENANT


class MicroBatcher:
    """Coalesce concurrent predict calls into bucketed device batches."""

    def __init__(
        self,
        predict_fn: Callable[[Any], Any],
        *,
        max_batch_size: int = 64,
        max_wait_ms: float = 5.0,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        row_lists: bool = False,
        registry: Optional[telemetry.MetricsRegistry] = None,
        tracer: Optional[telemetry.TraceRecorder] = None,
        max_queue_depth: Optional[int] = None,
        fault_injector=None,
        introspect: bool = True,
        flight=None,
        usage=None,
    ):
        """``row_lists=True``: features/results are plain Python lists of
        per-example rows (possibly ragged — LLM token-id prompts), so the
        batcher coalesces by list concat instead of array concat. Use for
        predictors with the make_lm_predictor contract.

        ``registry``: explicit telemetry sink; defaults to the
        process-global registry so ``GET /metrics`` covers this batcher
        (series isolated per instance by the ``batcher`` label).

        ``tracer``: explicit :class:`~unionml_tpu_torch.telemetry
        .TraceRecorder`; defaults to the process-global one. Every
        ``submit()`` opens a request timeline on the SUBMITTING thread
        — so it joins the transport's W3C
        :func:`~unionml_tpu_torch.telemetry.trace_scope` when one is open —
        and records ``queue`` and ``predict`` spans around the shared
        device call.

        ``max_queue_depth``: admission control — a ``submit()`` that
        would push the not-yet-batched queue past this many entries
        raises :class:`~unionml_tpu_torch.serving.faults.Overloaded` instead
        of queueing forever (the transports map it to HTTP 429 with
        ``Retry-After``). ``None`` keeps the historical unbounded queue.

        ``fault_injector``: a :class:`~unionml_tpu_torch.serving.faults
        .FaultInjector` whose ``batcher.predict`` point fires before
        the shared device call (chaos tests; ``None`` is zero-cost).

        ``introspect``: wrap the predictor in a
        :class:`~unionml_tpu_torch.introspection.ProgramTracker`
        (``batcher.predict``: calls, and the FLOPs and bytes counted at
        each bucket's first call, behind ``stats()["programs"]`` and
        ``/metrics``) and record request lifecycle events into ``flight``
        (default: the process-global
        :class:`~unionml_tpu_torch.telemetry.FlightRecorder` behind
        ``GET /debug/flight``). ``False`` disables both and leaves the
        predictor unwrapped.

        ``usage``: a :class:`~unionml_tpu_torch.serving.usage.UsageLedger`
        (or ``True`` for a default one on this batcher's registry)
        enabling per-tenant usage metering: each entry's queue wait,
        row count, and share of the batched device call (device-seconds,
        split by row share) are billed to the
        ambient :func:`~unionml_tpu_torch.serving.usage.tenant_scope` tenant;
        ``None`` (default) disables metering."""
        self._predict_fn = predict_fn
        self.row_lists = row_lists
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.buckets = tuple(sorted(set(buckets) | {max_batch_size}))
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 when set")
        self.max_queue_depth = max_queue_depth
        self._faults = fault_injector
        self._draining = False
        # admission lock: depth-check + enqueue must be atomic, or N
        # concurrent submitters each pass the check and push the queue
        # past the bound. _pending counts undisposed entries (queued OR
        # inside the worker's device call) — what drain() must wait on;
        # queue.empty() alone returns early while the last batch is
        # still on device.
        self._admit_lock = threading.Lock()
        self._pending = 0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._registry = registry if registry is not None else telemetry.get_registry()
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self.instance = telemetry.instance_label("batcher")
        self._build_instruments()
        # program tracking + flight recording (docs/observability.md):
        # introspect=False leaves the predictor unwrapped and every flight
        # site a single None check.
        self.introspect = bool(introspect)
        if usage is True:
            from unionml_tpu_torch.serving.usage import UsageLedger

            usage = UsageLedger(registry=self._registry)
        self._usage = usage or None
        self._flight = None
        self._programs = None
        if self.introspect:
            from unionml_tpu_torch.introspection import ProgramTracker

            self._flight = (
                flight if flight is not None
                else telemetry.get_flight_recorder()
            )
            self._programs = ProgramTracker(registry=self._registry, component=self.instance)
            self._predict_fn = self._programs.wrap(
                "batcher.predict", self._predict_fn,
                # cheap per-call signature: the padded bucket size (row
                # lists) or the leading array shape; pytree features
                # fall back to single-signature attribution
                sig_fn=(
                    (lambda feats: len(feats)) if row_lists
                    else (lambda feats: getattr(feats, "shape", None))
                ),
            )
        self._worker = threading.Thread(target=self._run, daemon=True, name="unionml-tpu-batcher")
        self._worker.start()

    def _build_instruments(self):
        R, lbl = self._registry, {"batcher": self.instance}

        def counter(name, help):
            return R.counter(name, help, ("batcher",)).labels(**lbl)

        self._m_requests = counter(
            "unionml_batcher_requests_total",
            "Requests completed through a batched device call.",
        )
        self._m_errors = counter(
            "unionml_batcher_errors_total",
            "Requests failed by a predictor/batcher error.",
        )
        self._m_abandoned = counter(
            "unionml_batcher_abandoned_total",
            "Requests whose submit() timed out before the batch ran "
            "(skipped at drain time, no device call burned).",
        )
        self._m_batches = counter(
            "unionml_batcher_batches_total", "Batched device calls.",
        )
        self._m_rows = counter(
            "unionml_batcher_batched_rows_total",
            "Rows coalesced into batched device calls.",
        )
        self._h_batch = R.histogram(
            "unionml_batcher_batch_rows",
            "Rows per batched device call (pre-padding).",
            ("batcher",), buckets=BATCH_SIZE_BUCKETS,
        ).labels(**lbl)
        self._h_queue = R.histogram(
            "unionml_batcher_queue_wait_ms",
            "Submit-to-batch-start wait per request.", ("batcher",),
        ).labels(**lbl)
        self._h_device = R.histogram(
            "unionml_batcher_device_ms",
            "Shared batched device-call time per request.", ("batcher",),
        ).labels(**lbl)
        rejected = R.counter(
            "unionml_batcher_rejected_total",
            "submit() calls rejected at admission control, by reason "
            "(queue_full -> 429, draining -> 503).",
            ("batcher", "reason"),
        )
        self._m_rejected = {
            reason: rejected.labels(batcher=self.instance, reason=reason)
            for reason in ("queue_full", "draining")
        }
        self._m_deadline_shed = counter(
            "unionml_batcher_deadline_shed_total",
            "Entries shed at batch-drain time because their deadline "
            "expired before the device call.",
        )
        self._g_queue_depth = R.gauge(
            "unionml_batcher_queue_depth",
            "Entries queued awaiting a batch.", ("batcher",),
        ).labels(**lbl)

    def _flight_rec(self, kind: str, **fields) -> None:
        """O(1) flight-recorder append (no-op when introspect=False)."""
        if self._flight is not None:
            self._flight.record(kind, batcher=self.instance, **fields)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(
        self,
        features: Any,
        timeout: Optional[float] = 60.0,
        *,
        deadline_ms: Optional[float] = None,
    ) -> Any:
        """Block until the batched prediction for ``features`` is ready.

        A timed-out submit marks its entry **abandoned**: the worker
        skips it at drain time (``batcher_abandoned_total``) instead of
        burning a device call on a result nobody will read.

        Admission control: while draining, raises
        :class:`~unionml_tpu_torch.serving.faults.EngineUnavailable`; with
        ``max_queue_depth`` set and the queue full, raises
        :class:`~unionml_tpu_torch.serving.faults.Overloaded`. A deadline
        (explicit ``deadline_ms``, or the ambient
        :func:`~unionml_tpu_torch.serving.faults.deadline_scope` the HTTP
        layer opens from ``X-Deadline-Ms``) sheds the entry with
        :class:`~unionml_tpu_torch.serving.faults.DeadlineExceeded` if it
        expires before the device call starts."""
        if deadline_ms is None:
            deadline_ms = current_deadline_ms()
        pending = _Pending(
            features=features, rows=_leading_dim(features, self.row_lists),
            submitted=time.perf_counter(), tenant=current_tenant(),
        )
        if deadline_ms is not None:
            pending.deadline = pending.submitted + deadline_ms / 1e3
        with self._admit_lock:
            if self._draining:
                self._m_rejected["draining"].inc()
                if self._usage is not None:
                    self._usage.record_rejected(pending.tenant, "draining")
                self._flight_rec(
                    "reject", reason="draining", tenant=pending.tenant,
                )
                raise EngineUnavailable(
                    "micro-batcher is draining and not accepting requests",
                    reason="draining", retry_after_s=1.0,
                )
            if self.max_queue_depth is not None:
                depth = self._queue.qsize()
                if depth >= self.max_queue_depth:
                    self._m_rejected["queue_full"].inc()
                    if self._usage is not None:
                        self._usage.record_rejected(
                            pending.tenant, "queue_full"
                        )
                    self._flight_rec(
                        "reject", reason="queue_full", queue_depth=depth,
                        tenant=pending.tenant,
                    )
                    raise Overloaded(
                        f"micro-batcher queue is full ({depth} queued >= "
                        f"max_queue_depth {self.max_queue_depth})",
                        retry_after_s=max(0.1, self.max_wait_s),
                    )
            # recorded BEFORE the put (the worker drains the queue
            # without this lock): the entry's 'submit' flight event
            # always precedes its 'batch'/'drop'. queue_depth = entries
            # ahead of this one.
            # created on the submitting thread INSIDE admission: it
            # inherits the transport's ambient trace scope, and a
            # rejected submit never opens a timeline to leak
            pending.rid = self._tracer.new_request(
                "batch", batcher=self.instance, rows=pending.rows
            )
            self._flight_rec(
                "submit", rows=pending.rows, tenant=pending.tenant,
                queue_depth=self._queue.qsize(),
            )
            self._queue.put(pending)
            self._pending += 1
        self._g_queue_depth.set(self._queue.qsize())
        if not pending.event.wait(timeout):
            pending.abandoned = True
            raise TimeoutError("micro-batcher did not produce a result in time")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def health(self) -> dict:
        """Readiness surface for ``GET /health`` (same shape as
        :meth:`DecodeEngine.health <unionml_tpu_torch.serving.engine
        .DecodeEngine.health>`; the batcher has no device state to
        rebuild, so no circuit breaker — ``breaker_open`` is always
        False)."""
        return {
            "status": "draining" if self._draining else "ok",
            "queue_depth": self._queue.qsize(),
            "breaker_open": False,
        }

    def _dispose(self, n: int = 1) -> None:
        """An entry left the system (delivered, errored, shed, or
        skipped as abandoned): retire its drain() obligation."""
        with self._admit_lock:
            self._pending -= n

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting (``submit()`` raises
        :class:`~unionml_tpu_torch.serving.faults.EngineUnavailable`), then
        block until every accepted entry has been **delivered** — the
        pending count covers the batch inside the device call too, not
        just the queue (a cold compile can hold it for seconds; a
        queue-only check would hand shutdown a worker mid-call).
        Returns True when drained, False on ``timeout``."""
        t0 = time.perf_counter()
        self._draining = True
        while True:
            with self._admit_lock:
                if self._pending == 0:
                    return True
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return False
            time.sleep(0.005)

    def resume(self) -> None:
        """Reopen admissions after :meth:`drain`."""
        self._draining = False

    def stats(self) -> dict:
        """Serving observability: queue-wait vs device-time split.

        A thin view over this instance's telemetry-registry series (the
        same numbers ``GET /metrics`` exposes), keeping the historical
        key shape."""
        batches = int(self._m_batches.value)
        out = {
            "engine": "micro-batch",
            "completed_requests": int(self._m_requests.value),
            "batches": batches,
            "mean_batch_rows": round(
                int(self._m_rows.value) / max(1, batches), 2
            ),
            "robustness": {
                "queue_depth": self._queue.qsize(),
                "rejected": {
                    reason: int(c.value)
                    for reason, c in self._m_rejected.items()
                },
                "deadline_shed": int(self._m_deadline_shed.value),
                "draining": self._draining,
            },
        }
        if self._usage is not None:
            out["usage"] = self._usage.stats()
        if self._programs is not None:
            out["programs"] = self._programs.stats()
        for name, h in (
            ("queue_wait_ms", self._h_queue), ("device_ms", self._h_device)
        ):
            summary = h.summary()
            if summary:
                out[name] = summary
        return out

    def reset_stats(self) -> None:
        """Zero this instance's observability series (benchmarks call
        this between scenarios so each phase's /stats describes only
        that phase); scrapers see the resets as counter restarts."""
        for m in (
            self._m_requests, self._m_errors, self._m_abandoned,
            self._m_batches, self._m_rows, self._m_deadline_shed,
            *self._m_rejected.values(), self._h_batch, self._h_queue,
            self._h_device,
        ):
            m.reset()
        if self._usage is not None:
            self._usage.reset_stats()
        if self._programs is not None:
            self._programs.reset()

    def close(self):
        self._stop.set()
        self._worker.join(timeout=1.0)
        # fail fast for requests still queued instead of letting their
        # submit() calls block until timeout
        while True:
            try:
                pending = self._queue.get_nowait()
            except queue.Empty:
                break
            pending.error = RuntimeError("micro-batcher closed")
            self._tracer.finish_request(pending.rid)
            pending.event.set()
            self._dispose()

    # ------------------------------------------------------------------ #

    def _shed_dead(self, p: _Pending) -> bool:
        """Drop an entry nobody benefits from batching: abandoned
        (waiter gone) or deadline-expired (shed with a typed error
        BEFORE it joins a device batch — the admission-control
        contract). Returns True when the entry was shed."""
        if p.abandoned:
            self._m_abandoned.inc()
            if self._usage is not None:
                self._usage.record_drop(p.tenant, "abandoned")
            self._flight_rec(
                "drop", cause="abandoned", rows=p.rows, tenant=p.tenant,
            )
            self._tracer.finish_request(p.rid)
            self._dispose()
            return True
        if p.deadline is not None and time.perf_counter() > p.deadline:
            waited_ms = (time.perf_counter() - p.submitted) * 1e3
            p.error = DeadlineExceeded(
                f"request deadline expired while queued "
                f"(waited {waited_ms:.0f} ms)",
                deadline_ms=(p.deadline - p.submitted) * 1e3,
            )
            self._m_deadline_shed.inc()
            if self._usage is not None:
                self._usage.record_deadline_shed(p.tenant)
            self._flight_rec(
                "drop", cause="deadline_shed", rows=p.rows,
                tenant=p.tenant, waited_ms=round(waited_ms, 3),
            )
            self._tracer.finish_request(p.rid)
            p.event.set()
            self._dispose()
            return True
        return False

    def _drain(self) -> List[_Pending]:
        while True:  # skip dead entries without starting a batch
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
            if not self._shed_dead(first):
                break
        batch = [first]
        rows = first.rows
        deadline = threading.Event()
        timer = threading.Timer(self.max_wait_s, deadline.set)
        timer.start()
        try:
            while rows < self.max_batch_size and not deadline.is_set():
                try:
                    nxt = self._queue.get(timeout=self.max_wait_s / 4)
                except queue.Empty:
                    continue
                if self._shed_dead(nxt):
                    continue
                if rows + nxt.rows > self.max_batch_size:
                    self._queue.put(nxt)  # over cap: leave for the next batch
                    break
                batch.append(nxt)
                rows += nxt.rows
        finally:
            timer.cancel()
        self._g_queue_depth.set(self._queue.qsize())
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._drain()
            # belt: a submit may time out between drain and dispatch
            still_live = [p for p in batch if not p.abandoned]
            for p in batch:
                if p.abandoned:
                    self._tracer.finish_request(p.rid)
            self._m_abandoned.inc(len(batch) - len(still_live))
            self._dispose(len(batch) - len(still_live))
            batch = still_live
            if not batch:
                continue
            try:
                if self._faults is not None:
                    # chaos point: a raise here surfaces to every waiter
                    # in the batch (the shared-device-call error path)
                    self._faults.fire("batcher.predict")
                t_start = time.perf_counter()
                for p in batch:
                    p.queue_wait_ms = (t_start - p.submitted) * 1e3
                rl = self.row_lists
                feats = _concat([p.features for p in batch], rl)
                total = sum(p.rows for p in batch)
                # a single request may exceed the largest bucket: chunk the
                # device calls so every call still hits a bucketed shape
                cap = self.buckets[-1]
                parts = []
                for start in range(0, total, cap):
                    stop = min(start + cap, total)
                    chunk = (
                        _slice_rows(feats, start, stop, rl) if total > cap else feats
                    )
                    padded = _pad_to(chunk, self._bucket(stop - start), rl)
                    with nan_scope():   # a NaN guard entered on any thread
                        out = self._predict_fn(padded)
                    if not rl and isinstance(out, list):
                        # array mode normalizes plain-list outputs (the
                        # list IS the batch axis) so chunk concat/slice
                        # keep batch semantics
                        out = np.asarray(out)
                    parts.append(_slice_rows(out, 0, stop - start, rl))
                result = _concat(parts, rl) if len(parts) > 1 else parts[0]
                t_end = time.perf_counter()
                device_ms = (t_end - t_start) * 1e3
                for p in batch:
                    # queue → predict, mirroring the engine's span
                    # vocabulary; the shared device call is one span
                    # per entry so each request's tree is self-complete
                    self._tracer.record_span(
                        p.rid, "queue", p.submitted, t_start
                    )
                    self._tracer.record_span(
                        p.rid, "predict", t_start, t_end, rows=p.rows,
                        batch_rows=total,
                    )
                offset = 0
                for p in batch:
                    p.result = _slice_rows(result, offset, offset + p.rows, rl)
                    p.device_ms = device_ms  # the shared batched call
                    offset += p.rows
                self._m_batches.inc()
                self._m_rows.inc(total)
                self._h_batch.observe(total)
                for p in batch:
                    self._h_queue.observe(p.queue_wait_ms)
                    self._h_device.observe(p.device_ms)
                self._m_requests.inc(len(batch))
                if self._usage is not None:
                    # the shared device call split by row share; FLOPs
                    # from the tracker's counted cost per chunked part
                    shares: dict = {}
                    for p in batch:
                        shares[p.tenant] = shares.get(p.tenant, 0) + p.rows
                    flops = 0.0
                    if self._programs is not None:
                        flops = self._programs.cost("batcher.predict")[0] * len(parts)
                    self._usage.attribute(shares, device_s=device_ms / 1e3, flops=flops)
                    for p in batch:
                        self._usage.finish_request(
                            p.tenant, queue_ms=p.queue_wait_ms,
                        )
                self._flight_rec(
                    "batch", rows=total, entries=len(batch),
                    device_ms=round(device_ms, 3),
                )
            except BaseException as exc:  # surface errors to every waiter
                logger.info(f"micro-batcher error: {exc!r}")
                self._m_errors.inc(len(batch))
                if self._usage is not None:
                    for p in batch:
                        self._usage.record_drop(p.tenant, "error")
                self._flight_rec(
                    "error", entries=len(batch), error=repr(exc)[:200]
                )
                for p in batch:
                    p.error = exc
            finally:
                for p in batch:
                    self._tracer.finish_request(p.rid)
                    p.event.set()
                self._dispose(len(batch))
