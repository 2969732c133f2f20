"""Push exporters: dependency-free OTLP/HTTP JSON for spans + metrics.

The PyTorch port of :mod:`unionml_tpu.exporters`: the same encodings byte
for byte; the resource reports torch's build and the card instead of the
JAX probe.

The telemetry layer (:mod:`unionml_tpu_torch.telemetry`) is pull-only: spans
sit in the recorder ring until someone exports them, metrics exist for
whoever scrapes ``GET /metrics``. In a fleet, that is not enough — the
collector is a remote service and the serving process must *push*.
This module is the push half, speaking the OTLP/HTTP **JSON** encoding
(`opentelemetry-proto` JSON mapping, ``/v1/traces`` and
``/v1/metrics``) with nothing beyond the stdlib:

- :class:`OtlpExporter` — subscribes to a
  :class:`~unionml_tpu_torch.telemetry.TraceRecorder` (every finished request
  is enqueued as a connected span tree: synthesized root span + child
  spans, W3C trace/span/parent ids intact) and periodically snapshots a
  :class:`~unionml_tpu_torch.telemetry.MetricsRegistry` into OTLP gauge /
  sum / histogram points. A **bounded** queue absorbs bursts (overflow
  increments ``unionml_otlp_spans_dropped_total`` — never blocks the
  serving path); a background thread batches, POSTs, and retries with
  exponential backoff + deterministic jitter; a batch that exhausts its
  retries is dropped and counted
  (``unionml_otlp_export_failures_total{signal}``) rather than wedging
  the queue. Resource attributes carry the host, backend, and build
  info so a collector can tell replicas apart.
- :class:`OtlpCollectorStub` — a stdlib-HTTP-server collector double
  for tests and benches: records every decoded payload, and can be
  armed to fail the next N posts so retry/drop behavior is testable
  without a network.

Configuration: ``ServingApp(otlp_endpoint="http://collector:4318")``
or ``UNIONML_TPU_OTLP_ENDPOINT`` (the standard OTLP/HTTP port; the
exporter appends ``/v1/traces`` / ``/v1/metrics``). Everything here is
stdlib-only and safe to import before torch. The instrumentation scope
stays ``unionml_tpu.telemetry``, the reference's, so one collector reads
both packages' payloads alike.
"""

from __future__ import annotations

import json
import random
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger

__all__ = [
    "OtlpCollectorStub",
    "OtlpExporter",
    "default_resource",
    "encode_metrics",
    "encode_spans",
]


def _attr_value(value: Any) -> Dict[str, Any]:
    """One OTLP AnyValue (the JSON mapping's tagged-union encoding)."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}  # int64 is a JSON string in OTLP
    if isinstance(value, float):
        return {"doubleValue": value}
    if isinstance(value, (list, tuple)):
        return {"arrayValue": {"values": [_attr_value(v) for v in value]}}
    return {"stringValue": str(value)}


def _attrs(mapping: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [
        {"key": str(k), "value": _attr_value(v)} for k, v in mapping.items()
    ]


def default_resource(service_name: str = "unionml-tpu") -> Dict[str, Any]:
    """The exporter's resource attributes: service/host identity plus
    the same build/runtime info ``unionml_tpu_build_info`` publishes:
    torch's version, the CUDA version it was built for and the name of
    CUDA device 0 (``cpu`` when torch sees none), and the reference's
    ``unionml_tpu.backend`` key (``cuda`` or ``cpu``). torch stays unimported
    — ``"unloaded"`` until something else loads it, exactly like
    :func:`telemetry.publish_process_metrics`."""
    try:
        from unionml_tpu_torch import __version__ as version
    except Exception:
        version = "unknown"
    torch_version, cuda_version, device = "unloaded", "unloaded", "unloaded"
    backend = "unloaded"
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        torch_version = str(getattr(torch_mod, "__version__", "unknown"))
        cuda_version = str(getattr(getattr(torch_mod, "version", None), "cuda", None))
        try:
            on_card = torch_mod.cuda.is_available()
            backend = "cuda" if on_card else "cpu"
            device = str(torch_mod.cuda.get_device_name(0)) if on_card else "cpu"
        except Exception:
            backend = device = "unknown"
    return {
        "service.name": service_name,
        "service.version": str(version),
        "host.name": socket.gethostname(),
        "telemetry.sdk.name": "unionml-tpu",
        "telemetry.sdk.language": "python",
        "unionml_tpu.torch_version": torch_version,
        "unionml_tpu.cuda_version": cuda_version,
        "unionml_tpu.device": device,
        # the reference's key, so a collector's filter on it matches
        "unionml_tpu.backend": backend,
    }


def _ns(perf_s: float, wall_offset_s: float) -> str:
    """perf_counter seconds → epoch nanoseconds (OTLP wants a uint64
    JSON string). ``wall_offset_s`` anchors the monotonic clock to the
    wall clock once, at exporter construction."""
    return str(max(0, int((perf_s + wall_offset_s) * 1e9)))


def encode_spans(
    requests: List[Tuple[str, dict, List[dict]]],
    resource: Dict[str, Any],
    wall_offset_s: float,
) -> dict:
    """Finished recorder requests → one OTLP/HTTP JSON
    ``ExportTraceServiceRequest``.

    Each request becomes a **connected tree**: a synthesized root span
    (named by the request kind, covering the request's start→finish,
    parented to the inbound context when one was propagated) plus one
    child span per recorded span. Ids are the recorder's real W3C ids,
    so a collector stitches this tree under the caller's."""
    otlp_spans: List[dict] = []
    for rid, meta, spans in requests:
        trace_id = meta.get("trace_id") or telemetry.new_trace_id()
        root_id = meta.get("span_id") or telemetry.new_span_id()
        start_s = meta.get("start_s")
        end_s = meta.get("end_s")
        if spans:
            start_s = min([s["start_s"] for s in spans] + (
                [start_s] if start_s is not None else []
            ))
            end_s = max([s["end_s"] for s in spans] + (
                [end_s] if end_s is not None else []
            ))
        if start_s is None or end_s is None:
            continue  # nothing measurable to ship
        root_attrs = {"unionml.request_id": rid}
        if meta.get("truncated"):
            root_attrs["unionml.truncated"] = True
        for key, value in meta.items():
            if key not in (
                "kind", "trace_id", "span_id", "parent_span_id",
                "sampled", "start_s", "end_s", "truncated", "events",
            ):
                root_attrs[f"unionml.{key}"] = value
        root: Dict[str, Any] = {
            "traceId": trace_id,
            "spanId": root_id,
            "name": str(meta.get("kind", "request")),
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": _ns(start_s, wall_offset_s),
            "endTimeUnixNano": _ns(end_s, wall_offset_s),
            "attributes": _attrs(root_attrs),
        }
        if meta.get("parent_span_id"):
            root["parentSpanId"] = meta["parent_span_id"]
        instants = meta.get("events")
        if instants:
            # recorder instants → OTLP span events on the root span
            # (the fleet timeline's eject/probe/rejoin/scale_* marks)
            root["events"] = [
                {
                    "timeUnixNano": _ns(ev["t_s"], wall_offset_s),
                    "name": str(ev["name"]),
                    **(
                        {"attributes": _attrs({
                            str(k): v for k, v in ev["args"].items()
                        })}
                        if ev.get("args") else {}
                    ),
                }
                for ev in instants
            ]
        otlp_spans.append(root)
        for span in spans:
            child: Dict[str, Any] = {
                "traceId": trace_id,
                "spanId": span.get("span_id") or telemetry.new_span_id(),
                # an explicit per-span parent (the router nests hedge
                # lanes / attempts this way) wins over the root default
                "parentSpanId": span.get("parent_span_id") or root_id,
                "name": str(span["name"]),
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": _ns(span["start_s"], wall_offset_s),
                "endTimeUnixNano": _ns(span["end_s"], wall_offset_s),
            }
            args = span.get("args")
            if args:
                child["attributes"] = _attrs({
                    str(k): v for k, v in args.items()
                })
            otlp_spans.append(child)
    return {
        "resourceSpans": [{
            "resource": {"attributes": _attrs(resource)},
            "scopeSpans": [{
                "scope": {"name": "unionml_tpu.telemetry"},
                "spans": otlp_spans,
            }],
        }]
    }


def encode_metrics(
    registry: "telemetry.MetricsRegistry",
    resource: Dict[str, Any],
    now_unix_ns: int,
) -> dict:
    """Registry snapshot → one OTLP/HTTP JSON
    ``ExportMetricsServiceRequest``: counters as cumulative monotonic
    sums, gauges as gauges, histograms as cumulative explicit-bounds
    histograms (the exact same numbers ``GET /metrics`` exposes)."""
    now = str(int(now_unix_ns))
    metrics: List[dict] = []
    for family in sorted(registry.collect(), key=lambda f: f.name):
        points: List[dict] = []
        if family.kind == "histogram":
            for values, child in sorted(family.children()):
                buckets = child.buckets()  # cumulative (bound, count)
                counts, prev = [], 0
                for _, cum in buckets:
                    counts.append(str(cum - prev))
                    prev = cum
                points.append({
                    "attributes": _attrs(
                        dict(zip(family.labelnames, values))
                    ),
                    "timeUnixNano": now,
                    "count": str(child.count),
                    "sum": child.sum,
                    "bucketCounts": counts,
                    "explicitBounds": [b for b, _ in buckets[:-1]],
                })
            metric = {
                "name": family.name,
                "description": family.help,
                "histogram": {
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "dataPoints": points,
                },
            }
        else:
            for values, child in sorted(family.children()):
                points.append({
                    "attributes": _attrs(
                        dict(zip(family.labelnames, values))
                    ),
                    "timeUnixNano": now,
                    "asDouble": float(child.value),
                })
            if family.kind == "counter":
                metric = {
                    "name": family.name,
                    "description": family.help,
                    "sum": {
                        "aggregationTemporality": 2,
                        "isMonotonic": True,
                        "dataPoints": points,
                    },
                }
            else:
                metric = {
                    "name": family.name,
                    "description": family.help,
                    "gauge": {"dataPoints": points},
                }
        metrics.append(metric)
    return {
        "resourceMetrics": [{
            "resource": {"attributes": _attrs(resource)},
            "scopeMetrics": [{
                "scope": {"name": "unionml_tpu.telemetry"},
                "metrics": metrics,
            }],
        }]
    }


class OtlpExporter:
    """Background OTLP/HTTP JSON exporter for spans and metric
    snapshots.

    Subscribes to ``tracer`` finished-request events into a bounded
    queue (``max_queue`` requests; overflow drops the OLDEST and
    counts ``unionml_otlp_spans_dropped_total`` — the serving path
    never blocks on export), and every ``interval_s`` the worker
    drains up to ``max_batch`` requests to ``<endpoint>/v1/traces``
    and ships one registry snapshot to ``<endpoint>/v1/metrics``.

    Each POST retries up to ``max_retries`` times on transport errors
    and 5xx/429, sleeping ``backoff_s * 2**attempt`` plus deterministic
    jitter (seeded PRNG — reproducible in tests, desynchronized across
    replicas via the host/pid-derived default seed), capped at
    ``backoff_cap_s``. A batch that exhausts retries is dropped and
    counted in ``unionml_otlp_export_failures_total{signal}`` —
    a dead collector costs bounded memory and zero request latency.

    Use :meth:`flush` in tests/benches for a synchronous drain;
    :meth:`close` unsubscribes, flushes once, and stops the worker.
    """

    def __init__(
        self,
        endpoint: str,
        *,
        registry: Optional["telemetry.MetricsRegistry"] = None,
        tracer: Optional["telemetry.TraceRecorder"] = None,
        service_name: str = "unionml-tpu",
        interval_s: float = 5.0,
        max_queue: int = 2048,
        max_batch: int = 256,
        timeout_s: float = 5.0,
        max_retries: int = 3,
        backoff_s: float = 0.25,
        backoff_cap_s: float = 5.0,
        headers: Optional[Dict[str, str]] = None,
        resource_attributes: Optional[Dict[str, Any]] = None,
        export_metrics: bool = True,
        seed: Optional[int] = None,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.interval_s = float(interval_s)
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.export_metrics = bool(export_metrics)
        self._headers = {"Content-Type": "application/json", **(headers or {})}
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self.resource = {
            **default_resource(service_name),
            **(resource_attributes or {}),
        }
        # monotonic→wall anchor for span timestamps (lint: wall clock is
        # fine here — this is an epoch timestamp, not a duration)
        self._wall_offset_s = time.time() - time.perf_counter()
        self._rng = random.Random(
            seed if seed is not None else hash((socket.gethostname(), id(self)))
        )
        self._lock = threading.Lock()
        self._queue: "deque[Tuple[str, dict, List[dict]]]" = deque()
        R = self._registry
        self._m_dropped = R.counter(
            "unionml_otlp_spans_dropped_total",
            "Finished requests dropped because the OTLP export queue "
            "was full.",
        )
        self._m_exported = R.counter(
            "unionml_otlp_exported_spans_total",
            "Spans successfully delivered to the OTLP endpoint.",
        )
        self._m_retries = R.counter(
            "unionml_otlp_export_retries_total",
            "OTLP POST attempts retried after a transport error or "
            "retryable status.",
        )
        failures = R.counter(
            "unionml_otlp_export_failures_total",
            "OTLP batches dropped after exhausting retries, by signal.",
            ("signal",),
        )
        self._m_failures = {
            signal: failures.labels(signal) for signal in ("traces", "metrics")
        }
        self._tracer.add_listener(self._on_finish)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="unionml-tpu-otlp-export"
        )
        self._worker.start()

    # -- ingestion (tracer listener: runs on the finishing thread) -------

    def _on_finish(self, rid: str, meta: dict, spans: List[dict]) -> None:
        dropped = 0
        with self._lock:
            self._queue.append((rid, meta, spans))
            while len(self._queue) > self.max_queue:
                self._queue.popleft()
                dropped += 1
        if dropped:
            self._m_dropped.inc(dropped)

    # -- transport --------------------------------------------------------

    def _post(self, path: str, payload: dict, signal: str) -> bool:
        body = json.dumps(payload).encode()
        for attempt in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(
                    f"{self.endpoint}{path}", data=body,
                    headers=self._headers, method="POST",
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    return True
            except urllib.error.HTTPError as exc:
                # 4xx (except 429) means the payload itself is refused:
                # retrying the same bytes cannot succeed
                retryable = exc.code == 429 or exc.code >= 500
                if not retryable:
                    logger.info(
                        f"otlp export refused ({signal}): HTTP {exc.code}"
                    )
                    break
            except (urllib.error.URLError, OSError, TimeoutError):
                pass  # transport error: retry
            if attempt >= self.max_retries:
                break
            self._m_retries.inc()
            delay = min(
                self.backoff_cap_s, self.backoff_s * (2.0 ** attempt)
            ) * (1.0 + 0.5 * self._rng.random())
            if self._stop.wait(delay):  # close() aborts the backoff
                break
        self._m_failures[signal].inc()
        return False

    # -- worker -----------------------------------------------------------

    def _flush_once(self) -> None:
        with self._lock:
            batch = [
                self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))
            ]
        if batch:
            payload = encode_spans(batch, self.resource, self._wall_offset_s)
            n_spans = len(payload["resourceSpans"][0]["scopeSpans"][0]["spans"])
            if self._post("/v1/traces", payload, "traces"):
                self._m_exported.inc(n_spans)
        if self.export_metrics:
            now_ns = int(time.time() * 1e9)
            self._post(
                "/v1/metrics",
                encode_metrics(self._registry, self.resource, now_ns),
                "metrics",
            )

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self._flush_once()
            except Exception as exc:  # the exporter must never crash
                logger.info(f"otlp export error: {exc!r}")

    def flush(self) -> None:
        """Synchronously export everything queued right now (tests and
        benches; production relies on the interval worker)."""
        self._flush_once()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self, flush: bool = True) -> None:
        """Unsubscribe from the tracer, stop the worker, and optionally
        attempt one final flush. ``_stop`` is set BEFORE the flush so
        its backoff sleeps short-circuit: shutdown against a dead
        collector costs at most one POST timeout per signal, not the
        full retry ladder — a rolling restart must not hang on its
        telemetry."""
        self._tracer.remove_listener(self._on_finish)
        self._stop.set()
        self._wake.set()
        self._worker.join(timeout=5.0)
        if flush:
            try:
                self._flush_once()
            except Exception as exc:
                logger.info(f"otlp final flush failed: {exc!r}")


class OtlpCollectorStub:
    """In-process OTLP/HTTP collector double (tests + benches).

    Accepts POSTs on any path, decodes the JSON body, and appends
    ``(path, payload)`` to :attr:`requests`. ``fail(n)`` arms the next
    ``n`` posts to answer ``status`` instead (retry/backoff tests);
    counts land in :attr:`failures_served`.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.requests: List[Tuple[str, dict]] = []
        self.failures_served = 0
        self._fail_next = 0
        self._fail_status = 503
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                with stub._lock:
                    if stub._fail_next > 0:
                        stub._fail_next -= 1
                        stub.failures_served += 1
                        status = stub._fail_status
                    else:
                        try:
                            stub.requests.append(
                                (self.path, json.loads(raw or b"{}"))
                            )
                            status = 200
                        except json.JSONDecodeError:
                            status = 400
                body = b"{}"
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="unionml-tpu-otlp-collector-stub",
        )
        self._thread.start()

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address
        return f"http://{host}:{port}"

    def fail(self, n: int, status: int = 503) -> None:
        """Answer ``status`` for the next ``n`` posts (then recover)."""
        with self._lock:
            self._fail_next = int(n)
            self._fail_status = int(status)

    def payloads(self, path: str) -> List[dict]:
        """Decoded payloads posted to ``path`` (e.g. ``/v1/traces``)."""
        with self._lock:
            return [p for seen_path, p in self.requests if seen_path == path]

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
