"""Dependency-free HTTP serving transport (stdlib only).

The PyTorch port of :mod:`unionml_tpu.serving.http`. The routes below
behave as in the reference (``remote=True`` loads the newest artifact
through :mod:`unionml_tpu_torch.remote`), except that ``/debug/profile``
captures a :mod:`torch.profiler` trace.

Same endpoint surface as the reference's FastAPI app
(reference: unionml/fastapi.py:15-70):

- ``GET /`` — HTML landing page,
- ``POST /predict`` — body ``{"inputs": {reader kwargs}}`` or
  ``{"features": ...}``; features flow through
  ``dataset.get_features`` then the (optionally micro-batched) predictor,
- ``POST /predict/stream`` — Server-Sent Events: one ``data:`` event per
  harvested token chunk (``{"tokens": [...]}``), terminated by
  ``{"done": true, "n_tokens": N}``. Requires a streaming predictor
  (``ServingApp(stream=...)`` — e.g. ``DecodeEngine.generate_stream``);
  concatenated chunks are identical to the ``/predict`` response. Time
  to first token ≈ queue + prefill, not the full generation — the
  latency win streaming exists for.
- ``GET /health`` — readiness:
  ``{"status": ok|degraded|draining, "model_loaded": bool,
  "queue_depth": int, "breaker_open": bool}`` sourced from the active
  engine/batcher (``health=`` hook); any status other than ``ok``
  answers **503** on both transports so load balancers stop routing
  here (docs/robustness.md),
- ``GET /stats`` — serving observability: per-request queue-wait /
  prefill / decode (or device) time splits — plus a ``ttft_ms``
  percentile from the engine, and a ``prefix_cache`` section
  (hit rate, prefill-tokens-saved, store bytes) when the engine runs
  an automatic prefix KV-cache — from the active batcher or decode
  engine (no reference counterpart — needed to attribute tail latency
  between transport queueing and device time),
- ``GET /metrics`` — Prometheus text exposition of the shared
  :mod:`unionml_tpu_torch.telemetry` registry (engine, batcher, prefix-cache,
  HTTP-layer, trainer, and per-program cost-analysis/MFU series in one
  scrape surface, plus the standard ``process_start_time_seconds`` /
  ``unionml_tpu_torch_build_info`` gauges),
- ``POST /debug/profile?seconds=N`` — a blocking on-demand
  :mod:`torch.profiler` capture (409 while another runs);
  ``GET /debug/memory`` — ``torch.cuda.memory_stats`` of every card plus
  a census of the live tensors,
- ``POST /debug/kv/export`` / ``/debug/kv/import`` — the cross-host KV
  handoff (``ServingApp(kv_export=engine.kv_export,
  kv_import=engine.kv_import)``), wire-encoded by
  :func:`~unionml_tpu_torch.serving.prefix_cache.encode_entries`; 422
  when unwired,
- ``GET /debug/flight?n=K&tenant=`` — the request flight recorder's
  newest events (admissions, decode chunks, sheds, recoveries) for
  after-the-fact explanation of a 429/504/recovery
  (docs/observability.md); events carry the submitting tenant, so an
  overload postmortem can filter to who was shed,
- ``GET /debug/usage`` — per-tenant resource vectors from the usage
  ledger (``ServingApp(usage=...)``): queue/prefill/decode splits,
  attributed device-seconds and FLOPs, prefix-cache savings, and the
  decode capacity-headroom estimate (docs/observability.md "Usage
  metering & cost attribution"),
- ``GET /debug/cache/peek?prompt=1,2,3`` — the prefix cache's
  read-only peek over HTTP (``ServingApp(cache_peek=...)``): how many
  leading tokens of the comma-separated prompt this process holds
  cached KV for. The fleet router's ``HttpReplica`` probes it
  (TTL-cached) for cache-affinity routing ACROSS hosts — the remote
  twin of the in-process ``RadixPrefixCache.peek``, and like it the
  probe takes no lease, bumps no LRU, and moves no hit/miss counters,
- ``GET /debug/trace?format=chrome|jsonl`` — the trace recorder's
  Chrome-trace / JSON-lines export over HTTP (no shelling into the
  process to pull a trace),
- ``GET /debug/slo`` — the SLO watchdog's burn-rate report when the
  app was built with one (``ServingApp(slo=...)``).

Every response carries an ``X-Request-ID`` header (a generated
telemetry request id) and lands in the per-endpoint
``unionml_http_requests_total`` / ``unionml_http_request_ms`` series.

Tenant identity (docs/observability.md "Usage metering & cost
attribution"): every request may carry an ``X-Tenant-ID`` header
(default ``anonymous``; values over 64 chars or with non-printable
characters answer **422** — a hostile header must never mint a label
value). The validated tenant is echoed on every response alongside
``X-Request-ID``, and predict routes open a
:func:`~unionml_tpu_torch.serving.usage.tenant_scope` so engine/batcher
submissions bill their resource vectors to it.

Scheduling priority (docs/robustness.md "Preemption & fairness"):
every request may carry an ``X-Priority`` header (``high`` /
``normal`` / ``low``, default ``normal``; anything else answers
**422** — the value set is closed). The validated class is echoed on
every response and predict routes open a
:func:`~unionml_tpu_torch.serving.scheduler.priority_scope`, so engine
submissions enter the preemptive scheduler's waiting room under the
caller's class.

Model-version pinning (docs/robustness.md "Rollouts & rollback"):
every request may carry an ``X-Model-Version`` header (a registry
version slug, default ``auto`` = route wherever the rollout split
says; malformed slugs answer **422** — the grammar is closed). The
validated value is echoed on every response and predict routes open a
:func:`~unionml_tpu_torch.serving.scheduler.model_version_scope`, so a
version-aware router pins the request to replicas serving exactly
those weights.

Distributed tracing (docs/observability.md): every request parses an
inbound W3C ``traceparent`` header (a fresh root is minted when absent
or malformed — tracing metadata can never 5xx a request) and the
response echoes a ``traceparent`` carrying the same trace id, so
callers can stitch the full request tree. ``POST /predict`` and
``/predict/stream`` additionally open a recorded server timeline and a
:func:`~unionml_tpu_torch.telemetry.trace_scope` around the predictor call,
so engine/batcher spans join the caller's trace with connected parent
links. ``ServingApp(otlp_endpoint=...)`` (or
``UNIONML_TPU_OTLP_ENDPOINT``) starts a background
:class:`~unionml_tpu_torch.exporters.OtlpExporter` pushing spans and metric
snapshots to an OTLP/HTTP collector.

Fault tolerance at the transport boundary (docs/robustness.md): an
``X-Deadline-Ms`` request header opens a :func:`~unionml_tpu_torch.serving
.faults.deadline_scope` around the predictor call, so engine/batcher
submissions shed the request once the budget expires; typed serving
errors map to statuses — :class:`~unionml_tpu_torch.serving.faults
.Overloaded` → **429** with ``Retry-After``,
:class:`~unionml_tpu_torch.serving.faults.EngineUnavailable` (breaker open /
draining) → **503** with ``Retry-After``, :class:`~unionml_tpu_torch.serving
.faults.DeadlineExceeded` → **504**. ``ServingApp.drain()`` stops
admissions app-wide and flips ``/health`` to ``draining``/503.

Startup model loading mirrors fastapi.py:22-34: ``UNIONML_MODEL_PATH``
env first, then the remote registry when ``remote=True``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    deadline_scope,
    http_fault_response,
    parse_deadline_header,
)
from unionml_tpu_torch.serving.scheduler import (
    DEFAULT_MODEL_VERSION,
    DEFAULT_PRIORITY,
    model_version_scope,
    priority_scope,
    token_cap_scope,
    validate_model_version,
    validate_priority,
    validate_token_cap,
)
from unionml_tpu_torch.serving.usage import (
    DEFAULT_TENANT,
    tenant_scope,
    validate_tenant,
)

# bound HTTP label cardinality: unknown paths share one series instead
# of letting a scanner mint a metric per probed URL
KNOWN_ROUTES = (
    "/", "/predict", "/predict/stream", "/health", "/stats", "/metrics",
    "/debug/profile", "/debug/memory", "/debug/flight", "/debug/trace",
    "/debug/slo", "/debug/usage", "/debug/cache/peek", "/debug/fleet",
    "/debug/rollout", "/debug/kv/export", "/debug/kv/import",
    "/debug/goodput", "/debug/tail",
)

# the routes that open a RECORDED trace timeline (a server span the
# engine/batcher spans parent to); every other route still parses and
# echoes traceparent, but health probes and scrapes must not churn the
# trace ring or the OTLP export queue
TRACED_ROUTES = ("/predict", "/predict/stream")

LANDING_HTML = """<html><head><title>unionml-tpu</title></head>
<body><h1>unionml-tpu serving: {name}</h1>
<p>POST /predict with {{"inputs": ...}} or {{"features": ...}}</p>
<p>GET /health</p></body></html>"""


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, (bool, int, float, str, type(None))):
        return obj
    if hasattr(obj, "detach"):  # a tensor, on the card too
        return obj.detach().cpu().tolist()
    if hasattr(obj, "tolist"):  # numpy arrays and scalars
        return np.asarray(obj).tolist()
    if hasattr(obj, "to_dict"):  # DataFrame
        return obj.to_dict(orient="records")
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    try:
        return np.asarray(obj).tolist()
    except Exception:
        return str(obj)


class ServingApp:
    """Holds the model + batcher; dispatches routes for any transport."""

    def __init__(
        self,
        model,
        *,
        remote: bool = False,
        app_version: Optional[str] = None,
        model_version: str = "latest",
        batch: bool = False,
        model_path_env: str = "UNIONML_MODEL_PATH",
        warmup: Optional[Any] = None,
        stats: Optional[Any] = None,
        stream: Optional[Any] = None,
        extra_stats: Optional[dict] = None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        health: Optional[Any] = None,
        drain: Optional[Any] = None,
        flight: Optional[telemetry.FlightRecorder] = None,
        tracer: Optional[telemetry.TraceRecorder] = None,
        otlp_endpoint: Optional[str] = None,
        slo: Optional[Any] = None,
        usage: Optional[Any] = None,
        cache_peek: Optional[Any] = None,
        kv_export: Optional[Any] = None,
        kv_import: Optional[Any] = None,
        goodput: Optional[Any] = None,
        **batcher_kwargs,
    ):
        """``warmup``: optional callable invoked with the loaded model
        object after ``setup_model`` — pre-compile every serving
        executable there (e.g. ``make_lm_predictor``'s ``.warmup``), or
        the first live request per shape stalls behind a multi-second
        XLA compile.

        ``stats``: optional zero-arg callable whose dict is served at
        ``GET /stats`` (e.g. ``DecodeEngine.stats`` when the predictor
        wraps a continuous-batching engine); defaults to the
        micro-batcher's stats when ``batch=True``.

        ``stream``: optional ``(model_object, features) -> iterator of
        token chunks`` enabling ``POST /predict/stream`` (SSE). Wrap
        ``DecodeEngine.generate_stream`` — the batcher path computes all
        tokens in one device call, so it has nothing incremental to
        stream.

        ``extra_stats``: optional static dict merged into every
        ``GET /stats`` response (deployment metadata — e.g. the
        serving-mode auto-selection decision from
        :func:`unionml_tpu_torch.serving.auto.choose_serving_mode`).

        ``registry``: explicit :class:`~unionml_tpu_torch.telemetry
        .MetricsRegistry` served at ``GET /metrics``; defaults to the
        process-global registry, so an engine or trainer built anywhere
        in the process shows up in this app's scrape.

        ``health``: optional zero-arg callable returning the readiness
        dict merged into ``GET /health`` (``DecodeEngine.health`` when
        the predictor wraps an engine); defaults to the micro-batcher's
        when ``batch=True``. A non-``ok`` status answers 503.

        ``drain``: optional callable (accepting one optional timeout
        argument) invoked by :meth:`drain` — wire
        ``DecodeEngine.drain`` so the app-level drain also finishes the
        engine's in-flight streams; defaults to the micro-batcher's.

        ``flight``: explicit :class:`~unionml_tpu_torch.telemetry
        .FlightRecorder` served at ``GET /debug/flight``; defaults to
        the process-global recorder, where engines and batchers record
        by default — so the postmortem surface covers them without
        extra wiring.

        ``tracer``: explicit :class:`~unionml_tpu_torch.telemetry
        .TraceRecorder` for the transport's server spans and
        ``GET /debug/trace``; defaults to the process-global recorder
        (where engines record), so the exported trace holds the
        transport AND engine spans of each request in one tree.

        ``otlp_endpoint``: an OTLP/HTTP collector base URL (e.g.
        ``http://collector:4318``) — when set (or via the
        ``UNIONML_TPU_OTLP_ENDPOINT`` env var), the app runs a
        background :class:`~unionml_tpu_torch.exporters.OtlpExporter`
        pushing finished request spans and periodic metric snapshots;
        :meth:`shutdown` closes it.

        ``slo``: a :class:`~unionml_tpu_torch.slo.SloWatchdog` — evaluated on
        every ``GET /health`` (the probe cadence is the sampling
        cadence) and served at ``GET /debug/slo``; a breached
        objective flips health to ``degraded`` → 503, so load
        balancers react to objective burn, not just crash loops.

        ``usage``: a :class:`~unionml_tpu_torch.serving.usage.UsageLedger` —
        the SAME ledger the engine/batcher records into (e.g.
        ``engine.usage``) — served at ``GET /debug/usage``: per-tenant
        resource vectors, cache savings, and the capacity-headroom
        estimate (docs/observability.md "Usage metering & cost
        attribution").

        ``cache_peek``: a ``(prompt token ids) -> int`` read-only
        probe — wire the engine's ``prefix_cache.peek`` (or a
        router's fleet-wide ``cached_prefix_len``) — served at
        ``GET /debug/cache/peek?prompt=...`` so the fleet router's
        :class:`~unionml_tpu_torch.serving.router.HttpReplica` can make
        cache-affinity routing decisions across hosts.

        ``kv_export`` / ``kv_import``: the cross-host KV handoff hooks —
        wire ``engine.kv_export`` and ``engine.kv_import``. ``POST
        /debug/kv/export`` serves the cached block entries covering a
        prompt, wire-encoded; ``POST /debug/kv/import`` attaches them to
        this process's host block store. Unwired, both answer 422.

        ``goodput``: a zero-arg callable returning the serving goodput
        plane's report — wire ``engine.goodput_report`` — served at
        ``GET /debug/goodput``: batch-occupancy classification
        (full-batch / padded-slot / prefill-mix / idle device passes),
        goodput + occupancy + KV-pressure ratios, achieved tokens/s
        tied to the introspection MFU gauges, and the perf-regression
        watchdog advisory (docs/observability.md "Serving goodput &
        tail attribution"). Answers 422 when unwired."""
        self.model = model
        self.remote = remote
        self.app_version = app_version
        self.model_version = model_version
        self.model_path_env = model_path_env
        self.batch = batch
        self.warmup = warmup
        self._stats_fn = stats
        self._stream_fn = stream
        self._health_fn = health
        self._drain_fn = drain
        self._draining = False
        self._extra_stats = dict(extra_stats or {})
        self._batcher = None
        self._batcher_kwargs = batcher_kwargs
        self._server: Optional[ThreadingHTTPServer] = None
        self.registry = registry if registry is not None else telemetry.get_registry()
        self._flight = (
            flight if flight is not None else telemetry.get_flight_recorder()
        )
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self._slo = slo
        self._usage = usage
        self._cache_peek = cache_peek
        self._kv_export = kv_export
        self._kv_import = kv_import
        self._goodput = goodput
        self._otlp = None
        endpoint = otlp_endpoint or os.getenv("UNIONML_TPU_OTLP_ENDPOINT")
        if endpoint:
            from unionml_tpu_torch.exporters import OtlpExporter

            self._otlp = OtlpExporter(
                endpoint, registry=self.registry, tracer=self._tracer
            )
        self._m_http_requests = self.registry.counter(
            "unionml_http_requests_total",
            "HTTP requests served, by transport/path/status.",
            ("transport", "path", "status"),
        )
        self._m_http_errors = self.registry.counter(
            "unionml_http_errors_total",
            "HTTP responses with status >= 400, by transport/path.",
            ("transport", "path"),
        )
        self._h_http_ms = self.registry.histogram(
            "unionml_http_request_ms",
            "Request wall time at the transport boundary.",
            ("transport", "path"),
        )

    # -- lifecycle --------------------------------------------------------

    def setup_model(self):
        """Load the artifact (reference: fastapi.py:22-34)."""
        model_path = os.getenv(self.model_path_env)
        if model_path is not None and model_path != "":
            self.model.load(model_path)
        elif self.remote:
            from unionml_tpu_torch.remote import load_latest_artifact

            load_latest_artifact(
                self.model, app_version=self.app_version, model_version=self.model_version
            )
        if self.model.artifact is None:
            raise RuntimeError(
                f"Model artifact unavailable: set {self.model_path_env} or serve "
                "with remote=True against a deployed app."
            )
        if self.batch:
            from unionml_tpu_torch.serving.batcher import MicroBatcher

            predictor = self.model._predictor
            model_object = self.model.artifact.model_object
            self._batcher = MicroBatcher(
                lambda feats: predictor(model_object, feats),
                # the app's scrape, /debug/flight, /debug/trace, and
                # /debug/usage must cover its own batcher even when the
                # app was built with isolated sinks — `usage` in
                # particular has no other route into an app-built
                # batcher (ServingApp(usage=) consumes the kwarg name)
                **{
                    "registry": self.registry,
                    "flight": self._flight,
                    "tracer": self._tracer,
                    "usage": self._usage,
                    **self._batcher_kwargs,
                },
            )
        if self.warmup is not None:
            n = self.warmup(self.model.artifact.model_object)
            logger.info(f"serving warmup done ({n if n is not None else '?'} executables)")

    # -- route handlers ---------------------------------------------------

    def root(self) -> str:
        return LANDING_HTML.format(name=self.model.name)

    def health(self) -> dict:
        """Readiness: ``status`` is ``ok`` / ``degraded`` (engine
        circuit breaker open) / ``draining``, plus the queue depth and
        breaker state from the active engine/batcher. Transports answer
        503 for any non-``ok`` status (see :meth:`health_status`)."""
        out = {
            "status": "ok",
            "model_loaded": self.model.artifact is not None,
            "queue_depth": 0,
            "breaker_open": False,
        }
        src = self._health_fn
        if src is None and self._batcher is not None:
            src = self._batcher.health
        if src is not None:
            out.update(src())
        if self._slo is not None:
            # the watchdog samples on the health-probe cadence; a
            # breached objective degrades an otherwise-ok replica so
            # the balancer reacts to objective burn, not just crashes
            breached = self._slo.evaluate().get("breached", [])
            out["slo_breached"] = breached
            if breached and out["status"] == "ok":
                out["status"] = "degraded"
        if self._draining:
            # app-level drain overrides the component view: this
            # process is going away even if the engine itself is idle
            out["status"] = "draining"
        return out

    def health_status(self, health: dict) -> int:
        """HTTP status for a :meth:`health` body: 503 whenever the app
        is not ready to take traffic (degraded/draining), so load
        balancers and k8s readiness probes stop routing here."""
        return 200 if health.get("status") == "ok" else 503

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting (predict/stream answer 503,
        ``/health`` flips to ``draining``) and delegate to the wired
        component drain (``drain=`` hook, or the micro-batcher's) so
        in-flight requests and streams finish. Returns True when fully
        drained. The HTTP server keeps answering health/metrics —
        shutdown is still :meth:`shutdown`."""
        self._draining = True
        fn = self._drain_fn
        if fn is None and self._batcher is not None:
            fn = self._batcher.drain
        if fn is None:
            return True
        return bool(fn(timeout))

    def resume(self) -> None:
        """Reopen admissions after :meth:`drain` (the component's own
        ``resume`` must be called separately if it was drained)."""
        self._draining = False

    def stats(self) -> dict:
        if self._stats_fn is not None:
            base = dict(self._stats_fn())
        elif self._batcher is not None:
            base = self._batcher.stats()
        else:
            base = {"engine": "direct"}  # per-request predictors: no queue
        return {**base, **self._extra_stats} if self._extra_stats else base

    def reset_stats(self) -> None:
        """Zero the batcher's observability window (no-op for direct or
        custom-stats serving — reset the custom source directly)."""
        if self._batcher is not None:
            self._batcher.reset_stats()

    def metrics_text(self) -> str:
        """The ``GET /metrics`` body: Prometheus text exposition of the
        app's registry (shared by both transports so they cannot drift).
        Serve with ``telemetry.EXPOSITION_CONTENT_TYPE``."""
        # refresh the standard process gauges (process_start_time_
        # seconds, unionml_tpu_build_info) so every scraped registry —
        # isolated ones included — carries them
        telemetry.publish_process_metrics(self.registry)
        return self.registry.exposition()

    # -- debug/introspection surface (shared by both transports) ----------

    def debug_profile(self, seconds: float = 2.0) -> dict:
        """``POST /debug/profile?seconds=N``: capture an on-demand
        :mod:`torch.profiler` trace and return its artifact directory.
        Raises :class:`~unionml_tpu_torch.introspection.ProfileInProgress`
        (→ 409) while a capture runs, ``ValueError`` (→ 422) for a
        non-positive duration."""
        from unionml_tpu_torch.introspection import capture_profile

        return capture_profile(seconds)

    def debug_memory(self) -> dict:
        """``GET /debug/memory``: every card's ``torch.cuda.memory_stats``
        plus a census of the live tensors (count and bytes by dtype, top
        shapes)."""
        from unionml_tpu_torch.introspection import device_memory_breakdown

        return device_memory_breakdown()

    def debug_flight(
        self, n: Optional[int] = None, kind: Optional[str] = None,
        rid: Optional[str] = None, tenant: Optional[str] = None,
        phase: Optional[str] = None,
    ) -> dict:
        """``GET /debug/flight?n=K``: the newest ``K`` request
        lifecycle events from the flight recorder (all retained when
        unset), optionally filtered by event kind / request id /
        tenant tag (``?tenant=`` names who was shed in an overload
        postmortem) / serving-phase tag (``?phase=prefill`` isolates
        one pool of a disaggregated fleet — handoff events carry both
        legs' phases and match either). ``wall_offset_ms`` is the
        value to ADD to each event's monotonic ``t_ms`` for epoch
        milliseconds — the fleet router's flight merge rebases
        per-host rings with it, since raw monotonic readings are
        incomparable across machines."""
        return {
            **self._flight.stats(),
            "wall_offset_ms": round(telemetry.wall_clock_offset_ms(), 3),
            "events": self._flight.dump(
                n=n, kind=kind, rid=rid, tenant=tenant, phase=phase,
            ),
        }

    def debug_usage(self) -> dict:
        """``GET /debug/usage``: the usage ledger's per-tenant resource
        vectors, attribution-identity totals, cache savings, and
        capacity-headroom estimate. Raises ``ValueError`` (→ 422) when
        the app has no ledger."""
        if self._usage is None:
            raise ValueError(
                "no usage ledger on this app — construct "
                "ServingApp(usage=engine.usage) with a metering engine"
            )
        return self._usage.report()

    def debug_cache_peek(self, prompt: Any) -> dict:
        """``GET /debug/cache/peek?prompt=1,2,3``: how many leading
        tokens of ``prompt`` (comma-separated ids, or a list) this
        process holds cached KV for — the remote half of cache-affinity
        routing. Raises ``ValueError`` (→ 422) when the app has no
        peek source or the prompt doesn't parse."""
        if self._cache_peek is None:
            raise ValueError(
                "no cache peek on this app — construct "
                "ServingApp(cache_peek=engine.prefix_cache.peek) with a "
                "prefix-cached engine"
            )
        if isinstance(prompt, str):
            parts = [p for p in prompt.split(",") if p.strip() != ""]
            if not parts:
                raise ValueError(
                    "prompt must be non-empty comma-separated token ids"
                )
            tokens = [int(p) for p in parts]
        else:
            tokens = [int(t) for t in prompt]
            if not tokens:
                raise ValueError("prompt must be non-empty")
        return {"cached_prefix_len": int(self._cache_peek(tokens))}

    def debug_kv_export(self, prompt: Any) -> dict:
        """``POST /debug/kv/export`` (body ``{"prompt": [...]}``): the
        cached KV block entries covering ``prompt``, wire-encoded — the
        donor half of the cross-host handoff. Raises ``ValueError`` (→
        422) when the app has no export source or the prompt doesn't
        parse."""
        from unionml_tpu_torch.serving.prefix_cache import encode_entries

        if self._kv_export is None:
            raise ValueError(
                "no KV export on this app — construct "
                "ServingApp(kv_export=engine.kv_export) with a prefix-cached engine"
            )
        tokens = [int(t) for t in prompt]
        if not tokens:
            raise ValueError("prompt must be non-empty token ids")
        entries = self._kv_export(tokens)
        return {"entries": encode_entries(entries), "blocks": len(entries)}

    def debug_kv_import(self, entries: Any) -> dict:
        """``POST /debug/kv/import`` (body ``{"entries": [...]}``): attach
        wire-encoded donor entries to this process's host block store.
        Raises ``ValueError`` (→ 422) when the app has no import sink or
        the body is malformed."""
        from unionml_tpu_torch.serving.prefix_cache import decode_entries

        if self._kv_import is None:
            raise ValueError(
                "no KV import on this app — construct "
                "ServingApp(kv_import=engine.kv_import) with a prefix-cached engine"
            )
        if not isinstance(entries, (list, tuple)):
            raise ValueError("'entries' must be a list of KV entries")
        return {"attached": int(self._kv_import(decode_entries(entries)))}

    def debug_trace(
        self,
        format: str = "chrome",
        rid: Optional[str] = None,
        trace: Optional[str] = None,
    ):
        """``GET /debug/trace?format=chrome|jsonl`` — the trace
        recorder's retained requests — OR, with ``?rid=`` /
        ``?trace=``, ONE stitched end-to-end timeline:
        ``(body, content_type)``.

        - ``format=chrome`` (default) is the Perfetto-loadable
          trace-event JSON; ``jsonl`` one span per line for log
          shippers. Raises ``ValueError`` (→ 422) for any other
          format.
        - ``rid=<X-Request-ID>`` resolves the id a client holds into
          its trace and answers the stitched timeline document
          (:func:`~unionml_tpu_torch.telemetry.stitched_trace`): every
          retained local timeline of that trace — transport server
          span, engine/batcher spans, and on a router app the routing
          spans plus fetched replica spans — as one span list with
          connected W3C parent links. Unknown rids raise
          ``ValueError`` (→ 422).
        - ``trace=<trace-id>`` stitches directly by trace id and
          answers an EMPTY document when this process holds nothing
          for it (a fleet peer probing every replica must get a
          degrading answer, not an error).
        """
        if rid is not None or trace is not None:
            trace_id = trace
            if trace_id is None:
                trace_id = self._tracer.find_trace_id(rid)
                if trace_id is None:
                    raise ValueError(
                        f"unknown request id {rid!r} (not in the trace "
                        "recorder's retained window)"
                    )
            doc = telemetry.stitched_trace(
                trace_id, self._tracer.requests_for_trace(trace_id),
            )
            return doc, "application/json"
        if format == "chrome":
            return self._tracer.export_chrome(), "application/json"
        if format == "jsonl":
            return self._tracer.export_jsonl(), "application/x-ndjson"
        raise ValueError(
            f"unknown trace format {format!r} (use chrome or jsonl)"
        )

    def debug_fleet(self) -> dict:
        """``GET /debug/fleet``: the fleet operator dashboard — only a
        router app (:func:`~unionml_tpu_torch.serving.router
        .make_router_app`) has a fleet to report. Raises ``ValueError``
        (→ 422) here."""
        raise ValueError(
            "no fleet on this app — serve a FleetRouter via "
            "make_router_app for the fleet dashboard"
        )

    def debug_rollout(self) -> dict:
        """``GET /debug/rollout``: the rollout operator dashboard —
        only a router app whose :class:`~unionml_tpu_torch.serving.rollout
        .RolloutController` is attached has one to report. Raises
        ``ValueError`` (→ 422) here."""
        raise ValueError(
            "no rollout controller on this app — serve a FleetRouter "
            "via make_router_app and attach a RolloutController"
        )

    def debug_slo(self) -> dict:
        """``GET /debug/slo``: a fresh SLO watchdog evaluation (burn
        rates per objective and window, breach flags), plus a
        ``serving`` block of TTFT/ITL percentile rows and per-engine
        goodput ratios read from the serving perf plane's histograms —
        the rows an ITL- or goodput-targeted ``SloObjective`` (and the
        per-pool autoscalers) key on. Raises ``ValueError`` (→ 422)
        when the app has no watchdog."""
        if self._slo is None:
            raise ValueError(
                "no SLO watchdog on this app — construct "
                "ServingApp(slo=SloWatchdog([...]))"
            )
        report = self._slo.evaluate()
        serving = self._serving_percentiles()
        if serving:
            report["serving"] = serving
        return report

    def _serving_percentiles(self) -> dict:
        """TTFT/ITL percentile rows (exact, over each histogram's
        retained sample window, merged across label children) and the
        per-engine goodput ratio gauges — ``{}`` when no serving perf
        plane has recorded into this app's registry."""
        out: dict = {}
        for family in self.registry.collect():
            if family.name in ("unionml_engine_ttft_ms",
                               "unionml_engine_itl_ms"):
                samples: list = []
                for _values, child in family.children():
                    samples.extend(child.samples())
                if samples:
                    key = ("ttft_ms" if family.name.endswith("ttft_ms")
                           else "itl_ms")
                    out[key] = telemetry.percentile_summary(samples)
            elif family.name == "unionml_serving_goodput_ratio":
                ratios = {
                    values[0]: round(child.value, 6)
                    for values, child in family.children()
                }
                if ratios:
                    out["goodput_ratio"] = ratios
        return out

    def debug_goodput(self) -> dict:
        """``GET /debug/goodput``: the serving goodput plane's report —
        dispatcher-pass classification (full-batch / padded-slot /
        prefill-mix / idle), goodput + occupancy + KV-pressure ratios,
        achieved tokens/s alongside the introspection layer's MFU
        figures, and the perf-regression watchdog advisory. Raises
        ``ValueError`` (→ 422) when the app has no goodput source (or
        the engine's plane is off)."""
        if self._goodput is None:
            raise ValueError(
                "no goodput source on this app — construct "
                "ServingApp(goodput=engine.goodput_report) with a "
                "perf-enabled engine"
            )
        return self._goodput()

    def debug_tail(self, metric: str = "", n: Optional[int] = None) -> dict:
        """``GET /debug/tail?metric=&n=``: the ``n`` slowest recent
        requests by exemplar value of one histogram (default
        ``unionml_engine_decode_ms``), each with its per-phase latency
        split (queue / admission / prefill / decode / ITL, from the
        flight recorder's ``finish`` event) and a ``trace`` link whose
        rid resolves in ``GET /debug/trace?rid=`` — histogram bucket →
        stitched timeline in one hop. Raises ``ValueError`` (→ 422)
        for an unknown or non-histogram metric."""
        name = metric or "unionml_engine_decode_ms"
        family = next(
            (f for f in self.registry.collect() if f.name == name), None
        )
        if family is None:
            raise ValueError(
                f"unknown metric {name!r} (nothing by that name in "
                "this app's registry)"
            )
        if family.kind != "histogram":
            raise ValueError(
                f"metric {name!r} is a {family.kind} — tail exemplars "
                "exist only on histograms"
            )
        k = 5 if n is None else max(1, min(64, int(n)))
        rows = []
        for values, child in family.children():
            labels = dict(zip(family.labelnames, values))
            for value, rid in child.exemplars(k):
                rows.append({
                    "rid": rid,
                    "value_ms": round(value, 3),
                    "labels": labels,
                })
        rows.sort(key=lambda r: r["value_ms"], reverse=True)
        rows = rows[:k]
        segment_keys = (
            "queue_ms", "admission_ms", "prefill_ms", "decode_ms",
            "ttft_ms", "itl_mean_ms", "itl_tokens", "tokens",
        )
        for row in rows:
            events = self._flight.dump(rid=row["rid"], kind="finish")
            if events:
                ev = events[-1]
                row["segments"] = {
                    key: ev[key] for key in segment_keys if key in ev
                }
            row["trace"] = f"/debug/trace?rid={row['rid']}"
        return {"metric": name, "n": k, "requests": rows}

    def open_traced_request(
        self, path: str, raw_traceparent: Optional[str],
        rid: Optional[str] = None,
    ):
        """``(ctx, finish)`` — the non-context-manager seam for
        transports whose response outlives the handler frame (the
        FastAPI streaming route hands its body to the event loop):
        opens the recorded server timeline parented to the inbound
        ``traceparent`` and returns its context plus an idempotent
        ``finish()`` that records the server span and closes the
        timeline — callable exactly-once-effective from any thread.
        Prefer :meth:`traced_request` where the handler frame spans
        the response. ``rid`` keys the timeline under the transport's
        ``X-Request-ID`` so ``/debug/trace?rid=`` resolves the id the
        client actually received."""
        inbound = telemetry.parse_traceparent(raw_traceparent)
        rid = self._tracer.new_request(
            "http", trace_ctx=inbound, rid=rid, path=path,
        )
        ctx = self._tracer.trace_context(rid)
        t0 = time.perf_counter()
        finished = threading.Event()

        def finish() -> None:
            if finished.is_set():
                return
            finished.set()
            # the server span makes the transport visible in the
            # chrome/jsonl exports (which emit recorded spans only; the
            # OTLP export additionally synthesizes the timeline root)
            self._tracer.record_span(
                rid, f"http {path}", t0, time.perf_counter()
            )
            self._tracer.finish_request(rid)

        return ctx, finish

    @contextmanager
    def traced_request(
        self, path: str, raw_traceparent: Optional[str],
        rid: Optional[str] = None,
    ) -> Iterator[telemetry.TraceContext]:
        """One traced transport request (shared by all three
        transports so the propagation contract cannot drift): opens a
        recorded server timeline parented to the inbound
        ``traceparent`` (minting a root when absent/malformed — never
        an error), exposes its context to engine/batcher submissions
        on this thread via :func:`~unionml_tpu_torch.telemetry.trace_scope`,
        and yields the context whose
        :func:`~unionml_tpu_torch.telemetry.format_traceparent` the response
        must echo."""
        ctx, finish = self.open_traced_request(path, raw_traceparent, rid)
        try:
            with telemetry.trace_scope(ctx):
                yield ctx
        finally:
            finish()

    def observe_request(
        self, transport: str, path: str, status: int, duration_ms: float
    ) -> None:
        """Record one transport-boundary request in the shared registry
        (both transports call this so the series are comparable)."""
        route = path if path in KNOWN_ROUTES else "<other>"
        self._m_http_requests.labels(transport, route, str(status)).inc()
        if status >= 400:
            self._m_http_errors.labels(transport, route).inc()
        self._h_http_ms.labels(transport, route).observe(duration_ms)

    def predict(self, payload: dict) -> Any:
        if self._draining:
            raise EngineUnavailable(
                "serving app is draining and not accepting requests",
                reason="draining", retry_after_s=1.0,
            )
        if self.model.artifact is None:
            self.setup_model()
        inputs = payload.get("inputs")
        features = payload.get("features")
        if (inputs is None) == (features is None):
            raise ValueError("provide exactly one of 'inputs' or 'features'")
        # the payload-contract per-request token cap: validated here
        # (422 on garbage) and opened as an ambient scope around the
        # dispatch, so an engine-backed predictor honors it without a
        # kwarg threading through every wrapper — and the cap survives
        # the router hop, which two-leg disaggregated dispatch needs
        # for token parity. Non-engine predictors ignore it.
        cap = validate_token_cap(payload.get("max_new_tokens"))
        if cap is not None and self._batcher is not None:
            # the micro-batcher dispatches full batches on its own
            # flush thread — a per-request cap cannot bind there, and
            # silently decoding to the default would break exactly the
            # cross-hop token parity the payload field exists for:
            # refuse loudly (→ 422) instead
            raise ValueError(
                "max_new_tokens is not supported on a batched "
                "(MicroBatcher) app — the batcher computes full "
                "batches in one device call; serve the engine "
                "directly for per-request caps"
            )
        with token_cap_scope(cap):
            if inputs is not None:
                return _to_jsonable(self.model.predict(**inputs))
            loaded = self.model.dataset.get_features(features)
            if self._batcher is not None:
                return _to_jsonable(self._batcher.submit(loaded))
            return _to_jsonable(
                self.model.predict_from_features_workflow()(
                    model_object=self.model.artifact.model_object,
                    features=loaded,
                )
            )

    def predict_stream(self, payload: dict):
        """Yield token chunks for ONE prompt (the SSE event source).

        ``{"features": [prompt]}`` (a single row, or a one-row list) —
        the reader-kwargs ``inputs`` form is not streamable because it
        runs the full predict workflow in one call.
        """
        if self._draining:
            raise EngineUnavailable(
                "serving app is draining and not accepting requests",
                reason="draining", retry_after_s=1.0,
            )
        if self._stream_fn is None:
            raise ValueError(
                "streaming is not enabled on this app — construct "
                "ServingApp(stream=...) with an engine-backed generator"
            )
        if self.model.artifact is None:
            self.setup_model()
        features = payload.get("features")
        if not features:
            raise ValueError(
                "streaming requires non-empty 'features' (a single "
                "token-id prompt or a one-element list of prompts)"
            )
        rows = features if isinstance(features[0], (list, tuple)) else [features]
        if len(rows) != 1:
            raise ValueError(
                f"streaming serves one prompt per request, got {len(rows)}"
            )
        loaded = self.model.dataset.get_features(rows)
        # same payload-contract cap as predict() — but a generator-
        # backed stream hook defers its body (where the engine reads
        # the ambient cap) to the FIRST next(), which happens after
        # this frame returns. The wrapper re-opens the scope around
        # exactly that first pull, so the cap binds for ANY caller of
        # this public method, not just predict_stream_events.
        cap = validate_token_cap(payload.get("max_new_tokens"))
        stream = self._stream_fn(self.model.artifact.model_object, loaded)
        if cap is None:
            return stream

        def capped():
            it = iter(stream)
            with token_cap_scope(cap):
                try:
                    first = next(it)
                except StopIteration:
                    return
            yield first
            yield from it

        return capped()

    def predict_stream_events(self, payload: dict):
        """The SSE wire protocol, shared by every transport: an iterator
        of pre-framed ``data: ...\\n\\n`` strings — one ``{"tokens"}``
        event per harvested chunk, then ``{"done", "n_tokens"}``.

        Validation raises BEFORE the first string exists (the first
        chunk is pulled eagerly here — generator-backed streams defer
        their checks to the first ``next()``, and those errors still
        deserve a 422 response, not a committed-then-dropped 200).
        The payload token cap binds inside :meth:`predict_stream`'s
        wrapper (its one home), which covers this eager pull too.
        """
        it = iter(self.predict_stream(payload))
        try:
            first = [next(it)]
        except StopIteration:
            first = []

        def frames():
            n = 0
            for chunk in itertools.chain(first, it):
                toks = _to_jsonable(chunk)
                n += len(toks)
                yield f"data: {json.dumps({'tokens': toks})}\n\n"
            yield f"data: {json.dumps({'done': True, 'n_tokens': n})}\n\n"

        return frames()

    # -- stdlib HTTP transport --------------------------------------------

    def _make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            # per-request telemetry, set by the do_* wrappers
            _rid = ""
            _status = 0
            _trace_ctx: Optional[telemetry.TraceContext] = None
            _tenant = DEFAULT_TENANT
            _priority = DEFAULT_PRIORITY
            _model_version = DEFAULT_MODEL_VERSION

            def log_message(self, fmt, *args):
                logger.info(f"http: {fmt % args}")

            def _send(self, code: int, body: Any, content_type="application/json",
                      extra_headers: Optional[dict] = None):
                data = (
                    body.encode() if isinstance(body, str) else json.dumps(body).encode()
                )
                self._status = code
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Request-ID", self._rid)
                self.send_header("X-Tenant-ID", self._tenant)
                self.send_header("X-Priority", self._priority)
                self.send_header("X-Model-Version", self._model_version)
                if self._trace_ctx is not None:
                    self.send_header(
                        "traceparent",
                        telemetry.format_traceparent(self._trace_ctx),
                    )
                for name, value in (extra_headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(data)

            def _route(self):
                """``(path, query)`` with the query string split off —
                ``/debug/flight?n=5`` must route as ``/debug/flight``
                (and land in that metric series, not ``<other>``)."""
                parts = urlsplit(self.path)
                return parts.path, parse_qs(parts.query)

            def _observed(self, handler):
                """Wrap one request: mint the X-Request-ID, resolve the
                W3C trace context (predict routes open a recorded
                server timeline; everything else just echoes), time
                the dispatch, land the per-endpoint series."""
                self._rid = telemetry.new_request_id()
                self._status = 0
                path = self._route()[0]
                raw_tp = self.headers.get("traceparent")
                t0 = time.perf_counter()
                try:
                    try:
                        # validated at the boundary: a hostile tenant
                        # or priority header answers 422 before any
                        # route logic, and can never reach a label
                        # value or the scheduler
                        self._tenant = validate_tenant(
                            self.headers.get("X-Tenant-ID")
                        )
                        self._priority = validate_priority(
                            self.headers.get("X-Priority")
                        )
                        self._model_version = validate_model_version(
                            self.headers.get("X-Model-Version")
                        )
                    except ValueError as exc:
                        self._trace_ctx = telemetry.server_trace_context(
                            raw_tp
                        )
                        self._send(422, {"error": str(exc)})
                        return
                    # method-checked: a GET probe/scan of /predict 404s
                    # without opening a recorded timeline, so probes
                    # can never churn the trace ring or the OTLP queue
                    if path in TRACED_ROUTES and self.command == "POST":
                        # the timeline is keyed by the response's
                        # X-Request-ID, so /debug/trace?rid= answers
                        # with the id the client actually holds
                        with app.traced_request(
                            path, raw_tp, rid=self._rid
                        ) as ctx:
                            self._trace_ctx = ctx
                            # visible to engine/batcher submissions on
                            # this request thread (deadline-scope-style)
                            with tenant_scope(self._tenant), \
                                    priority_scope(self._priority), \
                                    model_version_scope(
                                        self._model_version):
                                handler()
                    else:
                        self._trace_ctx = telemetry.server_trace_context(raw_tp)
                        handler()
                finally:
                    app.observe_request(
                        "stdlib", path, self._status or 500,
                        (time.perf_counter() - t0) * 1e3,
                    )

            def do_GET(self):
                self._observed(self._get)

            def do_POST(self):
                self._observed(self._post)

            def _get(self):
                path, query = self._route()
                if path == "/":
                    self._send(200, app.root(), content_type="text/html")
                elif path == "/health":
                    h = app.health()
                    self._send(app.health_status(h), h)
                elif path == "/stats":
                    self._send(200, app.stats())
                elif path == "/metrics":
                    self._send(
                        200, app.metrics_text(),
                        content_type=telemetry.EXPOSITION_CONTENT_TYPE,
                    )
                elif path == "/debug/memory":
                    self._send(200, app.debug_memory())
                elif path == "/debug/flight":
                    try:
                        n = (
                            int(query["n"][0]) if "n" in query else None
                        )
                        kind = query.get("kind", [None])[0]
                        rid = query.get("rid", [None])[0]
                        tenant = query.get("tenant", [None])[0]
                        phase = query.get("phase", [None])[0]
                    except (ValueError, IndexError) as exc:
                        self._send(422, {"error": f"bad query: {exc}"})
                        return
                    self._send(200, app.debug_flight(
                        n=n, kind=kind, rid=rid, tenant=tenant,
                        phase=phase,
                    ))
                elif path == "/debug/usage":
                    try:
                        self._send(200, app.debug_usage())
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/cache/peek":
                    try:
                        self._send(200, app.debug_cache_peek(
                            query.get("prompt", [""])[0]
                        ))
                    except (ValueError, TypeError) as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/trace":
                    fmt = query.get("format", ["chrome"])[0]
                    try:
                        body, content_type = app.debug_trace(
                            fmt,
                            rid=query.get("rid", [None])[0],
                            trace=query.get("trace", [None])[0],
                        )
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                        return
                    self._send(200, body, content_type=content_type)
                elif path == "/debug/slo":
                    try:
                        self._send(200, app.debug_slo())
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/fleet":
                    try:
                        self._send(200, app.debug_fleet())
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/rollout":
                    try:
                        self._send(200, app.debug_rollout())
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/goodput":
                    try:
                        self._send(200, app.debug_goodput())
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                elif path == "/debug/tail":
                    try:
                        self._send(200, app.debug_tail(
                            metric=query.get("metric", [""])[0],
                            n=(
                                int(query["n"][0])
                                if "n" in query else None
                            ),
                        ))
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                else:
                    self._send(404, {"error": f"no route {path}"})

            def _send_sse(self, frames):
                """Stream pre-framed SSE strings; the connection closes
                at end-of-stream (no Content-Length — ``Connection:
                close`` delimits the body for HTTP/1.x clients). Once
                the 200 is committed, a mid-stream failure can only
                surface as a dropped connection — the SSE contract —
                never as a second response spliced into the body."""
                self._status = 200
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.send_header("X-Request-ID", self._rid)
                self.send_header("X-Tenant-ID", self._tenant)
                self.send_header("X-Priority", self._priority)
                self.send_header("X-Model-Version", self._model_version)
                if self._trace_ctx is not None:
                    self.send_header(
                        "traceparent",
                        telemetry.format_traceparent(self._trace_ctx),
                    )
                self.end_headers()
                try:
                    for frame in frames:
                        self.wfile.write(frame.encode())
                        self.wfile.flush()
                except BrokenPipeError:
                    pass  # client went away: the engine's generator
                    # cleanup (GeneratorExit → abandoned) stops the work
                except Exception as exc:
                    logger.info(f"stream aborted mid-flight: {exc!r}")
                finally:
                    self.close_connection = True

            def _post(self):
                path, query = self._route()
                if path == "/debug/profile":
                    self._debug_profile(query)
                    return
                if path in ("/debug/kv/export", "/debug/kv/import"):
                    self._debug_kv(path)
                    return
                if path not in ("/predict", "/predict/stream"):
                    self._send(404, {"error": f"no route {path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError as exc:
                        self._send(422, {"error": f"request body must be JSON: {exc}"})
                        return
                    try:
                        deadline_ms = parse_deadline_header(
                            self.headers.get("X-Deadline-Ms")
                        )
                    except ValueError as exc:
                        self._send(422, {"error": str(exc)})
                        return
                    # the scope makes the deadline visible to engine/
                    # batcher submissions on this request thread without
                    # threading a kwarg through every predictor wrapper
                    with deadline_scope(deadline_ms):
                        if path == "/predict/stream":
                            # predict_stream_events validates (and pulls
                            # the first chunk) BEFORE this point commits
                            # a 200 — errors still get a whole 4xx/5xx
                            self._send_sse(app.predict_stream_events(payload))
                        else:
                            self._send(200, app.predict(payload))
                except (Overloaded, EngineUnavailable, DeadlineExceeded) as exc:
                    # typed load shed: the faults.http_fault_response
                    # contract (429/503 + Retry-After, 504) both
                    # transports share
                    status, extra = http_fault_response(exc)
                    body = {"error": str(exc)}
                    if isinstance(exc, EngineUnavailable):
                        body["reason"] = exc.reason
                    self._send(status, body, extra_headers=extra or None)
                except (ValueError, KeyError, TypeError) as exc:
                    self._send(422, {"error": str(exc)})
                except Exception as exc:  # unexpected: surface as 500
                    logger.info(f"predict error: {exc!r}")
                    self._send(500, {"error": str(exc)})

            def _debug_kv(self, path):
                """POST /debug/kv/export | /debug/kv/import — the
                cross-host KV handoff surface (JSON body either way;
                422 on an unwired hook or malformed body)."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        payload = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError as exc:
                        self._send(
                            422,
                            {"error": f"request body must be JSON: {exc}"},
                        )
                        return
                    if not isinstance(payload, dict):
                        # `[]`/`"x"` parse as JSON but aren't the
                        # object contract — 422 like the FastAPI
                        # transport's `payload: dict` coercion, never
                        # a 500 from payload.get
                        self._send(
                            422,
                            {"error": "request body must be a JSON "
                                      "object"},
                        )
                        return
                    if path == "/debug/kv/export":
                        self._send(200, app.debug_kv_export(
                            payload.get("prompt") or []
                        ))
                    else:
                        self._send(200, app.debug_kv_import(
                            payload.get("entries")
                        ))
                except (ValueError, KeyError, TypeError) as exc:
                    self._send(422, {"error": str(exc)})
                except Exception as exc:
                    logger.info(f"kv handoff error: {exc!r}")
                    self._send(500, {"error": str(exc)})

            def _debug_profile(self, query):
                """POST /debug/profile?seconds=N (or a {"seconds": N}
                JSON body): blocking on-demand profiler capture; 409
                while another capture runs."""
                from unionml_tpu_torch.introspection import ProfileInProgress

                try:
                    seconds = None
                    if "seconds" in query:
                        seconds = float(query["seconds"][0])
                    else:
                        length = int(self.headers.get("Content-Length", 0))
                        if length:
                            body = json.loads(self.rfile.read(length))
                            if "seconds" in body:
                                seconds = float(body["seconds"])
                    result = app.debug_profile(
                        **({} if seconds is None else {"seconds": seconds})
                    )
                    self._send(200, result)
                except ProfileInProgress as exc:
                    self._send(409, {"error": str(exc)})
                except (ValueError, TypeError, json.JSONDecodeError) as exc:
                    self._send(422, {"error": str(exc)})
                except Exception as exc:
                    logger.info(f"profile capture error: {exc!r}")
                    self._send(500, {"error": str(exc)})

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000, *, blocking: bool = True):
        """Start the HTTP server; ``blocking=False`` runs it on a thread and
        returns the bound ``(host, port)``."""
        self.setup_model()
        self._server = ThreadingHTTPServer((host, port), self._make_handler())
        bound = self._server.server_address
        logger.info(f"serving {self.model.name} on http://{bound[0]}:{bound[1]}")
        if blocking:
            try:
                self._server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                self._server.server_close()
        else:
            thread = threading.Thread(target=self._server.serve_forever, daemon=True)
            thread.start()
        return bound

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        if self._otlp is not None:
            self._otlp.close()
            self._otlp = None
        if self._slo is not None:
            self._slo.stop()


def create_app(model, **kwargs) -> ServingApp:
    """Build a :class:`ServingApp` for ``model`` (the dependency-free analog
    of mounting routes on a FastAPI app)."""
    return ServingApp(model, **kwargs)
