"""Serverless serving adapters: gateway events and object-store events.

The port of :mod:`unionml_tpu_torch.serving.serverless`. The adapters speak the
API-Gateway and S3 event *shapes* directly (no Mangum, no boto3) and route
to the transport-agnostic
:class:`~unionml_tpu_torch.serving.http.ServingApp`:

- :func:`gateway_handler` — API-Gateway-style ``{httpMethod, path, body}``
  events → ``{statusCode, headers, body}`` responses (GET /,
  GET /health with the non-ok→503 readiness contract, GET /stats,
  Prometheus GET /metrics, POST /predict with the shared
  429/503/504 fault mapping and ``X-Deadline-Ms`` propagation; every
  response carries ``X-Request-ID``). Works as an AWS Lambda handler
  as-is, with the same serving contract as the HTTP transports.
- :func:`object_event_handler` — S3-style ``{Records: [{s3: {bucket,
  object}}]}`` events: read the uploaded feature file from an
  :class:`ObjectStore`, predict, write ``<key>.predictions.json`` back.
  ``LocalObjectStore`` maps bucket/key onto a directory for tests and
  on-prem use; a boto3-backed store can be swapped in without touching
  the handler.

A Llama predictor behind these handlers runs on the card like any other
``ServingApp`` (the micro-batcher's prefills launch kernel rows 1 and 2).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional
from urllib.parse import unquote_plus

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    deadline_scope,
    http_fault_response,
    parse_deadline_header,
)
from unionml_tpu_torch.serving.http import ServingApp
from unionml_tpu_torch.serving.scheduler import (
    DEFAULT_MODEL_VERSION,
    DEFAULT_PRIORITY,
    model_version_scope,
    priority_scope,
    validate_model_version,
    validate_priority,
)
from unionml_tpu_torch.serving.usage import (
    DEFAULT_TENANT,
    tenant_scope,
    validate_tenant,
)


class ObjectStore:
    """Minimal bucket/key object interface the event handler needs."""

    def get(self, bucket: str, key: str) -> bytes:
        raise NotImplementedError

    def put(self, bucket: str, key: str, data: bytes) -> None:
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    """Directory-backed store: ``root/bucket/key``.

    Bucket/key come from untrusted event payloads, so every path is
    resolved and checked to stay under ``root`` (no traversal via
    ``../`` or absolute keys).
    """

    def __init__(self, root: str):
        self.root = Path(root).resolve()

    def _path(self, bucket: str, key: str) -> Path:
        path = (self.root / bucket / key).resolve()
        if not path.is_relative_to(self.root):
            raise ValueError(f"object path escapes store root: {bucket!r}/{key!r}")
        return path

    def get(self, bucket: str, key: str) -> bytes:
        return self._path(bucket, key).read_bytes()

    def put(self, bucket: str, key: str, data: bytes) -> None:
        path = self._path(bucket, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)


def _event_headers(event: Dict[str, Any]) -> Dict[str, str]:
    """Case-folded request headers from a gateway event (API-Gateway
    forwards client headers lowercased in v2 events, mixed-case in v1)."""
    raw = event.get("headers") or {}
    return {str(k).lower(): str(v) for k, v in raw.items()}


def gateway_handler(
    model,
    *,
    batch: bool = False,
    **serving_kwargs,
) -> Callable[[Dict[str, Any], Any], Dict[str, Any]]:
    """Build a ``handler(event, context)`` for API-Gateway-style events.

    Same serving contract as the HTTP transports
    (:mod:`unionml_tpu_torch.serving.http` / ``fastapi``):

    - ``GET /metrics`` — Prometheus exposition of the app's registry,
    - ``GET /debug/trace?format=chrome|jsonl``, ``GET /debug/slo``,
      and ``GET /debug/usage`` — the trace export, SLO burn-rate
      report, and per-tenant usage report, same contract as the HTTP
      transports,
    - tenant identity: an ``X-Tenant-ID`` request header is validated
      (over 64 chars / non-printable → **422**, default
      ``anonymous``), echoed on every response, and scoped around
      ``POST /predict`` so engine/batcher usage ledgers bill the
      request's resource vector to it,
    - every response carries ``X-Request-ID`` (the incoming header is
      echoed when the gateway forwarded one, else a fresh id is
      minted) and lands in the ``transport="serverless"`` request
      series,
    - W3C trace propagation: an inbound ``traceparent`` header is
      parsed (a root is minted when absent/malformed), ``POST
      /predict`` opens the shared
      :meth:`~unionml_tpu_torch.serving.http.ServingApp.traced_request`
      timeline so engine/batcher spans join the caller's trace, and
      every response echoes a ``traceparent``,
    - ``GET /health`` answers **503** for any non-``ok`` status
      (draining / circuit breaker), so gateway health checks stop
      routing here,
    - typed serving faults map to the shared HTTP contract:
      ``Overloaded`` → 429 + ``Retry-After``, ``EngineUnavailable`` →
      503 + ``Retry-After``, ``DeadlineExceeded`` → 504; an
      ``X-Deadline-Ms`` request header opens the same
      :func:`~unionml_tpu_torch.serving.faults.deadline_scope`,
    - validation errors answer **422** (parity with both HTTP
      transports; this was 400 before the contract was unified).
    """
    app = ServingApp(model, batch=batch, **serving_kwargs)

    def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, Any]:
        method = (event.get("httpMethod") or event.get("requestContext", {})
                  .get("http", {}).get("method", "GET")).upper()
        path = event.get("path") or event.get("rawPath") or "/"
        headers = _event_headers(event)
        rid = headers.get("x-request-id") or telemetry.new_request_id()
        raw_traceparent = headers.get("traceparent")
        # echoed on every response; /predict swaps in its recorded
        # server-span context below so callers stitch the full tree
        trace_ctx = telemetry.server_trace_context(raw_traceparent)
        tenant = DEFAULT_TENANT
        priority = DEFAULT_PRIORITY
        model_version = DEFAULT_MODEL_VERSION
        t0 = time.perf_counter()

        def respond(
            status: int, body: str, content_type: str = "application/json",
            extra: Optional[Dict[str, str]] = None,
        ) -> Dict[str, Any]:
            app.observe_request(
                "serverless", path, status,
                (time.perf_counter() - t0) * 1e3,
            )
            return {
                "statusCode": status,
                "headers": {
                    "Content-Type": content_type,
                    "X-Request-ID": rid,
                    "X-Tenant-ID": tenant,
                    "X-Priority": priority,
                    "X-Model-Version": model_version,
                    "traceparent": telemetry.format_traceparent(trace_ctx),
                    **(extra or {}),
                },
                "body": body,
            }

        try:
            # validated at the boundary (422 via the ValueError arm
            # below), echoed on every response like the HTTP transports
            tenant = validate_tenant(headers.get("x-tenant-id"))
            priority = validate_priority(headers.get("x-priority"))
            model_version = validate_model_version(
                headers.get("x-model-version")
            )
            if method == "GET" and path == "/":
                return respond(200, app.root(), content_type="text/html")
            if method == "GET" and path == "/health":
                h = app.health()
                # non-ok => 503, the readiness contract the HTTP
                # transports already serve (docs/robustness.md)
                return respond(app.health_status(h), json.dumps(h))
            if method == "GET" and path == "/stats":
                return respond(200, json.dumps(app.stats()))
            if method == "GET" and path == "/metrics":
                return respond(
                    200, app.metrics_text(),
                    content_type=telemetry.EXPOSITION_CONTENT_TYPE,
                )
            if method == "GET" and path == "/debug/trace":
                qs = event.get("queryStringParameters") or {}
                body_out, content_type = app.debug_trace(
                    qs.get("format", "chrome"),
                    rid=qs.get("rid"), trace=qs.get("trace"),
                )
                if not isinstance(body_out, str):
                    body_out = json.dumps(body_out)
                return respond(200, body_out, content_type=content_type)
            if method == "GET" and path == "/debug/slo":
                return respond(200, json.dumps(app.debug_slo()))
            if method == "GET" and path == "/debug/usage":
                return respond(200, json.dumps(app.debug_usage()))
            if method == "POST" and path == "/predict":
                payload = json.loads(event.get("body") or "{}")
                deadline_ms = parse_deadline_header(
                    headers.get("x-deadline-ms")
                )
                # keyed by the response X-Request-ID, so
                # /debug/trace?rid= resolves the id the client holds
                with app.traced_request(
                    "/predict", raw_traceparent, rid=rid,
                ) as ctx:
                    trace_ctx = ctx
                    with tenant_scope(tenant):
                        with priority_scope(priority), \
                                model_version_scope(model_version):
                            with deadline_scope(deadline_ms):
                                return respond(
                                    200, json.dumps(app.predict(payload))
                                )
            return respond(
                404, json.dumps({"error": f"no route {method} {path}"})
            )
        except (Overloaded, EngineUnavailable, DeadlineExceeded) as e:
            status, extra = http_fault_response(e)
            body: Dict[str, Any] = {"error": str(e)}
            if isinstance(e, EngineUnavailable):
                body["reason"] = e.reason
            return respond(status, json.dumps(body), extra=extra or None)
        except (ValueError, KeyError, TypeError) as e:
            return respond(422, json.dumps({"error": str(e)}))
        except Exception as e:  # pragma: no cover - defensive 500 surface
            return respond(500, json.dumps({"error": str(e)}))

    handler.serving_app = app  # test/introspection seam
    return handler


def object_event_handler(
    model,
    store: ObjectStore,
    *,
    output_suffix: str = ".predictions.json",
    parse: Optional[Callable[[bytes], Any]] = None,
) -> Callable[[Dict[str, Any], Any], Dict[str, Any]]:
    """Build a ``handler(event, context)`` for S3-style object events.

    For each record, reads the object, runs it through the dataset's
    feature pipeline + predictor, and writes predictions next to the
    input under ``key + output_suffix``.
    """
    app = ServingApp(model)
    parse = parse or (lambda raw: json.loads(raw.decode()))

    def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, Any]:
        outputs = []
        errors = []
        for record in event.get("Records", []):
            s3 = record.get("s3", {})
            bucket = s3.get("bucket", {}).get("name")
            key = s3.get("object", {}).get("key")
            if not bucket or not key:
                continue
            # real S3 notifications URL-encode keys ("my file" -> "my+file")
            key = unquote_plus(key)
            try:
                features = parse(store.get(bucket, key))
                preds = app.predict({"features": features})
                out_key = key + output_suffix
                # predict() output is already JSON-safe (ServingApp contract)
                store.put(bucket, out_key, json.dumps(preds).encode())
                outputs.append({"bucket": bucket, "key": out_key})
            except Exception as e:
                # one bad object must not abort the batch: report it and
                # keep the already-written outputs visible to the caller
                errors.append({"bucket": bucket, "key": key, "error": str(e)})
        body = {"outputs": outputs}
        if errors:
            body["errors"] = errors
        return {"statusCode": 200 if not errors else 207, "body": json.dumps(body)}

    handler.serving_app = app
    return handler
