"""FastAPI adapter: mount the serving surface on a user-supplied app.

The port of :mod:`unionml_tpu_torch.serving.fastapi` (``serving_app``). Every
route delegates to :class:`unionml_tpu_torch.serving.http.ServingApp`, so
the stdlib and FastAPI transports cannot drift. FastAPI is optional and is
imported only inside :func:`serving_app` when an ``app`` is given; without
it, pass ``app=None`` to ``Model.serve`` (or use
``unionml_tpu_torch.serving.create_app``) for the stdlib transport.
"""

from __future__ import annotations

import time
from typing import Any, Optional

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
    model_version_scope,
    priority_scope,
    validate_model_version,
    validate_priority,
)
from unionml_tpu_torch.serving.usage import tenant_scope, validate_tenant


def serving_app(
    model,
    app: Any = None,
    *,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    batch: bool = False,
    core: Optional[ServingApp] = None,
    **batcher_kwargs,
):
    """Mount ``/``, ``/predict``, ``/health`` (reference: fastapi.py:15-70).

    With ``app=None`` returns the dependency-free :class:`ServingApp`;
    otherwise ``app`` must be a FastAPI instance.

    ``core``: mount a pre-built :class:`ServingApp` (or subclass —
    e.g. the fleet router's :func:`~unionml_tpu_torch.serving.router
    .make_router_app` front door) instead of constructing one from
    ``model``; every route below dispatches through the core, so the
    router speaks FastAPI exactly as it speaks the stdlib transport.
    ``model`` and the construction kwargs are ignored when given.
    """
    if core is None:
        core = ServingApp(
            model,
            remote=remote,
            app_version=app_version,
            model_version=model_version,
            batch=batch,
            **batcher_kwargs,
        )
    if app is None:
        return core

    try:
        from fastapi import FastAPI, HTTPException, Request, Response  # gated optional import
        from fastapi.responses import HTMLResponse
    except ImportError as exc:
        raise ImportError(
            "fastapi is not installed. Pass app=None (or use "
            "unionml_tpu_torch.serving.create_app) for the dependency-free HTTP "
            "server, or install fastapi+uvicorn."
        ) from exc

    if not isinstance(app, FastAPI):
        raise TypeError(f"app must be a FastAPI instance, got {type(app)}")

    @app.on_event("startup")
    async def setup_model():  # reference: fastapi.py:22-34
        core.setup_model()

    @app.get("/", response_class=HTMLResponse)
    def root():  # reference: fastapi.py:36-48
        return core.root()

    def _parse_deadline(request) -> Optional[float]:
        try:  # the shared parser: the two transports cannot drift
            return parse_deadline_header(request.headers.get("x-deadline-ms"))
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    def _parse_tenant(request) -> str:
        try:  # the shared validator: same 422 contract as stdlib
            return validate_tenant(request.headers.get("x-tenant-id"))
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    def _parse_priority(request) -> str:
        try:  # the shared validator: same 422 contract as stdlib
            return validate_priority(request.headers.get("x-priority"))
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    def _parse_model_version(request) -> str:
        try:  # the shared validator: same 422 contract as stdlib
            return validate_model_version(
                request.headers.get("x-model-version")
            )
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    def _fault_http(
        exc: Exception, rid: Optional[str] = None
    ) -> "HTTPException":
        """The faults.http_fault_response contract (429/503 +
        Retry-After, 504) — same mapping the stdlib transport sends.
        ``rid`` rides the error headers: Starlette discards the
        route's Response on an HTTPException, so without this the
        middleware would stamp a DIFFERENT X-Request-ID than the one
        the recorded timeline is keyed by — and /debug/trace?rid=
        would 422 for exactly the failed requests an operator wants
        to trace."""
        status, extra = http_fault_response(exc)
        headers = dict(extra or {})
        if rid is not None:
            headers["X-Request-ID"] = rid
        return HTTPException(
            status_code=status, detail=str(exc), headers=headers or None
        )

    def _invalid_http(
        exc: Exception, rid: Optional[str] = None
    ) -> "HTTPException":
        """422 with the timeline rid riding the headers (same reason
        as :func:`_fault_http`)."""
        return HTTPException(
            status_code=422, detail=str(exc),
            headers={"X-Request-ID": rid} if rid is not None else None,
        )

    _FAULTS = (Overloaded, EngineUnavailable, DeadlineExceeded)

    # sync `def` (here and on /predict/stream), not `async def`: FastAPI
    # then runs the blocking predictor call in the threadpool instead of
    # freezing the event loop — and the thread-local deadline_scope AND
    # trace_scope stay on the thread that performs the engine/batcher
    # submission (the middleware's thread is the event loop's, so the
    # traceparent must be parsed HERE, like the deadline header).
    @app.post("/predict")
    def predict(payload: dict, request: Request, response: Response):
        # reference: fastapi.py:50-64. The route mints the request id
        # itself and keys the recorded timeline by it (the middleware
        # only fills X-Request-ID when a route didn't), so
        # /debug/trace?rid=<X-Request-ID> resolves the id the client
        # actually received — same contract as the stdlib transport.
        rid = telemetry.new_request_id()
        response.headers["X-Request-ID"] = rid
        try:
            with core.traced_request(
                "/predict", request.headers.get("traceparent"), rid=rid,
            ) as ctx:
                response.headers["traceparent"] = (
                    telemetry.format_traceparent(ctx)
                )
                # tenant/priority parsed HERE like the deadline: the
                # scopes must live on the threadpool thread that
                # submits to the engine/batcher, not the event loop's
                with tenant_scope(_parse_tenant(request)):
                    with priority_scope(_parse_priority(request)), \
                            model_version_scope(
                                _parse_model_version(request)):
                        with deadline_scope(_parse_deadline(request)):
                            return core.predict(payload)
        except _FAULTS as exc:
            raise _fault_http(exc, rid)
        except HTTPException:
            raise  # header-parse 422s: already shaped
        except (ValueError, KeyError, TypeError) as exc:
            raise _invalid_http(exc, rid)

    # the body's blocking first-chunk pull — queue + prefill, ~120 ms at
    # 8B, up to submit_timeout on a wedged engine — also runs in the
    # threadpool. The wire framing comes from the shared
    # core.predict_stream_events, so the two transports cannot drift.
    @app.post("/predict/stream")
    def predict_stream(payload: dict, request: Request):  # SSE token streaming
        from fastapi.responses import StreamingResponse

        # the open/finish seam, not the context manager: the response
        # body outlives this handler frame, and the server span must
        # cover the WHOLE stream (parity with the stdlib transport),
        # so the timeline closes when the frame generator does. The
        # trace_scope itself only needs to cover the validating
        # first-chunk pull — that is where the engine timeline is
        # created and parented.
        rid = telemetry.new_request_id()
        ctx, finish = core.open_traced_request(
            "/predict/stream", request.headers.get("traceparent"),
            rid=rid,
        )
        try:
            with telemetry.trace_scope(ctx):
                with tenant_scope(_parse_tenant(request)):
                    with priority_scope(_parse_priority(request)), \
                            model_version_scope(
                                _parse_model_version(request)):
                        with deadline_scope(_parse_deadline(request)):
                            frames = core.predict_stream_events(payload)
        except _FAULTS as exc:
            finish()
            raise _fault_http(exc, rid)
        except HTTPException:
            finish()
            raise  # header-parse 422s: already shaped
        except (ValueError, KeyError, TypeError) as exc:
            finish()
            raise _invalid_http(exc, rid)
        except BaseException:
            finish()
            raise

        def stream_then_finish():
            try:
                yield from frames
            finally:
                finish()

        return StreamingResponse(
            stream_then_finish(), media_type="text/event-stream",
            headers={
                "traceparent": telemetry.format_traceparent(ctx),
                "X-Request-ID": rid,
            },
        )

    @app.get("/health")
    async def health():  # reference: fastapi.py:66-70
        from fastapi.responses import JSONResponse

        h = core.health()
        # same not-ready => 503 contract as the stdlib transport
        return JSONResponse(h, status_code=core.health_status(h))

    @app.get("/stats")
    async def stats():  # no reference counterpart: latency attribution
        return core.stats()

    @app.get("/metrics")
    async def metrics():  # Prometheus scrape (same body as the stdlib app)
        from fastapi.responses import Response

        return Response(
            core.metrics_text(),
            media_type=telemetry.EXPOSITION_CONTENT_TYPE,
        )

    # debug/introspection surface (docs/observability.md) — same
    # ServingApp methods as the stdlib transport, so the two cannot
    # drift. Sync `def` for the profiler capture: it blocks for the
    # capture window and must not freeze the event loop.
    @app.post("/debug/profile")
    def debug_profile(seconds: float = 2.0):
        from unionml_tpu_torch.introspection import ProfileInProgress

        try:
            return core.debug_profile(seconds)
        except ProfileInProgress as exc:
            raise HTTPException(status_code=409, detail=str(exc))
        except (ValueError, TypeError) as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/memory")
    async def debug_memory():
        return core.debug_memory()

    @app.get("/debug/flight")
    async def debug_flight(
        n: Optional[int] = None,
        kind: Optional[str] = None,
        rid: Optional[str] = None,
        tenant: Optional[str] = None,
        phase: Optional[str] = None,
    ):
        return core.debug_flight(
            n=n, kind=kind, rid=rid, tenant=tenant, phase=phase,
        )

    # the cross-host KV handoff surface (docs/serving.md
    # "Disaggregated serving") — same ServingApp methods as the
    # stdlib transport. Sync `def`: the export may briefly poll for
    # in-flight inserts and must not freeze the event loop.
    @app.post("/debug/kv/export")
    def debug_kv_export(payload: dict):
        try:
            return core.debug_kv_export(payload.get("prompt") or [])
        except (ValueError, TypeError) as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.post("/debug/kv/import")
    def debug_kv_import(payload: dict):
        try:
            return core.debug_kv_import(payload.get("entries"))
        except (ValueError, TypeError) as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/usage")
    async def debug_usage():
        try:
            return core.debug_usage()
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/cache/peek")
    async def debug_cache_peek(prompt: str = ""):
        try:
            return core.debug_cache_peek(prompt)
        except (ValueError, TypeError) as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/trace")
    async def debug_trace(
        format: str = "chrome",
        rid: Optional[str] = None,
        trace: Optional[str] = None,
    ):
        from fastapi.responses import Response as RawResponse

        try:
            body, content_type = core.debug_trace(
                format, rid=rid, trace=trace,
            )
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))
        if isinstance(body, str):
            return RawResponse(body, media_type=content_type)
        return body  # chrome/stitched: plain JSON

    @app.get("/debug/slo")
    async def debug_slo():
        try:
            return core.debug_slo()
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/fleet")
    async def debug_fleet():
        try:
            return core.debug_fleet()
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/rollout")
    async def debug_rollout():
        try:
            return core.debug_rollout()
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/goodput")
    async def debug_goodput():
        try:
            return core.debug_goodput()
        except ValueError as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    @app.get("/debug/tail")
    async def debug_tail(metric: str = "", n: Optional[int] = None):
        try:
            return core.debug_tail(metric=metric, n=n)
        except (ValueError, TypeError) as exc:
            raise HTTPException(status_code=422, detail=str(exc))

    # one middleware gives every route the X-Request-ID header, the
    # traceparent echo (predict endpoints already set their recorded
    # server context — setdefault keeps it), and the per-endpoint
    # request/error/latency series, through the SAME
    # ServingApp.observe_request the stdlib transport uses
    @app.middleware("http")
    async def telemetry_middleware(request, call_next):
        rid = telemetry.new_request_id()
        t0 = time.perf_counter()
        try:
            # same boundary validation as the stdlib transport: a
            # hostile X-Tenant-ID, X-Priority, or X-Model-Version
            # answers 422 before any route runs
            tenant = validate_tenant(request.headers.get("x-tenant-id"))
            priority = validate_priority(request.headers.get("x-priority"))
            model_version = validate_model_version(
                request.headers.get("x-model-version")
            )
        except ValueError as exc:
            from fastapi.responses import JSONResponse

            core.observe_request(
                "fastapi", request.url.path, 422,
                (time.perf_counter() - t0) * 1e3,
            )
            return JSONResponse(
                {"detail": str(exc)}, status_code=422,
                headers={"X-Request-ID": rid},
            )
        try:
            response = await call_next(request)
        except BaseException:
            # an unhandled endpoint error becomes a 500 OUTSIDE this
            # middleware — record it or error traffic is invisible in
            # /metrics (the stdlib transport records it via try/finally)
            core.observe_request(
                "fastapi", request.url.path, 500,
                (time.perf_counter() - t0) * 1e3,
            )
            raise
        # the predict routes set their OWN X-Request-ID (the id their
        # recorded timeline is keyed by — /debug/trace?rid= must
        # resolve it); the middleware fills it everywhere else
        if "X-Request-ID" not in response.headers:
            response.headers["X-Request-ID"] = rid
        response.headers["X-Tenant-ID"] = tenant
        response.headers["X-Priority"] = priority
        response.headers["X-Model-Version"] = model_version
        if "traceparent" not in response.headers:
            response.headers["traceparent"] = telemetry.format_traceparent(
                telemetry.server_trace_context(
                    request.headers.get("traceparent")
                )
            )
        core.observe_request(
            "fastapi", request.url.path, response.status_code,
            (time.perf_counter() - t0) * 1e3,
        )
        return response

    app.state.unionml_tpu_torch = core
    return app
