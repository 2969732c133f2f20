"""Distributed tracing in the port: the twins of ``tests/unit/test_tracing.py``
whose subjects no other port test covers (the OTLP encoders and the
exporter's retries and queue are in ``tests/test_torch_exporters.py``).

W3C ``traceparent`` parse / format / scope (each header through both
packages, their contexts equal), the recorder's parent links and span
cap, finish listeners, the exporter's resource carrying the reference's
``unionml_tpu.backend`` key, the transport round trip over the stdlib
server (inbound header to batcher span parentage to response echo, a
malformed header minting a root), the batcher's and the serverless
gateway's spans, and the engine's spans joining an inbound trace (the
reference's tiny Llama bridged by ``from_jax_params``, on the CPU). The
FastAPI parity case needs ``fastapi``, which is not installed everywhere:
it skips without it, as the reference's does.
"""

import json
import threading

import httpx
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unionml_tpu import telemetry as jtelemetry

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.exporters import OtlpCollectorStub, OtlpExporter
from unionml_tpu_torch.serving.batcher import MicroBatcher
from unionml_tpu_torch.serving.http import KNOWN_ROUTES, ServingApp
from unionml_tpu_torch.serving.serverless import gateway_handler
from unionml_tpu_torch.telemetry import (
    MetricsRegistry,
    TraceContext,
    TraceRecorder,
    format_traceparent,
    parse_traceparent,
    trace_scope,
)

import torch_threads

torch_threads.share_cores()

TP = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT_SPAN = "00f067aa0ba902b7"


def _ctx(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled)


# ------------------------------------------------------------ traceparent


def test_parse_traceparent_valid():
    for header in (TP, f"  00-{TRACE_ID}-{PARENT_SPAN}-00  ",
                   f"01-{TRACE_ID}-{PARENT_SPAN}-01"):
        assert _ctx(parse_traceparent(header)) == _ctx(jtelemetry.parse_traceparent(header))
    assert parse_traceparent(TP) == TraceContext(TRACE_ID, PARENT_SPAN, sampled=True)
    # not-sampled flag and surrounding whitespace
    ctx = parse_traceparent(f"  00-{TRACE_ID}-{PARENT_SPAN}-00  ")
    assert ctx is not None and ctx.sampled is False
    # a future version parses leniently (the spec's forward-compat rule)
    assert parse_traceparent(f"01-{TRACE_ID}-{PARENT_SPAN}-01") is not None


@pytest.mark.parametrize("header", [
    None,
    "",
    "garbage",
    "00-short-00f067aa0ba902b7-01",
    f"00-{TRACE_ID}-{PARENT_SPAN}",          # missing flags
    f"00-{'0' * 32}-{PARENT_SPAN}-01",       # all-zero trace id
    f"00-{TRACE_ID}-{'0' * 16}-01",          # all-zero span id
    f"ff-{TRACE_ID}-{PARENT_SPAN}-01",       # forbidden version
    f"00-{TRACE_ID.upper()}Z-{PARENT_SPAN}-01",
])
def test_parse_traceparent_rejects_malformed(header):
    assert parse_traceparent(header) is None
    assert jtelemetry.parse_traceparent(header) is None


def test_format_traceparent_round_trip():
    ctx = TraceContext(telemetry.new_trace_id(), telemetry.new_span_id())
    assert parse_traceparent(format_traceparent(ctx)) == ctx
    off = TraceContext(ctx.trace_id, ctx.span_id, sampled=False)
    assert format_traceparent(off).endswith("-00")
    for c in (ctx, off):
        ref = jtelemetry.TraceContext(c.trace_id, c.span_id, sampled=c.sampled)
        assert format_traceparent(c) == jtelemetry.format_traceparent(ref)


def test_trace_scope_nests_and_restores():
    a = TraceContext(telemetry.new_trace_id(), telemetry.new_span_id())
    b = TraceContext(telemetry.new_trace_id(), telemetry.new_span_id())
    assert telemetry.current_trace_context() is None
    with trace_scope(a):
        assert telemetry.current_trace_context() == a
        with trace_scope(b):
            assert telemetry.current_trace_context() == b
        assert telemetry.current_trace_context() == a
    assert telemetry.current_trace_context() is None


# ------------------------------------------------------------ recorder


def test_recorder_parent_links_form_connected_tree():
    tr = TraceRecorder(registry=MetricsRegistry())
    with trace_scope(parse_traceparent(TP)):
        rid = tr.new_request("generate")
    tr.record_span(rid, "queue", 1.0, 1.1)
    tr.record_span(rid, "prefill", 1.1, 1.3)
    ctx = tr.trace_context(rid)
    assert ctx.trace_id == TRACE_ID
    assert tr._meta[rid]["parent_span_id"] == PARENT_SPAN
    tr.finish_request(rid)
    # jsonl carries the ids: every span parents to the request root
    records = [json.loads(x) for x in tr.export_jsonl().splitlines()]
    assert all(r["trace_id"] == TRACE_ID for r in records)
    assert all(r["parent_span_id"] == ctx.span_id for r in records)
    span_ids = {r["span_id"] for r in records}
    assert len(span_ids) == 2 and ctx.span_id not in span_ids


def test_recorder_mints_root_without_scope():
    tr = TraceRecorder(registry=MetricsRegistry())
    meta = tr._meta[tr.new_request("generate")]
    assert meta["parent_span_id"] is None
    # minted ids are valid W3C ids, in both packages' parsers
    header = f"00-{meta['trace_id']}-{meta['span_id']}-01"
    assert parse_traceparent(header) is not None
    assert jtelemetry.parse_traceparent(header) is not None


def test_span_cap_counts_drops_and_flags_truncated():
    runs = []
    for tel in (telemetry, jtelemetry):
        reg = tel.MetricsRegistry()
        tr = tel.TraceRecorder(registry=reg)
        tr.MAX_SPANS_PER_REQUEST = 3  # instance override
        rid = tr.new_request("generate")
        for i in range(5):
            tr.record_span(rid, f"s{i}", 0.0, 1.0)
        dropped = reg.counter("unionml_trace_spans_dropped_total")
        assert dropped.value == 2
        assert tr._meta[rid]["truncated"] is True
        tr.finish_request(rid)
        records = [json.loads(x) for x in tr.export_jsonl().splitlines()]
        assert len(records) == 3 and all(r["truncated"] for r in records)
        # an unknown rid is silently ignored, not counted as a drop
        tr.record_span("nope", "ghost", 0.0, 1.0)
        assert dropped.value == 2
        runs.append([r["name"] for r in records])
    assert runs[0] == runs[1]


def test_finish_listener_sees_request_once():
    tr = TraceRecorder(registry=MetricsRegistry())
    seen = []
    tr.add_listener(lambda rid, meta, spans: seen.append(rid))
    rid = tr.new_request("r")
    tr.record_span(rid, "s", 0.0, 1.0)
    tr.finish_request(rid)
    tr.finish_request(rid)  # double finish: no second event
    assert seen == [rid]
    tr.remove_listener(seen.append)  # unknown fn: no-op


# ------------------------------------------------------------ exporter


def _finish_one(tr, kind="generate"):
    rid = tr.new_request(kind)
    tr.record_span(rid, "queue", 1.0, 2.0)
    tr.finish_request(rid)
    return rid


def test_exporter_ships_spans_and_metrics_to_stub():
    """The reference's case unchanged: the resource carries its
    ``unionml_tpu.backend`` key."""
    stub = OtlpCollectorStub()
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    exp = OtlpExporter(stub.endpoint, registry=reg, tracer=tr, interval_s=60.0, seed=0)
    try:
        _finish_one(tr)
        assert exp.pending() == 1
        exp.flush()
        assert exp.pending() == 0
        traces = stub.payloads("/v1/traces")
        assert len(traces) == 1
        spans = traces[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len(spans) == 2  # synthesized root + the queue span
        res = {a["key"] for a in traces[0]["resourceSpans"][0]["resource"]["attributes"]}
        assert {"service.name", "host.name", "service.version", "unionml_tpu.backend"} <= res
        assert stub.payloads("/v1/metrics")
        assert exp._m_exported.value == 2
    finally:
        exp.close(flush=False)
        stub.close()


# ------------------------------------------------- transport round trips


class _Artifact:
    model_object = "obj"


class _Dataset:
    def get_features(self, features):
        return features


class _StubModel:
    """The minimal object ServingApp needs: rows of floats in, sums out
    (through the batcher when batch=True)."""

    name = "tracing-stub"
    artifact = _Artifact()
    dataset = _Dataset()
    _predictor = staticmethod(lambda mo, feats: [float(sum(x)) for x in feats])
    _predict_step_options: dict = {}

    def predict_from_features_workflow(self):
        return lambda model_object, features: [float(sum(x)) for x in features]


@pytest.fixture
def traced_app():
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    stub = OtlpCollectorStub()
    app = ServingApp(_StubModel(), batch=True, row_lists=True, max_wait_ms=1.0,
                     registry=reg, tracer=tr, otlp_endpoint=stub.endpoint,
                     flight=telemetry.FlightRecorder())
    host, port = app.serve(port=0, blocking=False)
    yield f"http://{host}:{port}", app, tr, stub
    app.shutdown()
    stub.close()


def test_http_traceparent_round_trip_batcher_tree(traced_app):
    """Inbound traceparent, the transport's server span, the batcher's
    request root and its queue / predict children: one connected tree
    under the caller's ids, echoed on the response and exported via OTLP
    to the collector stub."""
    url, app, tr, stub = traced_app
    r = httpx.post(f"{url}/predict", json={"features": [[1.0, 2.0]]},
                   headers={"traceparent": TP})
    assert r.status_code == 200 and r.json() == [3.0]
    echo = parse_traceparent(r.headers["traceparent"])
    assert echo is not None and echo.trace_id == TRACE_ID
    app._otlp.flush()
    spans = stub.payloads("/v1/traces")[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert all(s["traceId"] == TRACE_ID for s in spans)
    by_id = {s["spanId"]: s for s in spans}
    http_root = by_id[echo.span_id]
    assert http_root["parentSpanId"] == PARENT_SPAN
    assert http_root["name"] == "http"
    under_http = [s for s in spans if s.get("parentSpanId") == echo.span_id]
    assert {s["name"] for s in under_http} == {"batch", "http /predict"}
    batch_root = next(s for s in under_http if s["name"] == "batch")
    children = {s["name"] for s in spans if s.get("parentSpanId") == batch_root["spanId"]}
    assert children == {"queue", "predict"}


def test_http_malformed_traceparent_mints_root_never_errors(traced_app):
    url, _, _, _ = traced_app
    r = httpx.post(f"{url}/predict", json={"features": [[1.0]]},
                   headers={"traceparent": "not-a-context"})
    assert r.status_code == 200
    minted = parse_traceparent(r.headers["traceparent"])
    assert minted is not None and minted.trace_id != TRACE_ID


def test_http_every_route_echoes_traceparent(traced_app):
    url, _, _, _ = traced_app
    for path in ("/health", "/stats", "/metrics", "/debug/flight"):
        r = httpx.get(f"{url}{path}", headers={"traceparent": TP})
        echoed = parse_traceparent(r.headers.get("traceparent"))
        assert echoed is not None and echoed.trace_id == TRACE_ID, path


def test_http_echo_preserves_not_sampled_flag(traced_app):
    url, _, _, _ = traced_app
    not_sampled = f"00-{TRACE_ID}-{PARENT_SPAN}-00"
    r = httpx.post(f"{url}/predict", json={"features": [[1.0]]},
                   headers={"traceparent": not_sampled})
    assert r.headers["traceparent"].endswith("-00")
    r = httpx.get(f"{url}/health", headers={"traceparent": not_sampled})
    assert r.headers["traceparent"].endswith("-00")


def test_http_get_probe_of_predict_stays_untraced(traced_app):
    url, _, tr, _ = traced_app
    before = len(tr._done) + len(tr._live)
    r = httpx.get(f"{url}/predict", headers={"traceparent": TP})
    assert r.status_code == 404
    assert len(tr._done) + len(tr._live) == before


def test_debug_trace_endpoint_chrome_and_jsonl(traced_app):
    url, _, _, _ = traced_app
    assert "/debug/trace" in KNOWN_ROUTES and "/debug/slo" in KNOWN_ROUTES
    httpx.post(f"{url}/predict", json={"features": [[1.0]]}, headers={"traceparent": TP})
    chrome = httpx.get(f"{url}/debug/trace")
    assert chrome.status_code == 200
    assert any(e.get("name") == "predict" for e in chrome.json()["traceEvents"])
    jsonl = httpx.get(f"{url}/debug/trace?format=jsonl")
    assert jsonl.status_code == 200
    assert "ndjson" in jsonl.headers["content-type"]
    records = [json.loads(x) for x in jsonl.text.splitlines() if x]
    assert any(r["trace_id"] == TRACE_ID for r in records)
    assert httpx.get(f"{url}/debug/trace?format=nope").status_code == 422
    assert httpx.get(f"{url}/debug/slo").status_code == 422
    assert 'path="/debug/trace"' in httpx.get(f"{url}/metrics").text


def test_metrics_route_stays_untraced(traced_app):
    url, _, tr, _ = traced_app
    before = len(tr._done) + len(tr._live)
    for _ in range(3):
        httpx.get(f"{url}/metrics")
        httpx.get(f"{url}/health")
    assert len(tr._done) + len(tr._live) == before


# ------------------------------------------------------------ batcher


def test_batcher_spans_inherit_scope_and_finish():
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    batcher = MicroBatcher(lambda feats: [sum(x) for x in feats], row_lists=True,
                           max_wait_ms=1.0, registry=reg, tracer=tr,
                           flight=telemetry.FlightRecorder())
    try:
        with trace_scope(parse_traceparent(TP)):
            out = batcher.submit([[1.0, 2.0]])
        assert out == [3.0]
        assert not tr._live, "batcher leaked a live trace timeline"
        (rid, meta, spans) = tr._done[-1]
        assert meta["trace_id"] == TRACE_ID
        assert meta["parent_span_id"] == PARENT_SPAN
        assert [s["name"] for s in spans] == ["queue", "predict"]
    finally:
        batcher.close()


def test_batcher_error_path_finishes_timeline():
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)

    def boom(feats):
        raise RuntimeError("boom")

    batcher = MicroBatcher(boom, row_lists=True, max_wait_ms=1.0, registry=reg, tracer=tr,
                           flight=telemetry.FlightRecorder())
    try:
        with pytest.raises(RuntimeError, match="boom"):
            batcher.submit([[1.0]])
        assert not tr._live, "errored submit leaked a live timeline"
    finally:
        batcher.close()


# ------------------------------------------------------------ serverless


def test_serverless_gateway_traceparent_and_debug_trace():
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    handler = gateway_handler(_StubModel(), registry=reg, tracer=tr,
                              flight=telemetry.FlightRecorder())
    resp = handler({"httpMethod": "POST", "path": "/predict",
                    "headers": {"traceparent": TP},
                    "body": json.dumps({"features": [[2.0, 3.0]]})})
    assert resp["statusCode"] == 200
    echo = parse_traceparent(resp["headers"]["traceparent"])
    assert echo is not None and echo.trace_id == TRACE_ID
    assert tr._done and tr._done[-1][1]["parent_span_id"] == PARENT_SPAN
    # probes echo a minted / propagated context without recording
    done_before = len(tr._done)
    health = handler({"httpMethod": "GET", "path": "/health", "headers": {}})
    assert parse_traceparent(health["headers"]["traceparent"]) is not None
    assert len(tr._done) == done_before
    trace = handler({"httpMethod": "GET", "path": "/debug/trace",
                     "queryStringParameters": {"format": "jsonl"}, "headers": {}})
    assert trace["statusCode"] == 200
    records = [json.loads(x) for x in trace["body"].splitlines() if x]
    assert any(r["trace_id"] == TRACE_ID for r in records)
    chrome = handler({"httpMethod": "GET", "path": "/debug/trace", "headers": {}})
    assert "traceEvents" in json.loads(chrome["body"])
    bad = handler({"httpMethod": "GET", "path": "/debug/trace",
                   "queryStringParameters": {"format": "nope"}, "headers": {}})
    assert bad["statusCode"] == 422


# ------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def tiny_engine():
    from unionml_tpu.models import Llama as JLlama
    from unionml_tpu.models import LlamaConfig as JConfig

    from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
    from unionml_tpu_torch.serving.engine import DecodeEngine

    jp = JLlama(JConfig.tiny(vocab_size=61)).init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(vocab_size=61)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    reg = MetricsRegistry()
    tracer = TraceRecorder(registry=reg)
    engine = DecodeEngine(Llama(cfg), device="cpu", slots=2, max_new_tokens=6,
                          prompt_buckets=(8,), chunk_steps=2, registry=reg, tracer=tracer,
                          flight=telemetry.FlightRecorder())
    try:
        yield engine, params, tracer
    finally:
        engine.close()


def test_engine_spans_join_inbound_trace(tiny_engine):
    """generate() inside a trace_scope: every engine span shares the
    inbound trace id and the parent links form a connected tree (engine
    root, then queue / prefill / decode chunks / harvest)."""
    engine, params, tracer = tiny_engine
    with trace_scope(parse_traceparent(TP)):
        engine.generate(params, [[1, 2, 3]])
    rid, meta, spans = tracer._done[-1]
    assert meta["kind"] == "generate"
    assert meta["trace_id"] == TRACE_ID
    assert meta["parent_span_id"] == PARENT_SPAN
    names = [s["name"] for s in spans]
    assert names[0] == "queue" and names[1] == "prefill"
    assert names[-1] == "harvest"
    assert len({s["span_id"] for s in spans}) == len(spans)
    records = [json.loads(x) for x in tracer.export_jsonl().splitlines()
               if json.loads(x)["request_id"] == rid]
    assert all(r["parent_span_id"] == meta["span_id"] for r in records)


def test_engine_streams_and_concurrent_traces_stay_separate(tiny_engine):
    """Two concurrent generates under different inbound contexts keep
    their own trace ids (thread-local scope isolation)."""
    engine, params, tracer = tiny_engine
    ctxs = [TraceContext(telemetry.new_trace_id(), telemetry.new_span_id()) for _ in range(2)]
    done = []

    def worker(ctx, prompt):
        with trace_scope(ctx):
            engine.generate(params, [prompt])
        done.append(ctx)

    threads = [threading.Thread(target=worker, args=(ctxs[i], [i + 1, i + 2]))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(done) == 2
    recent = {meta["trace_id"]: meta for _, meta, _ in tracer._done[-2:]}
    assert set(recent) == {c.trace_id for c in ctxs}
    for ctx in ctxs:
        assert recent[ctx.trace_id]["parent_span_id"] == ctx.span_id


# ------------------------------------------------------------ fastapi


def test_fastapi_traceparent_parity():
    """Needs ``fastapi`` (and its test client): skipped where it is not
    installed, as the reference's case is."""
    fastapi = pytest.importorskip("fastapi")
    from fastapi.testclient import TestClient

    from unionml_tpu_torch.serving.fastapi import serving_app

    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    app = fastapi.FastAPI()
    serving_app(_StubModel(), app, registry=reg, tracer=tr, flight=telemetry.FlightRecorder())
    with TestClient(app) as client:
        r = client.post("/predict", json={"features": [[1.0, 2.0]]},
                        headers={"traceparent": TP})
        assert r.status_code == 200
        echo = parse_traceparent(r.headers["traceparent"])
        assert echo is not None and echo.trace_id == TRACE_ID
        assert tr._done[-1][1]["parent_span_id"] == PARENT_SPAN
        bad = client.post("/predict", json={"features": [[1.0]]},
                          headers={"traceparent": "zzz"})
        assert bad.status_code == 200
        assert parse_traceparent(bad.headers["traceparent"]) is not None
        h = client.get("/health", headers={"traceparent": TP})
        assert parse_traceparent(h.headers["traceparent"]).trace_id == TRACE_ID
        assert "traceEvents" in client.get("/debug/trace").json()
        assert client.get("/debug/trace?format=nope").status_code == 422
        assert client.get("/debug/slo").status_code == 422
