"""The port's OTLP exporter (:mod:`unionml_tpu_torch.exporters`) on the
CPU: the reference's exporter cases of ``tests/unit/test_tracing.py``
(golden span and metric encodings, shipping to the collector stub,
retries, drops after exhausted retries, the bounded queue), the encoders
byte for byte against the JAX package's on the same recorded spans and
registry with an explicitly passed resource, the torch build info in
the default resource, and ``ServingApp(otlp_endpoint=)`` pushing a
served request's spans to the stub."""

import json
import time

from unionml_tpu import exporters as jexporters
from unionml_tpu import telemetry as jtelemetry

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.exporters import (
    OtlpCollectorStub,
    OtlpExporter,
    default_resource,
    encode_metrics,
    encode_spans,
)
from unionml_tpu_torch.serving.http import ServingApp
from unionml_tpu_torch.telemetry import MetricsRegistry, TraceRecorder

import torch_threads

torch_threads.share_cores()

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT_SPAN = "00f067aa0ba902b7"


# ------------------------------------------------------------ OTLP encoding


def test_otlp_span_encoding_golden():
    meta = {
        "kind": "generate", "trace_id": TRACE_ID, "span_id": "aa" * 8,
        "parent_span_id": PARENT_SPAN, "start_s": 1.0, "end_s": 3.0,
        "truncated": True, "prompt": 7,
    }
    spans = [{
        "name": "prefill", "start_s": 1.5, "end_s": 2.0,
        "span_id": "bb" * 8, "args": {"tokens": 3},
    }]
    payload = encode_spans([("rid0", meta, spans)], {"service.name": "svc"},
                           wall_offset_s=0.0)
    scope = payload["resourceSpans"][0]
    res_attrs = {a["key"]: a["value"] for a in scope["resource"]["attributes"]}
    assert res_attrs == {"service.name": {"stringValue": "svc"}}
    root, child = scope["scopeSpans"][0]["spans"]
    assert root == {
        "traceId": TRACE_ID, "spanId": "aa" * 8, "name": "generate",
        "kind": 2, "startTimeUnixNano": "1000000000",
        "endTimeUnixNano": "3000000000",
        "attributes": [
            {"key": "unionml.request_id", "value": {"stringValue": "rid0"}},
            {"key": "unionml.truncated", "value": {"boolValue": True}},
            {"key": "unionml.prompt", "value": {"intValue": "7"}},
        ],
        "parentSpanId": PARENT_SPAN,
    }
    assert child["parentSpanId"] == "aa" * 8
    assert child["spanId"] == "bb" * 8
    assert child["startTimeUnixNano"] == "1500000000"
    assert child["attributes"] == [
        {"key": "tokens", "value": {"intValue": "3"}},
    ]


def test_otlp_metrics_encoding_golden():
    reg = MetricsRegistry()
    reg.counter("unionml_t_total", "help c", ("k",)).labels("v").inc(3)
    reg.gauge("unionml_t_gauge", "help g").set(1.5)
    h = reg.histogram("unionml_t_ms", "help h", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    payload = encode_metrics(reg, {"service.name": "svc"}, now_unix_ns=42)
    metrics = {
        m["name"]: m
        for m in payload["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
    }
    ctr = metrics["unionml_t_total"]["sum"]
    assert ctr["isMonotonic"] is True and ctr["aggregationTemporality"] == 2
    point = ctr["dataPoints"][0]
    assert point["asDouble"] == 3.0 and point["timeUnixNano"] == "42"
    assert point["attributes"] == [
        {"key": "k", "value": {"stringValue": "v"}},
    ]
    assert metrics["unionml_t_gauge"]["gauge"]["dataPoints"][0]["asDouble"] == 1.5
    hist = metrics["unionml_t_ms"]["histogram"]["dataPoints"][0]
    assert hist["explicitBounds"] == [1.0, 10.0]
    assert hist["bucketCounts"] == ["1", "1", "0"]
    assert hist["count"] == "2" and hist["sum"] == 5.5


# ------------------------------------------------------------ exporter


def _finish_one(tr, kind="generate"):
    rid = tr.new_request(kind)
    tr.record_span(rid, "queue", 1.0, 2.0)
    tr.finish_request(rid)
    return rid


def test_exporter_ships_spans_and_metrics_to_stub():
    stub = OtlpCollectorStub()
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    exp = OtlpExporter(stub.endpoint, registry=reg, tracer=tr,
                       interval_s=60.0, seed=0)
    try:
        _finish_one(tr)
        assert exp.pending() == 1
        exp.flush()
        assert exp.pending() == 0
        traces = stub.payloads("/v1/traces")
        assert len(traces) == 1
        spans = traces[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len(spans) == 2  # synthesized root + the queue span
        res = {
            a["key"]
            for a in traces[0]["resourceSpans"][0]["resource"]["attributes"]
        }
        assert {"service.name", "host.name", "service.version",
                "unionml_tpu.torch_version", "unionml_tpu.cuda_version",
                "unionml_tpu.device"} <= res
        assert stub.payloads("/v1/metrics")
        assert exp._m_exported.value == 2
    finally:
        exp.close(flush=False)
        stub.close()


def test_exporter_retries_then_succeeds():
    stub = OtlpCollectorStub()
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    exp = OtlpExporter(stub.endpoint, registry=reg, tracer=tr,
                       interval_s=60.0, max_retries=3, backoff_s=0.01,
                       export_metrics=False, seed=0)
    try:
        stub.fail(2)  # two 503s, then healthy: the POST must survive
        _finish_one(tr)
        exp.flush()
        assert stub.failures_served == 2
        assert exp._m_retries.value == 2
        assert exp._m_failures["traces"].value == 0
        assert len(stub.payloads("/v1/traces")) == 1
    finally:
        exp.close(flush=False)
        stub.close()


def test_exporter_drops_batch_after_exhausted_retries():
    stub = OtlpCollectorStub()
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    exp = OtlpExporter(stub.endpoint, registry=reg, tracer=tr,
                       interval_s=60.0, max_retries=1, backoff_s=0.01,
                       export_metrics=False, seed=0)
    try:
        stub.fail(10)
        _finish_one(tr)
        exp.flush()
        assert exp._m_failures["traces"].value == 1
        assert not stub.payloads("/v1/traces")
        # a non-retryable 4xx gives up immediately (no retry storm)
        stub.fail(10, status=400)
        retries_before = exp._m_retries.value
        _finish_one(tr)
        exp.flush()
        assert exp._m_retries.value == retries_before
        assert exp._m_failures["traces"].value == 2
    finally:
        exp.close(flush=False)
        stub.close()


def test_exporter_bounded_queue_drops_oldest():
    reg = MetricsRegistry()
    tr = TraceRecorder(registry=reg)
    # endpoint never dialed: we only exercise the queue bound
    exp = OtlpExporter("http://127.0.0.1:9", registry=reg, tracer=tr,
                       interval_s=60.0, max_queue=3, export_metrics=False,
                       max_retries=0, backoff_s=0.01, seed=0)
    try:
        for _ in range(5):
            _finish_one(tr)
        assert exp.pending() == 3
        assert exp._m_dropped.value == 2
    finally:
        exp.close(flush=False)


# ------------------------------------------------- parity with the JAX package


def _record(tel):
    """The same two requests recorded through ``tel`` (either package's
    telemetry), one with a remote parent: ``(registry, finished requests)``."""
    reg = tel.MetricsRegistry()
    tr = tel.TraceRecorder(registry=reg)
    done = []
    tr.add_listener(lambda rid, meta, spans: done.append((rid, meta, spans)))
    ctx = tel.TraceContext(trace_id=TRACE_ID, span_id=PARENT_SPAN)
    with tel.trace_scope(ctx):
        rid = tr.new_request("generate", prompt=7)
    tr.record_span(rid, "prefill", 1.0, 1.5, tokens=3)
    tr.record_span(rid, "decode", 1.5, 2.25, tokens=16, hedge=False)
    tr.finish_request(rid)
    rid = tr.new_request("batch")
    tr.record_span(rid, "queue", 2.0, 2.5)
    tr.finish_request(rid)
    reg.counter("unionml_t_total", "help c", ("k",)).labels("v").inc(3)
    reg.gauge("unionml_t_gauge", "help g").set(1.5)
    h = reg.histogram("unionml_t_ms", "help h", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    return reg, done


def test_encoders_are_byte_equal_to_the_reference():
    """``encode_spans`` / ``encode_metrics`` of the same recorded requests
    and registry, with one explicitly passed resource, serialize to the
    same bytes as the JAX package's encoders: a collector reads both
    packages' payloads alike. Span and trace ids are random per process,
    so the port's recorded requests are encoded by both encoders."""
    resource = {"service.name": "svc", "host.name": "h", "replica": 3, "ok": True}
    reg, done = _record(telemetry)
    assert len(done) == 2
    ours = encode_spans(done, resource, wall_offset_s=1000.0)
    theirs = jexporters.encode_spans(done, resource, wall_offset_s=1000.0)
    assert json.dumps(ours, sort_keys=False).encode() == \
        json.dumps(theirs, sort_keys=False).encode()
    spans = ours["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert spans[0]["traceId"] == TRACE_ID and spans[0]["parentSpanId"] == PARENT_SPAN
    # the metrics of either package's registry, filled the same way
    jreg, _ = _record(jtelemetry)
    ours = encode_metrics(reg, resource, now_unix_ns=42)
    theirs = jexporters.encode_metrics(jreg, resource, now_unix_ns=42)
    assert json.dumps(ours).encode() == json.dumps(theirs).encode()


def test_default_resource_reports_torch_not_jax():
    """The resource carries torch's version, its CUDA build and the card's
    name (``cpu`` without one), the reference's ``unionml_tpu.backend``
    key (``cuda`` or ``cpu``), and no JAX probe."""
    import torch

    res = default_resource("svc")
    assert res["service.name"] == "svc"
    assert res["unionml_tpu.torch_version"] == torch.__version__
    assert res["unionml_tpu.cuda_version"] == str(torch.version.cuda)
    assert res["unionml_tpu.device"] == (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
    assert res["unionml_tpu.backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert not any("jax" in key for key in res)


class _Artifact:
    model_object = "obj"


class _Dataset:
    def get_features(self, features):
        return features


class _StubModel:
    """The minimal object ServingApp needs: rows of floats in, sums out."""

    name = "otlp-stub"
    artifact = _Artifact()
    dataset = _Dataset()
    _predictor = staticmethod(lambda mo, feats: [float(sum(x)) for x in feats])
    _predict_step_options: dict = {}

    def predict_from_features_workflow(self):
        return lambda model_object, features: [float(sum(x)) for x in features]


def test_serving_app_otlp_endpoint_pushes_spans(monkeypatch):
    """``ServingApp(otlp_endpoint=)`` runs an exporter on the app's
    recorder (it used to raise in the port): a served /predict's server
    span reaches the collector stub under the caller's trace id, and
    ``shutdown()`` closes the exporter. The env var works the same."""
    import urllib.request

    stub = OtlpCollectorStub()
    reg = MetricsRegistry()
    tracer = TraceRecorder(registry=reg)
    app = ServingApp(_StubModel(), batch=False, registry=reg, tracer=tracer,
                     otlp_endpoint=stub.endpoint)
    host, port = app.serve(port=0, blocking=False)
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=json.dumps({"features": [[1, 2]]}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": f"00-{TRACE_ID}-{PARENT_SPAN}-01"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == [3.0]
        # the server timeline finishes after the reply is written
        spans, deadline = [], time.monotonic() + 10.0
        while not spans and time.monotonic() < deadline:
            app._otlp.flush()
            spans = [s for p in stub.payloads("/v1/traces") for rs in p["resourceSpans"]
                     for ss in rs["scopeSpans"] for s in ss["spans"]]
            time.sleep(0.02)
        assert spans and {s["traceId"] for s in spans} == {TRACE_ID}
        exporter = app._otlp
    finally:
        app.shutdown()
        stub.close()
    assert app._otlp is None and exporter._stop.is_set()
    monkeypatch.setenv("UNIONML_TPU_OTLP_ENDPOINT", "http://127.0.0.1:9")
    app = ServingApp(_StubModel(), batch=False, registry=MetricsRegistry(),
                     tracer=TraceRecorder())
    try:
        assert isinstance(app._otlp, OtlpExporter)
    finally:
        app.shutdown()
