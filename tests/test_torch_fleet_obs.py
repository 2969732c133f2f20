"""Fleet observability plane (docs/observability.md "Fleet
observability"): cross-hop trace stitching under one trace id with the
replica's server spans parented to the router attempt that caused
them, metrics federation that degrades — never errors — when a replica
dies, merged flight rings, fleet SLO/usage views, the /debug/fleet
operator dashboard, and OTLP span events for the router/autoscaler
lifecycle.

The PyTorch port's twin of the reference's ``tests/unit/test_fleet_obs.py``: the same
cases against :mod:`unionml_tpu_torch` on the CPU. Cases with fake replicas
carry over as they are; the engine-backed ones run the port's
``DecodeEngine(device="cpu")`` on the JAX tiny Llama's weights
(``from_jax_params``, fp32 activations) and hold its tokens to the JAX
package's solo greedy generate, token for token.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.exporters import OtlpCollectorStub, OtlpExporter
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.autoscaler import (
    AutoscalerPolicy,
    FleetAutoscaler,
    ReplicaProvisioner,
)
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.serving.faults import (
    EngineUnavailable,
    FaultInjector,
    xla_oom_error,
)
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    HttpReplica,
    ReplicaHandle,
    RouterPolicy,
    make_router_app,
)
from unionml_tpu_torch.serving.usage import UsageLedger

import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.chaos


_JAX_TWIN = {}


@pytest.fixture(scope="module")
def tiny_llama():
    """The port's tiny Llama in fp32 activations and its weights, bridged
    from a JAX init (``from_jax_params``); the JAX pair is kept for
    :func:`_solo`."""
    kw = dict(vocab_size=97, dtype="float32")
    jmodule = JLlama(JConfig.tiny(**kw))
    jparams = jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    cfg = LlamaConfig.tiny(**kw)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    _JAX_TWIN[id(params)] = (jmodule, jparams)
    return Llama(cfg), params


def DecodeEngine(module, *args, **kw):
    """The port's engine on the CPU, every other knob as the reference
    test sets it."""
    kw.setdefault("device", "cpu")
    return _DecodeEngine(module, *args, **kw)


def _solo(module, params, prompt, n_new, max_len=128):
    """The JAX package's solo greedy generate, in fp32, on the JAX twin of
    the port's ``params``: the oracle each engine-backed case holds the
    port's tokens to, token for token. Pass ``max_len=engine.cache_len``
    when comparing against an engine, as the reference's oracle does."""
    jmodule, jparams = _JAX_TWIN[id(params)]
    gen = jmake_generator(jmodule, max_new_tokens=n_new, max_len=max_len)
    return np.asarray(gen(jparams, jnp.asarray([prompt], jnp.int32)))[0].tolist()


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    pytest.fail(f"timed out waiting for {what}")


class FakeReplica(ReplicaHandle):
    """Scriptable replica: serves ``tokens`` in 2-token chunks,
    failing the first ``fail_times`` dispatches."""

    def __init__(self, name, tokens=(1, 2, 3, 4), *, fail_times=0):
        self.name = name
        self.tokens = list(tokens)
        self.fail_times = fail_times
        self.dispatches = 0

    def generate_stream(self, prompt, *, max_new_tokens=None):
        self.dispatches += 1
        if self.dispatches <= self.fail_times:
            raise EngineUnavailable(f"{self.name} down", reason="test")
        for i in range(0, len(self.tokens), 2):
            yield self.tokens[i:i + 2]

    def health(self):
        return {"status": "ok", "queue_depth": 0}


def _router(replicas, tracer=None, registry=None, flight=None, **policy_kw):
    policy_kw.setdefault("health_ttl_s", 0.0)
    policy_kw.setdefault("jitter_s", 0.0)
    policy_kw.setdefault("backoff_base_s", 0.0)
    return FleetRouter(
        replicas,
        policy=RouterPolicy(**policy_kw),
        registry=registry if registry is not None
        else telemetry.MetricsRegistry(),
        flight=flight if flight is not None else telemetry.FlightRecorder(),
        tracer=tracer if tracer is not None else telemetry.TraceRecorder(),
        sleep=lambda s: None,
    )


# ------------------------------------------------ exposition merging


def test_merge_expositions_injects_replica_label():
    local = (
        "# HELP unionml_router_live_replicas r\n"
        "# TYPE unionml_router_live_replicas gauge\n"
        "unionml_router_live_replicas 2\n"
    )
    replica = (
        "# HELP unionml_engine_requests_total r\n"
        "# TYPE unionml_engine_requests_total counter\n"
        'unionml_engine_requests_total{engine="engine-0"} 5\n'
        "unionml_up 1\n"
    )
    merged = telemetry.merge_expositions(local, {"r0": replica})
    # local body untouched; replica samples labeled; bare samples too
    assert "unionml_router_live_replicas 2" in merged
    assert (
        'unionml_engine_requests_total{replica="r0",engine="engine-0"} 5'
        in merged
    )
    assert 'unionml_up{replica="r0"} 1' in merged
    # HELP/TYPE once per family even when both sources share one
    both = telemetry.merge_expositions(
        replica, {"r1": replica},
    )
    assert both.count("# TYPE unionml_engine_requests_total counter") == 1
    assert 'unionml_engine_requests_total{engine="engine-0"} 5' in both
    assert (
        'unionml_engine_requests_total{replica="r1",engine="engine-0"} 5'
        in both
    )


def test_merge_expositions_keeps_existing_replica_label():
    """A federated sub-router's body already carries replica labels —
    its (more specific) names win over a second injection: routers
    compose."""
    sub = 'unionml_router_requests_total{replica="leaf-3",outcome="ok"} 7\n'
    merged = telemetry.merge_expositions("", {"mid": sub})
    assert (
        'unionml_router_requests_total{replica="leaf-3",outcome="ok"} 7'
        in merged
    )
    assert 'replica="mid"' not in merged


def test_merge_expositions_degrades_on_garbage():
    merged = telemetry.merge_expositions(
        "ok_metric 1\n", {"r0": "%%% not an exposition at all"},
    )
    assert "ok_metric 1" in merged
    assert "%%%" not in merged


# --------------------------------------------- recorder span events


def test_record_event_exports_everywhere():
    from unionml_tpu_torch.exporters import encode_spans

    tracer = telemetry.TraceRecorder()
    rid = tracer.new_request("fleet")
    tracer.record_event(rid, "eject", replica="r0", cause="Overloaded")
    tracer.finish_request(rid)
    payload = encode_spans(tracer._all_requests(), {}, 0.0)
    spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
    (root,) = spans
    assert root["name"] == "fleet"
    (event,) = root["events"]
    assert event["name"] == "eject"
    keys = {a["key"]: a["value"] for a in event["attributes"]}
    assert keys["replica"] == {"stringValue": "r0"}
    # chrome + jsonl carry the instant too
    chrome = tracer.export_chrome()
    assert any(
        e.get("ph") == "i" and e["name"] == "eject"
        for e in chrome["traceEvents"]
    )
    assert '"event": true' in tracer.export_jsonl()


# -------------------------------------------- router decision spans


def test_router_records_decision_spans_one_trace():
    tracer = telemetry.TraceRecorder()
    router = _router(
        [FakeReplica("r0", fail_times=1), FakeReplica("r1")],
        tracer=tracer,
    )
    out = [t for c in router.generate_stream([1, 2, 3]) for t in c]
    assert out == [1, 2, 3, 4]
    (rid, meta, spans) = tracer._done[-1]
    assert meta["kind"] == "route"
    names = [s["name"] for s in spans]
    # failover story: pick → failed attempt → backoff → pick → attempt
    assert names == ["pick", "attempt", "backoff", "pick", "attempt"]
    attempts = [s for s in spans if s["name"] == "attempt"]
    assert attempts[0]["args"]["outcome"] == "error"
    assert attempts[1]["args"]["outcome"] == "ok"
    assert {a["args"]["replica"] for a in attempts} == {"r0", "r1"}
    # rid doubles as the routing rid: the flight route event matches
    assert router._flight.dump(kind="route")[-1]["rid"] == rid
    assert tracer.find_trace_id(rid) == meta["trace_id"]


def test_tracer_swap_mid_stream_finishes_in_opening_recorder():
    """A mid-stream tracer swap must close the timeline in the
    recorder it was OPENED in — re-reading the property at finish
    time would leak the request live in the old recorder forever."""
    tracer = telemetry.TraceRecorder()
    router = _router([FakeReplica("r0")], tracer=tracer)
    stream = router.generate_stream([1, 2])
    next(stream)
    router.tracer = None  # the bench's plane-off toggle, mid-stream
    for _ in stream:
        pass
    assert tracer._live == {}, "timeline leaked live across the swap"
    assert len(tracer._done) == 1
    router.tracer = tracer


def test_fleet_flight_merge_is_wall_anchored():
    """Merged flight events carry EPOCH-anchored t_ms: per-host
    monotonic readings are rebased by each body's wall_offset_ms, so
    a long-uptime replica host cannot sort after everything the
    router recorded (and an ?n= cut cannot silently drop the
    router's own events)."""
    import time as _time

    ring = telemetry.FlightRecorder()
    ring.record("submit", rid="x")
    router = _router([FlightReplica("a", ring)])
    app = make_router_app(
        router, registry=router._registry, flight=router._flight,
    )
    assert router.generate([1]) == [1, 2, 3, 4]
    merged = app.debug_flight(n=None)
    assert merged["wall_offset_ms"] == 0.0  # events are pre-anchored
    now_ms = _time.time() * 1e3
    for event in merged["events"]:
        assert abs(event["t_ms"] - now_ms) < 600_000, (
            "merged t_ms is not epoch-anchored"
        )
    # the per-process surface exports the anchor the merge rebases by
    import unionml_tpu_torch.serving.http  # noqa: F401 — route home

    local_offset = telemetry.wall_clock_offset_ms()
    raw = router._flight.dump(kind="route")[-1]["t_ms"]
    anchored = next(
        e for e in merged["events"] if e["kind"] == "route"
    )["t_ms"]
    assert abs((raw + local_offset) - anchored) < 1.0
    tracer = telemetry.TraceRecorder()
    router = _router([FakeReplica("r0")], tracer=tracer)
    router.tracer = None  # the bench's plane-off seam
    assert router.generate([1, 2]) == [1, 2, 3, 4]
    assert tracer._done == [] and tracer._live == {}
    router.tracer = tracer
    assert router.generate([1, 2]) == [1, 2, 3, 4]
    assert len(tracer._done) == 1


def test_hedge_lane_spans_and_win_lose_events():
    slow, fast = FakeReplica("slow"), FakeReplica("fast")

    def slow_stream(prompt, *, max_new_tokens=None):
        slow.dispatches += 1
        yield [1, 2]
        time.sleep(0.5)
        yield [3, 4]

    slow.generate_stream = slow_stream
    tracer = telemetry.TraceRecorder()
    router = _router(
        [slow, fast], tracer=tracer,
        hedge=True, hedge_min_s=0.05, hedge_warmup=1,
    )
    # warm the latency window so the hedge delay is the observed p95
    router._latency.add(0.05)
    out = router.generate([7, 8])
    assert out == [1, 2, 3, 4]
    (rid, meta, spans) = tracer._done[-1]
    lanes = [s for s in spans if s["name"] == "hedge-lane"]
    assert len(lanes) == 2
    outcomes = {s["args"]["replica"]: s["args"]["outcome"] for s in lanes}
    assert outcomes["fast"] == "ok"
    assert outcomes["slow"] in ("abandoned", "ok")
    events = {e["name"]: e["args"]["replica"] for e in meta["events"]}
    assert events == {"hedge_win": "fast", "hedge_lose": "slow"}


# ------------------------------------- fleet timeline span events


def test_fleet_timeline_carries_lifecycle_and_scale_events():
    tracer = telemetry.TraceRecorder()
    bad = FakeReplica("bad", fail_times=10 ** 6)
    ok = FakeReplica("ok")
    router = _router([bad, ok], tracer=tracer, eject_consecutive=1)
    assert router.generate([1]) == [1, 2, 3, 4]  # bad fails → ejected

    class NoProvisioner(ReplicaProvisioner):
        def provision(self, name):
            raise RuntimeError("no capacity")

    auto = FleetAutoscaler(
        router, NoProvisioner(),
        policy=AutoscalerPolicy(min_replicas=3, max_replicas=4),
        flight=telemetry.FlightRecorder(),
        registry=telemetry.MetricsRegistry(),
        clock=lambda: 0.0,
    )
    assert router.autoscaler is auto  # /debug/fleet link
    decision = auto.evaluate(now=0.0)
    assert decision == {
        **decision, "decision": "scale_hold", "reason": "provision_failed",
    }
    router._close_fleet_timeline()
    fleet = [
        (rid, meta, spans) for rid, meta, spans in tracer._done
        if meta.get("kind") == "fleet"
    ]
    assert len(fleet) == 1
    names = [e["name"] for e in fleet[0][1]["events"]]
    assert "eject" in names and "scale_hold" in names
    eject = next(e for e in fleet[0][1]["events"] if e["name"] == "eject")
    assert eject["args"]["replica"] == "bad"


# --------------------------------------------- stitched /debug/trace


def test_debug_trace_rid_and_trace_contract():
    tracer = telemetry.TraceRecorder()
    router = _router([FakeReplica("r0")], tracer=tracer)
    app = make_router_app(
        router, registry=router._registry, tracer=tracer,
        flight=router._flight,
    )
    with pytest.raises(ValueError):
        app.debug_trace(rid="nope-not-a-rid")
    doc, content_type = app.debug_trace(trace="f" * 32)
    assert content_type == "application/json"
    assert doc["spans"] == [] and doc["request_ids"] == []
    # plain formats still answer (and still 422 on garbage)
    body, ct = app.debug_trace("jsonl")
    assert ct == "application/x-ndjson"
    with pytest.raises(ValueError):
        app.debug_trace("nope")


def test_stitched_failover_single_trace_e2e(tiny_llama):
    """THE acceptance: a mid-stream failover request, queried back by
    the X-Request-ID the client actually received, comes back as ONE
    stitched timeline — one trace id, router pick/retry spans, both
    replicas' engine timelines parented under the attempts that
    dispatched to them — and the same trace reaches the
    OtlpCollectorStub intact."""
    httpx = pytest.importorskip("httpx")
    module, params = tiny_llama
    n_new = 24
    fis = [FaultInjector(), FaultInjector()]
    tracer = telemetry.TraceRecorder()
    registry = telemetry.MetricsRegistry()
    engines = [
        DecodeEngine(
            module, slots=2, max_new_tokens=n_new, prompt_buckets=(8,),
            chunk_steps=2, fault_injector=fis[i], tracer=tracer,
            registry=registry,
        )
        for i in range(2)
    ]
    router = FleetRouter(
        [EngineReplica(engines[i], params, name=f"r{i}") for i in range(2)],
        policy=RouterPolicy(
            health_ttl_s=0.0, jitter_s=0.0, backoff_base_s=0.0,
        ),
        registry=registry,
        flight=telemetry.FlightRecorder(),
        tracer=tracer,
    )
    stub = OtlpCollectorStub()
    exporter = OtlpExporter(
        stub.endpoint, registry=registry, tracer=tracer,
        interval_s=3600.0, export_metrics=False,
    )
    app = make_router_app(router, registry=registry, tracer=tracer)
    host, port = app.serve(port=0, blocking=False)
    prompt = [3, 1, 4, 1, 5]
    try:
        victim = 0  # idle-tie round-robin break: first pick is r0
        fis[victim].arm("engine.dispatch", nth=2, exc=xla_oom_error())
        streamed = []
        with httpx.stream(
            "POST", f"http://{host}:{port}/predict/stream",
            json={"features": prompt}, timeout=120,
        ) as resp:
            assert resp.status_code == 200
            rid = resp.headers["x-request-id"]
            for line in resp.iter_lines():
                if line.startswith("data: "):
                    import json as _json

                    event = _json.loads(line[len("data: "):])
                    if not event.get("done"):
                        streamed.extend(event["tokens"])
        assert streamed == _solo(module, params, prompt, n_new, max_len=engines[0].cache_len)
        assert fis[victim].injected("engine.dispatch") == 1

        # ---- the one-call stitched timeline ----
        def doc():
            body, _ = app.debug_trace(rid=rid)
            return body

        _wait_for(
            lambda: sum(
                1 for s in doc()["spans"]
                if s.get("root") and s["kind"] == "stream"
            ) == 2,
            what="both replicas' engine timelines in the stitch",
        )
        body = doc()
        trace_id = body["trace_id"]
        assert trace_id and len(trace_id) == 32
        by_id = {s["span_id"]: s for s in body["spans"]}
        names = [s["name"] for s in body["spans"]]
        assert "route" in names and "pick" in names
        attempts = [s for s in body["spans"] if s["name"] == "attempt"]
        assert {a["replica"] for a in attempts} == {"r0", "r1"}
        assert attempts[0]["outcome"] == "error"  # the failover is visible
        # mid-stream replay is visible on the retry attempt
        retry = next(a for a in attempts if a["outcome"] == "ok")
        assert retry["replayed"] > 0
        # the engine timelines nest under the attempt that caused them
        attempt_ids = {a["span_id"] for a in attempts}
        stream_roots = [
            s for s in body["spans"]
            if s.get("root") and s["kind"] == "stream"
        ]
        assert len(stream_roots) == 2
        for root in stream_roots:
            assert root["parent_span_id"] in attempt_ids
        # the route root parents to the transport server timeline
        route_root = next(
            s for s in body["spans"] if s.get("root") and s["kind"] == "route"
        )
        http_root = next(
            s for s in body["spans"] if s.get("root") and s["kind"] == "http"
        )
        assert route_root["parent_span_id"] == http_root["span_id"]
        assert http_root["request_id"] == rid
        # engine decode spans from the victim AND the survivor made it
        assert any(n.startswith("decode-chunk[") for n in names)

        # ---- the same trace arrives at the collector intact ----
        exporter.flush()
        otlp_spans = [
            s
            for _, payload in stub.requests
            for rs in payload.get("resourceSpans", ())
            for ss in rs.get("scopeSpans", ())
            for s in ss.get("spans", ())
            if s["traceId"] == trace_id
        ]
        otlp_ids = {s["spanId"] for s in otlp_spans}
        assert len(otlp_spans) >= len(body["spans"])
        for span in otlp_spans:
            parent = span.get("parentSpanId")
            assert parent is None or parent in otlp_ids, (
                f"dangling parent {parent} for {span['name']}"
            )
        assert {s["name"] for s in otlp_spans} >= {
            "http", "route", "pick", "attempt", "stream",
        }
        # stitched view and collector agree span-for-span
        assert {s["span_id"] for s in body["spans"]} <= otlp_ids
    finally:
        exporter.close(flush=False)
        stub.close()
        app.shutdown()
        for e in engines:
            e.close()


def test_cross_hop_parent_over_stdlib_http():
    """Satellite: over a REAL stdlib HTTP hop, the remote transport's
    server span carries the router attempt's span id as parent — the
    traceparent the attempt scope emits is what the remote timeline
    roots to — and the fetched remote spans land in the outer stitched
    document under the replica's tag."""
    remote_tracer = telemetry.TraceRecorder()
    remote_router = _router([FakeReplica("leaf")], tracer=remote_tracer)
    remote_app = make_router_app(
        remote_router, registry=remote_router._registry,
        tracer=remote_tracer, flight=remote_router._flight,
    )
    host, port = remote_app.serve(port=0, blocking=False)
    outer_tracer = telemetry.TraceRecorder()
    outer = FleetRouter(
        [HttpReplica(f"http://{host}:{port}", name="remote")],
        policy=RouterPolicy(health_ttl_s=0.0),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        tracer=outer_tracer,
    )
    outer_app = make_router_app(
        outer, registry=outer._registry, tracer=outer_tracer,
        flight=outer._flight,
    )
    try:
        assert outer.generate([5, 6]) == [1, 2, 3, 4]
        (rid, meta, spans) = outer_tracer._done[-1]
        trace_id = meta["trace_id"]
        attempt = next(s for s in spans if s["name"] == "attempt")
        # the remote's own recorder holds a server timeline in OUR trace
        _wait_for(
            lambda: remote_tracer.requests_for_trace(trace_id),
            what="remote server timeline in the shared trace",
        )
        remote_reqs = remote_tracer.requests_for_trace(trace_id)
        http_meta = next(
            m for _, m, _ in remote_reqs if m["kind"] == "http"
        )
        assert http_meta["parent_span_id"] == attempt["span_id"]
        # and the stitched fetch pulls it across the hop
        doc, _ = outer_app.debug_trace(trace=trace_id)
        remote_http = [
            s for s in doc["spans"]
            if s.get("root") and s["kind"] == "http"
        ]
        assert len(remote_http) == 1
        assert remote_http[0]["parent_span_id"] == attempt["span_id"]
        assert remote_http[0]["replica"] == "remote"
        # the remote router's own route spans rode along too
        assert any(
            s["kind"] == "route" and s.get("replica") == "remote"
            for s in doc["spans"]
        )
    finally:
        remote_app.shutdown()


# ------------------------------------------------ metrics federation


class RegistryReplica(FakeReplica):
    """In-process replica with its OWN registry (the isolated-engine
    shape, without paying for an engine)."""

    def __init__(self, name, registry):
        super().__init__(name)
        self._registry = registry

    def metrics_registry(self):
        return self._registry

    def metrics_text(self):
        return self._registry.exposition()


def test_metrics_federation_e2e_and_kill_degradation():
    # remote replica behind a real stdlib transport
    remote_router = _router([FakeReplica("leaf")])
    remote_reg = remote_router._registry
    remote_app = make_router_app(
        remote_router, registry=remote_reg, flight=remote_router._flight,
    )
    host, port = remote_app.serve(port=0, blocking=False)
    # isolated in-process registry replica
    iso_reg = telemetry.MetricsRegistry()
    iso_reg.counter("unionml_engine_requests_total", "r", ("engine",)) \
        .labels("engine-7").inc(3)
    # a replica sharing the APP registry must NOT be federated twice
    app_reg = telemetry.MetricsRegistry()
    shared = RegistryReplica("shared", app_reg)
    dead = HttpReplica("http://127.0.0.1:9", name="dead", obs_timeout_s=0.3)
    remote = HttpReplica(
        f"http://{host}:{port}", name="remote", metrics_ttl_s=0.0,
        obs_timeout_s=5.0,
    )
    router = FleetRouter(
        [RegistryReplica("iso", iso_reg), shared, dead, remote],
        policy=RouterPolicy(health_ttl_s=0.0),
        registry=app_reg,
        flight=telemetry.FlightRecorder(),
        tracer=telemetry.TraceRecorder(),
    )
    app = make_router_app(router, registry=app_reg)
    try:
        body = app.metrics_text()
        # the router's own series, unlabeled
        assert "unionml_router_live_replicas 4" in body
        # isolated in-process replica: labeled
        assert (
            'unionml_engine_requests_total{replica="iso",engine="engine-7"} 3'
            in body
        )
        # remote replica: scraped and labeled (its router gauge)
        assert (
            'unionml_router_live_replicas{replica="remote"} 1' in body
        )
        # shared-registry replica NOT duplicated under a label
        assert 'replica="shared"' not in body
        # the dead replica degraded silently (absent, never an error)
        assert 'replica="dead"' not in body
        failures = app._m_federation_failures.labels("dead", "metrics")
        assert failures.value >= 1
        # kill the remote: the scrape DEGRADES to last-seen, not error
        # (the last-seen fallback lives inside HttpReplica, so the
        # app-side failure counter only moves for replicas that have
        # NOTHING cached — like "dead" above)
        remote_app.shutdown()
        body2 = app.metrics_text()
        assert (
            'unionml_router_live_replicas{replica="remote"} 1' in body2
        )
        # federation off restores the local body
        app.federate = False
        assert 'replica="iso"' not in app.metrics_text()
    finally:
        try:
            remote_app.shutdown()
        except Exception:
            pass


# ------------------------------------------------- fleet debug views


class SloReplica(FakeReplica):
    def __init__(self, name, fast, slow, breached=()):
        super().__init__(name)
        self._fast, self._slow = fast, slow
        self._breached = list(breached)

    def slo_report(self):
        return {
            "objectives": [{
                "name": f"{self.name}-obj",
                "windows": {
                    "fast": {"burn_rate": self._fast},
                    "slow": {"burn_rate": self._slow},
                },
                "breached": bool(self._breached),
            }],
            "breached": self._breached,
        }


def test_fleet_slo_view_aggregates_replicas():
    router = _router([
        SloReplica("a", 0.5, 0.2),
        SloReplica("b", 3.5, 1.5, breached=["b-obj"]),
        FakeReplica("c"),  # no watchdog: reported as null
    ])
    app = make_router_app(
        router, registry=router._registry, flight=router._flight,
    )
    view = app.debug_slo()
    assert view["fleet"]["burn"] == {"fast": 3.5, "slow": 1.5}
    assert view["fleet"]["breached"] == ["b-obj"]
    assert view["replicas"]["c"] is None
    assert view["router"] is None
    # nothing anywhere → 422 contract
    bare = make_router_app(
        _router([FakeReplica("x")]),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
    )
    with pytest.raises(ValueError):
        bare.debug_slo()


class LedgerReplica(FakeReplica):
    def __init__(self, name, ledger):
        super().__init__(name)
        self._ledger = ledger

    def usage_ledger(self):
        return self._ledger

    def usage_report(self):
        return self._ledger.report()


def test_fleet_usage_view_merges_and_dedups_shared_ledger():
    shared = UsageLedger(registry=telemetry.MetricsRegistry())
    own = UsageLedger(registry=telemetry.MetricsRegistry())
    shared.finish_request("acme", queue_ms=10.0)
    shared.attribute({"acme": 5}, device_s=0.5)
    own.finish_request("acme", queue_ms=2.0)
    own.attribute({"acme": 7}, device_s=0.25)
    own.finish_request("zeta", queue_ms=1.0)
    own.attribute({"zeta": 1}, device_s=0.125)
    router = _router([
        LedgerReplica("a", shared),
        LedgerReplica("b", shared),   # SAME ledger: merge once
        LedgerReplica("c", own),
        FakeReplica("d"),             # meters nothing
    ])
    app = make_router_app(
        router, registry=router._registry, flight=router._flight,
    )
    view = app.debug_usage()
    assert view["fleet"]["merged_reports"] == 2
    acme = view["fleet"]["tenants"]["acme"]
    assert acme["requests"] == 2
    assert acme["decode_tokens"] == 12  # 5 (shared, once) + 7 (own)
    assert view["fleet"]["tenants"]["zeta"]["decode_tokens"] == 1
    assert view["replicas"]["b"] == {"shared_ledger": True}
    assert view["replicas"]["d"] is None
    # no ledger anywhere → 422 contract
    bare = make_router_app(
        _router([FakeReplica("x")]),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
    )
    with pytest.raises(ValueError):
        bare.debug_usage()


class FlightReplica(FakeReplica):
    def __init__(self, name, ring):
        super().__init__(name)
        self._ring = ring

    def flight_recorder(self):
        return self._ring

    def flight_events(self, n=None):
        return self._ring.dump(n=n)


def test_fleet_flight_merge_tags_and_orders():
    ring_a = telemetry.FlightRecorder()
    ring_b = telemetry.FlightRecorder()
    ring_a.record("submit", rid="x1", tenant="acme")
    ring_b.record("preempt", rid="x2")
    router = _router([
        FlightReplica("a", ring_a), FlightReplica("b", ring_b),
    ])
    app = make_router_app(
        router, registry=router._registry, flight=router._flight,
    )
    assert router.generate([1]) == [1, 2, 3, 4]
    view = app.debug_flight()
    assert view["merged_replicas"] == ["a", "b"]
    kinds = {e["kind"] for e in view["events"]}
    assert {"route", "submit", "preempt"} <= kinds
    submit = next(e for e in view["events"] if e["kind"] == "submit")
    assert submit["replica"] == "a"
    # time-ordered by t_ms
    times = [e["t_ms"] for e in view["events"]]
    assert times == sorted(times)
    # filters apply across the merged stream
    only = app.debug_flight(tenant="acme")["events"]
    assert [e["kind"] for e in only] == ["submit"]
    # a replica sharing the app ring is not duplicated
    shared = FlightReplica("s", router._flight)
    router.add_replica(shared)
    n_before = len(app.debug_flight()["events"])
    again = app.debug_flight()
    assert "s" not in again["merged_replicas"]
    assert len(again["events"]) == n_before
    # filter-then-truncate: newer non-matching events must not displace
    # an older matching one out of a filtered+bounded query (the
    # replica fetch is only thinned by ?n= when NO filter is active)
    for _ in range(5):
        ring_a.record("route", rid="noise")
    bounded = app.debug_flight(n=1, kind="submit")["events"]
    assert [e["kind"] for e in bounded] == ["submit"]


def test_debug_fleet_dashboard():
    router = _router([FakeReplica("r0"), FakeReplica("r1")])
    app = make_router_app(
        router, registry=router._registry, flight=router._flight,
    )
    report = app.debug_fleet()
    assert report["status"] == "ok"
    assert set(report["replicas"]) == {"r0", "r1"}
    assert report["replicas"]["r0"]["queue_depth"] == 0
    assert "autoscaler" not in report  # none attached yet

    class NullProvisioner(ReplicaProvisioner):
        def provision(self, name):
            raise RuntimeError("unused")

    auto = FleetAutoscaler(
        router, NullProvisioner(),
        # min_replicas == live: neither direction wants an action, so
        # the first evaluation is a genuine steady hold
        policy=AutoscalerPolicy(min_replicas=2, max_replicas=4),
        flight=telemetry.FlightRecorder(),
        registry=telemetry.MetricsRegistry(),
        clock=lambda: 100.0,
    )
    auto.evaluate(now=100.0)
    report = app.debug_fleet()
    dash = report["autoscaler"]
    assert dash["last_decision"]["decision"] == "scale_hold"
    assert dash["last_decision"]["reason"] == "steady"
    assert dash["headroom"] == 1.0
    assert dash["policy"]["max_replicas"] == 4
    # the dashboard read is side-effect-free on the decision loop
    before = auto.stats()["last_decision"]
    app.debug_fleet()
    assert auto.stats()["last_decision"] == before
    # a plain (non-router) ServingApp has no fleet → 422 contract
    from unionml_tpu_torch.serving.http import ServingApp

    with pytest.raises(ValueError):
        ServingApp.debug_fleet(object())
