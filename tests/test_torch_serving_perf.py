"""The port's serving goodput plane (:mod:`unionml_tpu_torch.serving.perf`):
the twins of ``tests/unit/test_serving_perf.py``.

The plane's arithmetic (pass classification, the KV-pressure ring, the
regression watchdog) runs the same synthetic inputs through both
packages and compares their reports. The engine cases run the port's
``DecodeEngine`` on the CPU with the reference's tiny Llama (its JAX
weights bridged by ``from_jax_params``): per-token ITL never
double-counts across a preemption-resume boundary, a chunked-prefill
generate reports ITL and the finish ledger, a plane-off engine records
nothing, and a tail exemplar's rid resolves into the stitched trace over
the stdlib transport.
"""

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.serving import perf as jperf

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.engine import DecodeEngine
from unionml_tpu_torch.serving.perf import (
    PASS_KINDS,
    PERF_REGRESSION_REASONS,
    ServingPerfPlane,
    ServingRegressionWatchdog,
)

import torch_threads

torch_threads.share_cores()


@pytest.fixture(scope="module")
def tiny_llama():
    jcfg = JConfig.tiny(vocab_size=61)
    params = JLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(vocab_size=61)
    return Llama(cfg), from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                                       device="cpu")


def _engine(module, **kw):
    return DecodeEngine(module, device="cpu", **kw)


def _gauge_value(registry, name, engine):
    for family in registry.collect():
        if family.name == name:
            for values, child in family.children():
                if values == (engine,):
                    return child.value
    return None


def _wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_taxonomies_match_the_reference():
    assert PASS_KINDS == jperf.PASS_KINDS
    assert PERF_REGRESSION_REASONS == jperf.PERF_REGRESSION_REASONS


# --------------------------------------- pass classification (pure math)


def _synthetic_passes(plane_cls, telemetry_mod):
    t = [0.0]
    registry = telemetry_mod.MetricsRegistry()
    plane = plane_cls(registry=registry, engine="e0", slots=4, chunk_steps=2,
                      clock=lambda: t[0])
    plane.note_pass(4)                      # full_batch
    plane.note_pass(2)                      # padded_slots
    plane.note_pass(3, prefill_mix=True)    # prefill_mix wins the tag
    plane.note_idle()
    plane.note_tokens(9)
    t[0] = 3.0
    return plane.report(), registry


def test_pass_classification_on_synthetic_trace():
    report, registry = _synthetic_passes(ServingPerfPlane, telemetry)
    assert report == _synthetic_passes(jperf.ServingPerfPlane, jtelemetry)[0]
    assert set(report["passes"]) == set(PASS_KINDS)
    assert report["passes"] == {
        "full_batch": 1, "padded_slots": 1, "prefill_mix": 1, "idle": 1,
    }
    # slots=4 x chunk_steps=2 = 8 slot-steps per pass
    assert report["slot_steps"] == {
        "full_batch": 8, "padded_slots": 8, "prefill_mix": 8, "idle": 8,
    }
    assert report["occupied_slot_steps"] == (4 + 2 + 3) * 2
    assert report["goodput_ratio"] == pytest.approx(18 / 32)
    assert report["occupancy_ratio"] == pytest.approx(18 / 24)
    assert report["tokens"] == 9
    assert report["tokens_per_s"] == pytest.approx(3.0)
    assert _gauge_value(registry, "unionml_serving_goodput_ratio", "e0") == \
        pytest.approx(18 / 32)
    assert _gauge_value(registry, "unionml_serving_occupancy_ratio", "e0") == \
        pytest.approx(18 / 24)


def _pressure(plane_cls, telemetry_mod):
    registry = telemetry_mod.MetricsRegistry()
    plane = plane_cls(registry=registry, engine="e1", slots=2, chunk_steps=1, ring=16,
                      clock=lambda: 0.0)
    for _ in range(100):
        plane.note_pass(2, kv_in_use=6, kv_capacity=8)
    return plane, registry


def test_kv_pressure_ring_bound_and_reset():
    plane, registry = _pressure(ServingPerfPlane, telemetry)
    ref, _ = _pressure(jperf.ServingPerfPlane, jtelemetry)
    report = plane.report()
    assert report == ref.report()
    assert report["ring_passes"] == 16      # bounded window
    assert report["total_passes"] == 100
    assert report["kv_pressure_ratio"] == pytest.approx(0.75)
    assert _gauge_value(registry, "unionml_serving_kv_pressure_ratio", "e1") == \
        pytest.approx(0.75)
    plane.reset()
    ref.reset()
    report = plane.report()
    assert report == ref.report()
    assert report["ring_passes"] == 0 and report["total_passes"] == 0
    assert report["goodput_ratio"] == 0.0
    assert _gauge_value(registry, "unionml_serving_goodput_ratio", "e1") == 0.0


# ------------------------------------------------- regression watchdog


def _events(flight):
    return [{k: v for k, v in e.items() if k not in ("t", "ts", "wall", "mono")}
            for e in flight.dump(kind="perf_regression")]


def test_watchdog_fires_and_clears_on_synthetic_values():
    runs = []
    for wd_cls, telemetry_mod in ((ServingRegressionWatchdog, telemetry),
                                  (jperf.ServingRegressionWatchdog, jtelemetry)):
        flight = telemetry_mod.FlightRecorder()
        wd = wd_cls(flight=flight, engine="e0")
        for _ in range(20):
            wd.observe_ttft(10.0)
        quiet = (wd.advisory()["regressed"], flight.dump(kind="perf_regression"))
        for _ in range(6):       # a 3x jump past the consecutive debounce enters
            wd.observe_ttft(30.0)
        advisory = wd.advisory()
        steps = 0
        for _ in range(60):      # recovery clears (below 1.2x)
            wd.observe_ttft(10.0)
            steps += 1
            if not wd.advisory()["regressed"]:
                break
        runs.append((quiet, advisory, steps, wd.advisory()["regressed"], flight))
    (quiet, advisory, steps, after, flight), ref = runs
    assert (quiet, advisory["regressed"], advisory["reasons"], steps, after) == \
        (ref[0], ref[1]["regressed"], ref[1]["reasons"], ref[2], ref[3])
    assert quiet == (False, [])
    assert advisory["regressed"] is True and advisory["reasons"] == ["ttft_regression"]
    events = flight.dump(kind="perf_regression")
    entered = [e for e in events if e["state"] == "entered"]
    assert len(entered) == 1
    assert entered[0]["reason"] == "ttft_regression" and entered[0]["engine"] == "e0"
    assert entered[0]["reason"] in PERF_REGRESSION_REASONS
    assert after is False
    cleared = [e for e in events if e["state"] == "cleared"]
    assert len(cleared) == 1 and cleared[0]["reason"] == "ttft_regression"
    assert [(e["state"], e["reason"]) for e in events] == \
        [(e["state"], e["reason"]) for e in ref[4].dump(kind="perf_regression")]


def test_watchdog_holds_inside_the_band():
    """A 1.3x drift sits inside the 1.5x enter threshold: no event."""
    for wd_cls, telemetry_mod in ((ServingRegressionWatchdog, telemetry),
                                  (jperf.ServingRegressionWatchdog, jtelemetry)):
        flight = telemetry_mod.FlightRecorder()
        wd = wd_cls(flight=flight, engine="e0")
        for _ in range(20):
            wd.observe_itl(10.0)
        for _ in range(20):
            wd.observe_itl(13.0)
        assert wd.advisory()["regressed"] is False
        assert flight.dump(kind="perf_regression") == []


def test_watchdog_goodput_collapse_reads_ratio_drop():
    """Goodput feeds inverted: a ratio collapse (down) reads as a
    regression (up) and the flight event carries the raw ratio."""
    for wd_cls, telemetry_mod in ((ServingRegressionWatchdog, telemetry),
                                  (jperf.ServingRegressionWatchdog, jtelemetry)):
        flight = telemetry_mod.FlightRecorder()
        wd = wd_cls(flight=flight, engine="e0")
        for _ in range(20):
            wd.observe_goodput(0.9)
        for _ in range(6):
            wd.observe_goodput(0.3)
        assert wd.advisory()["reasons"] == ["goodput_collapse"]
        entered = [e for e in flight.dump(kind="perf_regression")
                   if e["state"] == "entered"]
        assert entered and entered[0]["reason"] == "goodput_collapse"
        assert entered[0]["value"] == pytest.approx(0.3)


# ------------------------------------- ITL anchoring (no double-count)


def test_itl_no_double_count_across_preemption_resume(tiny_llama):
    """The evict-to-resume queueing gap never lands in the ITL histogram:
    the anchor clears at preemption and re-arms at the resume harvest."""
    module, _ = tiny_llama
    engine = _engine(module, slots=2, max_new_tokens=8, prompt_buckets=(8,),
                     registry=telemetry.MetricsRegistry(),
                     flight=telemetry.FlightRecorder(), introspect=False, perf=True)
    try:
        req = SimpleNamespace(priority="normal", _itl_anchor=0.0, _itl_sum_ms=0.0,
                              _itl_n=0, rid="r-itl")
        engine._observe_itl(req, 1.000, 1)   # arms the anchor, no gap yet
        engine._observe_itl(req, 1.010, 2)   # 10 ms gap / 2 tokens
        req._itl_anchor = 0.0                # preemption clears the anchor
        engine._observe_itl(req, 5.000, 2)   # resume: 4 s queue gap skipped
        engine._observe_itl(req, 5.020, 2)   # 20 ms gap / 2 tokens
        samples = engine._itl_summary()
        assert samples["n"] == 2
        assert samples["mean"] == pytest.approx(7.5, abs=0.01)
        assert req._itl_n == 4
        assert req._itl_sum_ms == pytest.approx(30.0, abs=0.01)
        assert engine._perf.report()["tokens"] == 1 + 2 + 2 + 2
    finally:
        engine.close()


def test_engine_itl_and_ledger_under_chunked_prefill(tiny_llama):
    """A chunked-prefill generate: stats() reports the merged ITL
    percentiles, each finish flight event carries the segment ledger,
    and the ITL token count covers every token after the first."""
    module, params = tiny_llama
    flight = telemetry.FlightRecorder()
    n_new = 12
    engine = _engine(module, slots=2, max_new_tokens=n_new, prompt_buckets=(8, 64),
                     prefill_chunk=16, chunk_steps=4, registry=telemetry.MetricsRegistry(),
                     flight=flight, perf=True)
    try:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 61, size=n).tolist() for n in (5, 33)]
        outs = engine.generate(params, prompts)
        assert all(len(out) == n_new for out in outs)
        stats = engine.stats()
        assert stats["itl_mean_ms"] > 0.0
        assert stats["itl_p99_ms"] >= stats["itl_mean_ms"]
        assert stats["itl_ms"]["n"] > 0
        passes = stats["goodput"]["passes"]
        assert passes["full_batch"] + passes["padded_slots"] + passes["prefill_mix"] > 0
        finishes = flight.dump(kind="finish")
        assert len(finishes) == 2
        for event in finishes:
            for key in ("queue_ms", "admission_ms", "prefill_ms", "ttft_ms",
                        "decode_ms", "itl_mean_ms", "itl_tokens"):
                assert key in event, key
            assert event["itl_tokens"] == n_new - 1
            assert event["itl_mean_ms"] > 0.0
    finally:
        engine.close()


def test_plane_off_records_nothing(tiny_llama):
    """perf=False: no goodput gauges, no ITL samples, no exemplars, no
    goodput block in stats(), and goodput_report() raises."""
    module, params = tiny_llama
    registry = telemetry.MetricsRegistry()
    engine = _engine(module, slots=2, max_new_tokens=6, prompt_buckets=(8,),
                     registry=registry, flight=telemetry.FlightRecorder(),
                     introspect=False, perf=False)
    try:
        engine.generate(params, [[3, 1, 4, 1, 5]])
        stats = engine.stats()
        assert "goodput" not in stats
        assert "itl_mean_ms" not in stats
        assert "unionml_serving_goodput_ratio" not in {f.name for f in registry.collect()}
        for family in registry.collect():
            if family.kind == "histogram":
                for _values, child in family.children():
                    assert child.exemplars() == []
        with pytest.raises(ValueError):
            engine.goodput_report()
    finally:
        engine.close()


# ------------------- tail exemplar -> stitched trace (stdlib transport)


def _engine_app(module, params, n_new=10):
    from unionml_tpu_torch import Dataset, Model, ModelArtifact
    from unionml_tpu_torch.serving.http import ServingApp

    registry = telemetry.MetricsRegistry()
    flight = telemetry.FlightRecorder()
    tracer = telemetry.TraceRecorder()
    engine = _engine(module, slots=2, max_new_tokens=n_new, prompt_buckets=(8,),
                     chunk_steps=4, registry=registry, flight=flight, tracer=tracer,
                     perf=True)
    dataset = Dataset(name="perf_data", targets=[])

    @dataset.reader
    def reader() -> list:
        return []

    lm = Model(name="perf_lm", init=lambda: params, dataset=dataset)

    @lm.trainer
    def trainer(p: dict, features: list) -> dict:
        return p

    @lm.predictor
    def predictor(p: dict, prompts: list) -> list:
        return engine.generate(p, prompts)

    lm.artifact = ModelArtifact(params, {}, {})
    app = ServingApp(
        lm, stats=engine.stats, health=engine.health, drain=engine.drain,
        registry=registry, flight=flight, tracer=tracer,
        goodput=engine.goodput_report,
        stream=lambda p, prompts: engine.generate_stream(p, prompts[0]),
    )
    return app, engine


def _get_json(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_tail_exemplar_resolves_in_stitched_trace(tiny_llama):
    """Stream a request over the stdlib transport, ask ``/debug/tail`` for
    the slowest recent requests, resolve a tail row's rid into
    ``/debug/trace?rid=``; ``/debug/goodput`` serves the plane's report."""
    module, params = tiny_llama
    app, engine = _engine_app(module, params)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    try:
        req = urllib.request.Request(
            f"{base}/predict/stream",
            data=json.dumps({"features": [3, 1, 4, 1, 5]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        tokens = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            for raw in resp:
                line = raw.decode()
                if line.startswith("data: "):
                    event = json.loads(line[len("data: "):])
                    if not event.get("done"):
                        tokens.extend(event["tokens"])
        assert len(tokens) == 10

        tail_path = "/debug/tail?metric=unionml_engine_decode_ms&n=3"
        _wait_for(lambda: _get_json(base, tail_path)[1]["requests"],
                  what="a decode tail exemplar")
        status, tail = _get_json(base, tail_path)
        assert status == 200
        assert tail["metric"] == "unionml_engine_decode_ms"
        row = tail["requests"][0]
        assert row["value_ms"] > 0.0
        assert row["segments"]["itl_tokens"] == 9
        assert row["segments"]["decode_ms"] >= 0.0
        assert row["trace"] == f"/debug/trace?rid={row['rid']}"

        status, doc = _get_json(base, f"/debug/trace?rid={row['rid']}")
        assert status == 200
        assert doc["trace_id"] and doc["spans"]
        assert any(s["name"].startswith("prefill") for s in doc["spans"])

        status, goodput = _get_json(base, "/debug/goodput")
        assert status == 200
        assert goodput["engine"] == engine.instance
        assert 0.0 < goodput["goodput_ratio"] <= 1.0
        assert goodput["tokens"] >= 10
        assert goodput["watchdog"]["regressed"] is False

        rows = app._serving_percentiles()
        assert rows["ttft_ms"]["n"] >= 1
        assert rows["itl_ms"]["n"] >= 1
        assert 0.0 < rows["goodput_ratio"][engine.instance] <= 1.0

        for bad in ("/debug/tail?metric=nope",
                    "/debug/tail?metric=unionml_serving_goodput_ratio"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"{base}{bad}", timeout=30)
            assert exc.value.code == 422
    finally:
        app.shutdown()
        engine.close()
