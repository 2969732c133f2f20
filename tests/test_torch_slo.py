"""SLO watchdog tier-1 tests (docs/observability.md "Distributed
tracing & SLOs"): deterministic multi-window burn-rate math on a
synthetic clock, the ``unionml_slo_*`` series, and the acceptance
path — a fault-injected slow prefill breaches a TTFT objective, flips
``GET /health`` to ``degraded`` (503) within the fast burn window, and
clears after recovery.

The PyTorch port's twin of the reference's ``tests/unit/test_slo.py``: the same
cases against :mod:`unionml_tpu_torch` on the CPU; the engine-backed one
runs the port's ``DecodeEngine(device="cpu")`` on the JAX tiny Llama's
weights (``from_jax_params``, fp32 activations).
"""

import time

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.slo import (
    AvailabilityObjective,
    GaugeObjective,
    LatencyObjective,
    SloWatchdog,
)
from unionml_tpu_torch.telemetry import MetricsRegistry

import torch_threads

torch_threads.share_cores()


# ------------------------------------------------------------ burn math


def _ttft_watchdog(reg, **kwargs):
    return SloWatchdog(
        [LatencyObjective(
            "ttft_p90", "unionml_engine_ttft_ms", threshold_ms=100.0,
            target=0.9, fast_burn=2.0, slow_burn=1.0,
        )],
        registry=reg, fast_window_s=10.0, slow_window_s=60.0, **kwargs,
    )


def test_latency_burn_rate_window_math():
    reg = MetricsRegistry()
    h = reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    r = wd.evaluate(now=0.0)
    assert r["breached"] == [] and r["objectives"][0]["windows"]["fast"][
        "burn_rate"] == 0.0

    # 20 good observations: bad fraction 0, burn 0
    for _ in range(20):
        h.labels("engine-0").observe(50.0)
    r = wd.evaluate(now=2.0)
    assert r["breached"] == []

    # 20 bad of 40 total in the window: bad fraction 0.5, budget 0.1,
    # burn 5.0 in both windows -> breach (>= 2.0 fast, >= 1.0 slow)
    for _ in range(20):
        h.labels("engine-0").observe(500.0)
    r = wd.evaluate(now=4.0)
    obj = r["objectives"][0]
    assert obj["windows"]["fast"]["burn_rate"] == pytest.approx(5.0)
    assert obj["windows"]["fast"]["bad_events"] == 20.0
    assert r["breached"] == ["ttft_p90"]

    # recovery: the fast window slides past the burst (clean traffic
    # only after t=4) while the slow window still remembers it — the
    # AND condition clears the breach on the fast window alone
    for _ in range(100):
        h.labels("engine-0").observe(50.0)
    wd.evaluate(now=5.0)
    r = wd.evaluate(now=16.0)   # fast window (6, 16]: only clean deltas
    obj = r["objectives"][0]
    assert obj["windows"]["fast"]["burn_rate"] == 0.0
    assert obj["windows"]["slow"]["burn_rate"] > 1.0
    assert r["breached"] == []

    # transition accounting: exactly one ok->breached edge so far
    assert wd._m_breaches.labels("ttft_p90").value == 1.0


def test_latency_burn_ignores_no_traffic_windows():
    reg = MetricsRegistry()
    reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    for now in (0.0, 1.0, 2.0):
        r = wd.evaluate(now=now)
    assert r["breached"] == []
    assert r["objectives"][0]["windows"]["fast"]["events"] == 0.0


def test_availability_burn_rate():
    reg = MetricsRegistry()
    total = reg.counter("unionml_http_requests_total", "t",
                        ("transport", "path", "status"))
    errors = reg.counter("unionml_http_errors_total", "e",
                         ("transport", "path"))
    wd = SloWatchdog(
        [AvailabilityObjective(
            "availability", total="unionml_http_requests_total",
            errors="unionml_http_errors_total", target=0.99,
            fast_burn=2.0, slow_burn=1.0,
        )],
        registry=reg, fast_window_s=10.0, slow_window_s=60.0,
    )
    wd.evaluate(now=0.0)
    for _ in range(95):
        total.labels("stdlib", "/predict", "200").inc()
    for _ in range(5):
        total.labels("stdlib", "/predict", "500").inc()
        errors.labels("stdlib", "/predict").inc()
    r = wd.evaluate(now=5.0)
    obj = r["objectives"][0]
    # 5% errors / 1% budget = burn 5.0
    assert obj["windows"]["fast"]["burn_rate"] == pytest.approx(5.0)
    assert r["breached"] == ["availability"]


def test_gauge_objective_needs_sustained_violation():
    reg = MetricsRegistry()
    g = reg.gauge("unionml_program_mfu_ratio", "mfu",
                  ("component", "program"))
    wd = SloWatchdog(
        [GaugeObjective("decode_mfu", "unionml_program_mfu_ratio",
                        min_value=0.2,
                        label_filter={"program": "engine.decode"})],
        registry=reg, fast_window_s=10.0, slow_window_s=30.0,
    )
    # unresolved gauge (0.0) is skipped, not a breach
    g.labels("engine-0", "engine.decode").set(0.0)
    assert wd.evaluate(now=0.0)["breached"] == []
    # healthy level
    g.labels("engine-0", "engine.decode").set(0.5)
    assert wd.evaluate(now=2.0)["breached"] == []
    # sustained low MFU across both windows
    g.labels("engine-0", "engine.decode").set(0.05)
    for now in (12.0, 20.0, 28.0, 36.0, 44.0):
        r = wd.evaluate(now=now)
    assert r["breached"] == ["decode_mfu"]
    assert r["objectives"][0]["windows"]["fast"]["value"] == pytest.approx(0.05)
    # a different program's gauge is invisible to the filter
    g.labels("engine-0", "engine.prefill").set(0.9)
    assert wd.evaluate(now=46.0)["breached"] == ["decode_mfu"]


def test_burn_score_is_max_fast_window_burn():
    """burn_score() — the router's load-shifting scalar — is the max
    fast-window burn across objectives from the LAST evaluation, 0.0
    before any sampling (no hidden evaluate: the health-probe cadence
    is the refresh cadence)."""
    reg = MetricsRegistry()
    h = reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    assert wd.burn_score() == 0.0  # never evaluated
    for _ in range(20):
        h.labels("engine-0").observe(50.0)
    wd.evaluate(now=0.0)
    wd.evaluate(now=2.0)
    assert wd.burn_score() == 0.0  # healthy traffic
    for _ in range(20):
        h.labels("engine-0").observe(500.0)
    wd.evaluate(now=4.0)
    # the window delta vs the now=0 baseline is 20 bad / 20 total:
    # bad fraction 1.0 over the 0.1 budget -> burn 10.0
    assert wd.burn_score() == pytest.approx(10.0)


def test_watchdog_publishes_slo_series_and_rejects_duplicates():
    reg = MetricsRegistry()
    reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    wd.evaluate(now=0.0)
    text = reg.exposition()
    assert 'unionml_slo_burn_rate{objective="ttft_p90",window="fast"}' in text
    assert 'unionml_slo_breached{objective="ttft_p90"}' in text
    assert "unionml_slo_breaches_total" in text
    with pytest.raises(ValueError, match="duplicate"):
        wd.add_objective(LatencyObjective(
            "ttft_p90", "unionml_engine_ttft_ms", threshold_ms=1.0,
        ))


def test_watchdog_validates_windows_and_targets():
    with pytest.raises(ValueError, match="shorter"):
        SloWatchdog(registry=MetricsRegistry(),
                    fast_window_s=60.0, slow_window_s=10.0)
    with pytest.raises(ValueError, match="target"):
        LatencyObjective("x", "h", 1.0, target=1.0)
    with pytest.raises(ValueError, match="exactly one"):
        GaugeObjective("x", "g")


def test_history_trimming_keeps_slow_baseline():
    reg = MetricsRegistry()
    h = reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    for i in range(200):
        h.labels("engine-0").observe(50.0)
        wd.evaluate(now=float(i))
    # bounded: roughly the slow window's worth of samples is retained,
    # including one at/before the horizon as the baseline
    assert len(wd._history) <= 63
    assert wd._history[0][0] <= 199.0 - 60.0


# ------------------------------------------------ acceptance: TTFT breach


@pytest.fixture(scope="module")
def tiny_llama():
    """The port's tiny Llama in fp32 activations and its weights, bridged
    from a JAX init (``from_jax_params``)."""
    kw = dict(vocab_size=61, dtype="float32")
    jmodule = JLlama(JConfig.tiny(**kw))
    jparams = jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    cfg = LlamaConfig.tiny(**kw)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return Llama(cfg), params


def DecodeEngine(module, *args, **kw):
    """The port's engine on the CPU, every other knob as the reference
    test sets it."""
    kw.setdefault("device", "cpu")
    return _DecodeEngine(module, *args, **kw)


class _EngineModel:
    """ServingApp double whose predictor is the decode engine."""

    name = "slo-engine"
    _predict_step_options: dict = {}

    class _DS:
        def get_features(self, f):
            return f

    def __init__(self, engine, params):
        self.engine, self.params = engine, params
        self.dataset = self._DS()

        class _Art:
            model_object = params
        self.artifact = _Art()

    def predict_from_features_workflow(self):
        return lambda model_object, features: self.engine.generate(
            model_object, features
        )


def test_ttft_breach_degrades_health_and_recovers(tiny_llama):
    """The acceptance bar: a fault-injected slow prefill pushes TTFT
    over the objective, GET /health flips to degraded (503) within the
    fast burn window, and clears after recovery."""
    from unionml_tpu_torch.serving.faults import FaultInjector
    from unionml_tpu_torch.serving.http import ServingApp

    module, params = tiny_llama
    reg = MetricsRegistry()
    tracer = telemetry.TraceRecorder(registry=reg)
    fi = FaultInjector()
    engine = DecodeEngine(
        module, slots=2, max_new_tokens=4, prompt_buckets=(8,),
        chunk_steps=2, registry=reg, tracer=tracer,
        flight=telemetry.FlightRecorder(), fault_injector=fi,
    )
    watchdog = SloWatchdog(
        [LatencyObjective(
            "ttft_p90", "unionml_engine_ttft_ms", threshold_ms=100.0,
            target=0.9, min_events=1, fast_burn=1.0, slow_burn=1.0,
        )],
        registry=reg, fast_window_s=3.0, slow_window_s=120.0,
    )
    app = ServingApp(
        _EngineModel(engine, params), registry=reg, tracer=tracer,
        health=engine.health, stats=engine.stats, slo=watchdog,
        flight=telemetry.FlightRecorder(),
    )
    host, port = app.serve(port=0, blocking=False)
    url = f"http://{host}:{port}"
    try:
        engine.warmup(params)
        # healthy traffic first: fast TTFT, health ok
        for _ in range(4):
            r = httpx.post(f"{url}/predict",
                           json={"features": [[1, 2, 3]]})
            assert r.status_code == 200
        h = httpx.get(f"{url}/health")
        assert h.status_code == 200 and h.json()["status"] == "ok"
        assert h.json()["slo_breached"] == []

        # fault-injected slow prefill: every admission stalls 150 ms,
        # so TTFT lands far over the 100 ms objective
        fi.arm("engine.prefill", count=8, delay_s=0.15)
        for _ in range(4):
            assert httpx.post(
                f"{url}/predict", json={"features": [[1, 2, 3]]}
            ).status_code == 200
        fi.disarm()
        # the breach must surface within the fast window (3 s): the
        # very next probe evaluates over a window containing the burst
        h = httpx.get(f"{url}/health")
        assert h.status_code == 503, h.text
        body = h.json()
        assert body["status"] == "degraded"
        assert body["slo_breached"] == ["ttft_p90"]
        text = httpx.get(f"{url}/metrics").text
        assert 'unionml_slo_breached{objective="ttft_p90"} 1' in text

        # recovery: clean traffic, and once the fast window slides past
        # the burst the breach clears and health returns to 200/ok
        deadline = time.monotonic() + 30.0
        status = None
        while time.monotonic() < deadline:
            httpx.post(f"{url}/predict", json={"features": [[1, 2, 3]]})
            h = httpx.get(f"{url}/health")
            status = (h.status_code, h.json()["status"])
            if status == (200, "ok"):
                break
            time.sleep(0.25)
        assert status == (200, "ok"), f"breach never cleared: {status}"
        assert httpx.get(f"{url}/debug/slo").json()["breached"] == []
    finally:
        app.shutdown()
        engine.close()


def test_burn_scores_reads_both_windows():
    """burn_scores() — the autoscaler's sustained-burn signal — reads
    the fast AND slow windows from the last evaluation; a burst inside
    the fast window alone must show slow < fast (the multiwindow
    discipline that keeps a blip from buying hardware)."""
    reg = MetricsRegistry()
    h = reg.histogram("unionml_engine_ttft_ms", "ttft", ("engine",))
    wd = _ttft_watchdog(reg)
    assert wd.burn_scores() == {"fast": 0.0, "slow": 0.0}
    # long healthy history fills the slow window
    for t in range(0, 50, 2):
        for _ in range(4):
            h.labels("engine-0").observe(50.0)
        wd.evaluate(now=float(t))
    # then a fast-window burst of slow requests
    for _ in range(8):
        h.labels("engine-0").observe(500.0)
    wd.evaluate(now=52.0)
    scores = wd.burn_scores()
    assert scores["fast"] > scores["slow"] > 0.0
    assert scores["fast"] == wd.burn_score("fast") == wd.burn_score()
    assert scores["slow"] == wd.burn_score("slow")
    with pytest.raises(ValueError, match="window"):
        wd.burn_score("medium")
