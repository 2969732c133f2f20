"""Versioned rollouts of the port on the CPU: the twin of every case of the
JAX package's ``tests/unit/test_rollout.py``, then one scripted release
run through both packages.

The contract under test: the version registry publishes weights through
the port's checkpoint commit protocol and refuses torn dirs exactly as
restore does; the RolloutController choreographs canary provisioning →
shadow-diffed baking → rolling promotion through the router's actuators
and auto-rolls back on SLO burn / parity regression / dead canaries under
hysteresis; ``X-Model-Version`` is validated at every transport boundary;
``bind()`` under fleet pressure refuses to swap weights under in-flight
disagg handoffs and preemption-resume limbo; and an engine-backed fleet on
the stdlib transport has a version rolled forward and auto-rolled back
mid-flood with a canary OOM-killed mid-shadow, with zero caller-visible
failures and live tokens equal to the JAX package's solo greedy generate.

Engine-backed cases run the port's ``DecodeEngine(device="cpu")`` on the
JAX tiny Llama's weights (``from_jax_params``, fp32 activations). The
registry holds torch tensors (the port's checkpoints restore with
``weights_only=True``), where the reference's holds numpy arrays.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.serving import autoscaler as jautoscaler
from unionml_tpu.serving import faults as jfaults
from unionml_tpu.serving import prefix_cache as jprefix_cache
from unionml_tpu.serving import rollout as jrollout
from unionml_tpu.serving import router as jrouter

from unionml_tpu_torch import Dataset, Model, telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.models.train import tree_map
from unionml_tpu_torch.serving import autoscaler, faults, prefix_cache, rollout, router
from unionml_tpu_torch.serving.autoscaler import EngineReplicaProvisioner, ReplicaProvisioner
from unionml_tpu_torch.serving.disagg import DisaggRouter
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.serving.faults import EngineUnavailable, FaultInjector, xla_oom_error
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache
from unionml_tpu_torch.serving.rollout import (
    ROLLOUT_DECISIONS,
    ROLLOUT_REASONS,
    RolloutController,
    RolloutPolicy,
    VersionRegistry,
)
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    HttpReplica,
    ReplicaHandle,
    RouterPolicy,
    make_router_app,
)
from unionml_tpu_torch.serving.scheduler import model_version_scope, validate_model_version
from unionml_tpu_torch.serving.usage import UsageLedger, tenant_scope

_JAX_TWIN = {}


@pytest.fixture(scope="module")
def tiny_llama():
    kw = dict(vocab_size=97, dtype="float32")
    jmodule = JLlama(JConfig.tiny(**kw))
    jparams = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(**kw)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    _JAX_TWIN[id(params)] = (jmodule, jparams)
    return Llama(cfg), params


def DecodeEngine(module, *args, **kw):
    kw.setdefault("device", "cpu")
    return _DecodeEngine(module, *args, **kw)


@pytest.fixture
def trained_model():
    import pandas as pd
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(42)
    data = pd.DataFrame({"x": rng.normal(size=100), "x2": rng.normal(size=100),
                         "y": rng.integers(0, 2, size=100)})
    ds = Dataset(name="test_dataset", features=["x", "x2"], targets=["y"],
                 test_size=0.2, shuffle=True, random_state=99)

    @ds.reader
    def reader(sample_frac: float = 1.0, random_state: int = 123) -> pd.DataFrame:
        return data.sample(frac=sample_frac, random_state=random_state)

    model = Model(name="test_model", init=LogisticRegression, dataset=ds)

    @model.trainer
    def trainer(m: LogisticRegression, features: pd.DataFrame,
                target: pd.DataFrame) -> LogisticRegression:
        return m.fit(features, target.squeeze())

    @model.predictor
    def predictor(m: LogisticRegression, features: pd.DataFrame) -> list:
        return [float(x) for x in m.predict(features)]

    model.train(hyperparameters={"max_iter": 500}, sample_frac=1.0, random_state=123)
    return model


def _solo(params, prompt, n_new, max_len=128, jparams=None):
    """The JAX package's solo greedy generate on the JAX twin of the port's
    ``params`` (or on ``jparams``); pass ``max_len=engine.cache_len``."""
    jmodule, twin = _JAX_TWIN[id(params)]
    gen = jmake_generator(jmodule, max_new_tokens=n_new, max_len=max_len)
    tree = twin if jparams is None else jparams
    return np.asarray(gen(tree, jnp.asarray([prompt], jnp.int32)))[0].tolist()


def _copy_params(params):
    """Same values, new tensors — exercises bind()'s swap machinery
    without changing a single emitted token."""
    return tree_map(lambda x: x.clone(), params)


def _walk_refcounts(cache):
    bad = []
    stack = list(cache._root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.refcount != 0:
            bad.append((node.depth, node.refcount))
    return bad


def _bind_when_idle(engine, params, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            engine.bind(params)
            return
        except RuntimeError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.005)


def _wait_for(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    pytest.fail(f"timed out waiting for {what}")


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fakes(handle_base, unavailable, provisioner_base, cache_cls, registry_cls):
    """The scriptable replica and provisioner over one package's classes
    (the same script drives both packages in the parity case)."""

    class Fake(handle_base):
        def __init__(self, name, tokens=(1, 2, 3, 4), *, chunk=2, burn=0.0,
                     status="ok", cache=None):
            self.name = name
            self.tokens = list(tokens)
            self.chunk = chunk
            self.burn = burn
            self.status = status
            self.cache = cache
            self.dead = False
            self.dispatches = 0

        def generate_stream(self, prompt, *, max_new_tokens=None):
            if self.dead:
                raise unavailable(f"{self.name} is dead", reason="unreachable")
            self.dispatches += 1
            for i in range(0, len(self.tokens), self.chunk):
                yield self.tokens[i:i + self.chunk]

        def health(self):
            if self.dead:
                raise ConnectionError(f"{self.name} is dead")
            return {"status": self.status, "queue_depth": 0, "burn": self.burn}

        def cached_prefix_len(self, prompt):
            return 0 if self.cache is None else self.cache.peek(prompt)

        def cache_blocks(self):
            return 0 if self.cache is None else self.cache.entries

        def export_hot_blocks(self, max_blocks=64):
            return [] if self.cache is None else self.cache.export_hot(max_blocks=max_blocks)

        def import_cache_blocks(self, entries):
            return 0 if self.cache is None else self.cache.import_blocks(entries)

    class Provisioner(provisioner_base):
        def __init__(self, *, fail_times=0, with_cache=False, tokens=(9, 9)):
            self.fail_times = fail_times
            self.with_cache = with_cache
            self.tokens = tokens
            self.attempts = 0
            self.provisioned = []
            self.released = []

        def provision(self, name):
            self.attempts += 1
            if self.attempts <= self.fail_times:
                raise RuntimeError(f"provision boom #{self.attempts}")
            cache = (cache_cls(block_size=4, registry=registry_cls())
                     if self.with_cache else None)
            replica = Fake(name, tokens=self.tokens, cache=cache)
            self.provisioned.append(replica)
            return replica

        def release(self, handle):
            self.released.append(handle.name)

    return Fake, Provisioner


FakeReplica, FakeProvisioner = _fakes(
    ReplicaHandle, EngineUnavailable, ReplicaProvisioner, RadixPrefixCache,
    telemetry.MetricsRegistry)


def _fleet(replicas, *, pkg=router, tel=telemetry, **router_kw):
    router_kw.setdefault("health_ttl_s", 0.0)
    router_kw.setdefault("jitter_s", 0.0)
    router_kw.setdefault("backoff_base_s", 0.0)
    return pkg.FleetRouter(
        replicas, policy=pkg.RouterPolicy(**router_kw),
        registry=tel.MetricsRegistry(), flight=tel.FlightRecorder(), sleep=lambda s: None,
    )


def _registry(tmp_path, *versions):
    vreg = VersionRegistry(tmp_path / "versions")
    for i, v in enumerate(versions):
        vreg.publish(v, {"w": torch.full((4,), float(i))})
    return vreg


def _controller(router_, prov, vreg, clock, *, pkg=rollout, **policy_kw):
    policy_kw.setdefault("canary_replicas", 1)
    policy_kw.setdefault("warm_blocks", 0)
    policy_kw.setdefault("shadow", False)
    policy_kw.setdefault("bake_evals", 2)
    policy_kw.setdefault("sustain_evals", 2)
    return pkg.RolloutController(
        router_, prov, vreg, policy=pkg.RolloutPolicy(**policy_kw),
        params_loader=lambda v: {"which": v}, registry=router_._registry,
        flight=router_._flight, clock=clock,
    )


# ------------------------------------------------------ version registry


def test_registry_publish_resolve_load_roundtrip(tmp_path):
    vreg = VersionRegistry(tmp_path)
    try:
        assert vreg.latest() is None
        vreg.publish("rel-1", {"w": torch.arange(4, dtype=torch.float32)})
        vreg.publish("rel-2", {"w": torch.arange(4, 8, dtype=torch.float32)},
                     metadata={"notes": "retrained"})
        assert list(vreg.versions()) == ["rel-1", "rel-2"]
        assert vreg.latest() == "rel-2"
        assert vreg.resolve("rel-2")["metadata"] == {"notes": "retrained"}
        restored = vreg.load("rel-1", {"w": torch.zeros(4)})
        assert torch.equal(restored["w"], torch.arange(4, dtype=torch.float32))
        with pytest.raises(ValueError, match="already published"):
            vreg.publish("rel-1", {"w": torch.zeros(4)})
        with pytest.raises(ValueError, match="reserved"):
            vreg.publish("auto", {"w": torch.zeros(4)})
        with pytest.raises(ValueError):
            vreg.publish("Not Valid!!", {"w": torch.zeros(4)})
        with pytest.raises(ValueError, match="unknown model version"):
            vreg.resolve("ghost")
    finally:
        vreg.close()


def test_registry_refuses_torn_dirs(tmp_path):
    """A step dir without its commit marker is invisible to versions() /
    latest() and refused by load — the restore contract."""
    vreg = VersionRegistry(tmp_path)
    try:
        vreg.publish("rel-1", {"w": torch.arange(4, dtype=torch.float32)})
        torn = tmp_path / "step_9"
        torn.mkdir()
        (torn / "state.pt").write_bytes(b"partial garbage")
        assert list(vreg.versions()) == ["rel-1"]
        assert vreg.latest() == "rel-1"
        with pytest.raises(ValueError, match="unknown model version"):
            vreg.load("v9", {"w": torch.zeros(4)})
    finally:
        vreg.close()


def test_registry_derived_ids_and_corrupt_sidecar(tmp_path):
    vreg = VersionRegistry(tmp_path)
    try:
        vreg._manager.save(1, {"w": torch.arange(4, dtype=torch.float32)})
        vreg._manager.wait()
        assert list(vreg.versions()) == ["v1"]
        vreg.publish("rel-2", {"w": torch.arange(4, 8, dtype=torch.float32)})
        (tmp_path / "step_2" / "version.json").write_text("{not json")
        assert list(vreg.versions()) == ["v1", "v2"]
        restored = vreg.load("v2", {"w": torch.zeros(4)})
        assert torch.equal(restored["w"], torch.arange(4, 8, dtype=torch.float32))
    finally:
        vreg.close()


# --------------------------------------------------------------- policy


def test_rollout_policy_validation():
    with pytest.raises(ValueError, match="canary_replicas"):
        RolloutPolicy(canary_replicas=0)
    with pytest.raises(ValueError, match="canary_percent"):
        RolloutPolicy(canary_percent=101.0)
    with pytest.raises(ValueError, match="shadow_sample"):
        RolloutPolicy(shadow_sample=1.5)
    with pytest.raises(ValueError, match="shadow_queue"):
        RolloutPolicy(shadow_queue=0)
    with pytest.raises(ValueError, match="divergence_tolerance"):
        RolloutPolicy(divergence_tolerance=-1)
    with pytest.raises(ValueError, match="sustain_evals"):
        RolloutPolicy(sustain_evals=0)
    with pytest.raises(ValueError, match="bake_evals"):
        RolloutPolicy(bake_evals=0)
    with pytest.raises(ValueError, match="warm_blocks"):
        RolloutPolicy(warm_blocks=-1)
    assert ROLLOUT_DECISIONS == ("rollout_advance", "rollout_hold", "rollout_rollback")
    assert len(set(ROLLOUT_REASONS)) == len(ROLLOUT_REASONS)
    # the closed vocabularies are the reference's, word for word
    assert ROLLOUT_DECISIONS == jrollout.ROLLOUT_DECISIONS
    assert ROLLOUT_REASONS == jrollout.ROLLOUT_REASONS
    assert rollout.SHADOW_TENANT == jrollout.SHADOW_TENANT


# -------------------------------------------------------- state machine


def test_rollout_provision_bake_promote_complete(tmp_path):
    clock = _Clock()
    donor_cache = RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())
    tokens = list(range(100, 112))
    donor_cache.insert(tokens, 0, [((torch.full((1, 4, 2), float(i)),),) for i in range(3)])
    live = [FakeReplica("r0", cache=donor_cache), FakeReplica("r1")]
    router_ = _fleet(live)
    prov = FakeProvisioner(with_cache=True)
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock, warm_blocks=8)
    try:
        d = ctl.start_rollout("rel-1", percent=25.0)
        assert (d["decision"], d["reason"]) == ("rollout_advance", "operator")
        d = ctl.evaluate()
        assert d["reason"] == "canary_ready"
        assert d["warmed_blocks"] > 0
        assert ctl.dashboard()["stage"] == "baking"
        assert router_.version_split()["percent"] == 25.0
        assert "canary-rel-1-0" in router_.members()
        assert ctl.evaluate()["reason"] == "baking"
        assert ctl.evaluate()["reason"] == "bake_complete"
        promoted = {ctl.evaluate()["replica"], ctl.evaluate()["replica"]}
        assert promoted == {"r0", "r1"}
        assert live[0].version == "rel-1" and live[1].version == "rel-1"
        assert ctl.evaluate()["reason"] == "reap_canary"
        d = ctl.evaluate()
        assert (d["decision"], d["reason"]) == ("rollout_advance", "complete")
        assert router_.live_version == "rel-1"
        assert router_.version_split() is None
        assert ctl.dashboard()["stage"] == "idle"
        assert prov.released == ["canary-rel-1-0"]
        assert "canary-rel-1-0" not in router_.members()
        reasons = [e.get("reason") for e in router_._flight.dump()
                   if e["kind"] in ROLLOUT_DECISIONS]
        for want in ("operator", "canary_ready", "bake_complete",
                     "promote_replica", "reap_canary", "complete"):
            assert want in reasons, (want, reasons)
        snap = router_._registry.snapshot()
        assert any("reason=complete" in k for k in snap["unionml_rollout_decisions_total"])
    finally:
        ctl.close()


def test_rollout_slo_burn_rolls_back_with_hysteresis(tmp_path):
    clock = _Clock()
    live = [FakeReplica("r0"), FakeReplica("r1")]
    router_ = _fleet(live)
    prov = FakeProvisioner()
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock, canary_burn_threshold=1.0)
    try:
        ctl.start_rollout("rel-1")
        assert ctl.evaluate()["reason"] == "canary_ready"
        canary = prov.provisioned[0]
        canary.burn = 5.0
        d = ctl.evaluate()
        assert (d["decision"], d["reason"]) == ("rollout_hold", "hysteresis")
        canary.burn = 0.0
        assert ctl.evaluate()["reason"] == "baking"
        canary.burn = 5.0
        ctl.evaluate()
        d = ctl.evaluate()
        assert (d["decision"], d["reason"]) == ("rollout_rollback", "slo_burn")
        assert ctl.dashboard()["stage"] == "idle"
        assert router_.version_split() is None
        assert prov.released == ["canary-rel-1-0"]
        assert set(router_.members()) == {"r0", "r1"}
        assert live[0].version is None
    finally:
        ctl.close()


def test_rollout_dead_canary_degrades_shadow_then_rolls_back(tmp_path):
    clock = _Clock()
    router_ = _fleet([FakeReplica("r0")])
    prov = FakeProvisioner()
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock, shadow=True, canary_dead_evals=2)
    try:
        ctl.start_rollout("rel-1")
        assert ctl.evaluate()["reason"] == "canary_ready"
        prov.provisioned[0].dead = True
        d = ctl.evaluate()
        assert d["reason"] == "hysteresis" and d["signal"] == "canary_dead"
        d = ctl.evaluate()
        assert (d["decision"], d["reason"]) == ("rollout_hold", "shadow_degraded")
        assert ctl.dashboard()["shadow"]["degraded"] is True
        d = ctl.evaluate()
        assert (d["decision"], d["reason"]) == ("rollout_rollback", "canary_dead")
        kinds = [(e["kind"], e.get("reason")) for e in router_._flight.dump()]
        assert kinds.count(("rollout_hold", "shadow_degraded")) == 1
    finally:
        ctl.close()


def test_rollout_provision_failure_backs_off_exponentially(tmp_path):
    clock = _Clock()
    router_ = _fleet([FakeReplica("r0")])
    prov = FakeProvisioner(fail_times=2)
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock, provision_backoff_s=1.0,
                      provision_backoff_max_s=30.0)
    try:
        ctl.start_rollout("rel-1")
        assert ctl.evaluate()["reason"] == "provision_failed"
        clock.advance(0.5)
        assert ctl.evaluate()["reason"] == "provision_backoff"
        assert prov.attempts == 1
        clock.advance(1.0)
        d = ctl.evaluate()
        assert d["reason"] == "provision_failed"
        assert d["retry_in_s"] == 2.0
        clock.advance(2.5)
        assert ctl.evaluate()["reason"] == "canary_ready"
    finally:
        ctl.close()


def test_rollout_abort_mid_promote_walks_fleet_back(tmp_path):
    clock = _Clock()
    live = [FakeReplica("r0"), FakeReplica("r1")]
    router_ = _fleet(live)
    prov = FakeProvisioner()
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock)
    try:
        ctl.start_rollout("rel-1")
        ctl.evaluate()
        ctl.promote()
        d = ctl.evaluate()
        assert d["reason"] == "promote_replica" and d["replica"] == "r0"
        assert live[0].version == "rel-1"
        d = ctl.abort()
        assert (d["decision"], d["reason"]) == ("rollout_rollback", "operator")
        assert d["restored"] == ["r0"]
        assert live[0].version is None
        assert ctl.dashboard()["stage"] == "idle"
        ctl.start_rollout("rel-1")
        assert ctl.evaluate()["reason"] == "canary_ready"
    finally:
        ctl.close()


def test_rollout_shadow_diff_drives_parity_rollback(tmp_path):
    clock = _Clock()
    live = [FakeReplica("r0", tokens=(1, 2, 3, 4))]
    router_ = _fleet(live)
    prov = FakeProvisioner(tokens=(9, 9))
    vreg = _registry(tmp_path, "rel-1")
    ctl = _controller(router_, prov, vreg, clock, shadow=True)
    try:
        ctl.start_rollout("rel-1", percent=0.0)
        assert ctl.evaluate()["reason"] == "canary_ready"
        decision = None
        for _ in range(2):
            before = ctl.dashboard()["shadow"]["diverged"]
            assert router_.generate([5, 6, 7]) == [1, 2, 3, 4]
            _wait_for(lambda: ctl.dashboard()["shadow"]["diverged"] > before,
                      what="shadow divergence")
            decision = ctl.evaluate()
        assert (decision["decision"], decision["reason"]) == (
            "rollout_rollback", "parity_regression")
        diffs = [e for e in router_._flight.dump() if e["kind"] == "rollout_shadow"]
        assert diffs and diffs[0]["first_diff"] == 0 and diffs[0]["rid"]
        shadow = router_._registry.snapshot()["unionml_rollout_shadow_requests_total"]
        assert shadow.get("result=diverged", 0) >= 2
    finally:
        ctl.close()


# ------------------------------------------------ version-aware routing


def test_version_split_and_pin_routing(tmp_path):
    live = FakeReplica("r0", tokens=(1, 2))
    canary = FakeReplica("c0", tokens=(9, 9))
    canary.version = "rel-1"
    router_ = _fleet([live, canary])
    router_.set_version_split("rel-1", percent=50.0)
    outs = [router_.generate([1, 2, 3]) for _ in range(4)]
    assert outs.count([9, 9]) == 2 and outs.count([1, 2]) == 2
    router_.set_version_split("rel-1", percent=0.0, tenants={"acme": "rel-1"})
    with tenant_scope("acme"):
        assert router_.generate([1, 2, 3]) == [9, 9]
    assert router_.generate([1, 2, 3]) == [1, 2]
    with model_version_scope("rel-1"):
        assert router_.generate([1, 2, 3]) == [9, 9]
    with model_version_scope("ghost"):
        with pytest.raises(ValueError, match="unknown model version"):
            router_.generate([1, 2, 3])
    assert router_.drain_replica("c0", timeout=1.0)
    with model_version_scope("rel-1"):
        with pytest.raises(EngineUnavailable):
            router_.generate([1, 2, 3])
    router_.set_version_split("rel-1", percent=100.0)
    assert router_.generate([1, 2, 3]) == [1, 2]


# ------------------------------------------------- transport round-trip


def test_stdlib_transport_model_version_round_trip(trained_model):
    import httpx

    from unionml_tpu_torch.serving.http import ServingApp

    app = ServingApp(trained_model)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    try:
        r = httpx.post(f"{base}/predict", json={"features": [{"x": 1.0, "x2": 1.0}]},
                       headers={"X-Model-Version": "rel-1"})
        assert r.status_code == 200
        assert r.headers["x-model-version"] == "rel-1"
        h = httpx.get(f"{base}/health")
        assert h.headers["x-model-version"] == "auto"
        bad = httpx.post(f"{base}/predict", json={"features": []},
                         headers={"X-Model-Version": "Not Valid!!"})
        assert bad.status_code == 422
        assert bad.headers["x-model-version"] == "auto"
        nr = httpx.get(f"{base}/debug/rollout")
        assert nr.status_code == 422
    finally:
        app.shutdown()


def test_fastapi_transport_model_version_round_trip(trained_model):
    fastapi = pytest.importorskip("fastapi")
    from fastapi.testclient import TestClient

    app = fastapi.FastAPI()
    trained_model.serve(app)
    with TestClient(app) as client:
        r = client.post("/predict", json={"features": [[0.1, 0.2]]},
                        headers={"X-Model-Version": "rel-1"})
        assert r.status_code == 200
        assert r.headers["x-model-version"] == "rel-1"
        h = client.get("/health")
        assert h.headers["x-model-version"] == "auto"
        bad = client.get("/health", headers={"X-Model-Version": "NOPE!"})
        assert bad.status_code == 422


def test_serverless_transport_model_version_round_trip(trained_model):
    from unionml_tpu_torch.serving.serverless import gateway_handler

    handler = gateway_handler(trained_model)
    r = handler({"httpMethod": "POST", "path": "/predict",
                 "headers": {"X-Model-Version": "rel-1"},
                 "body": json.dumps({"features": [[0.1, 0.2]]})})
    assert r["statusCode"] == 200
    assert r["headers"]["X-Model-Version"] == "rel-1"
    h = handler({"httpMethod": "GET", "path": "/health"})
    assert h["headers"]["X-Model-Version"] == "auto"
    bad = handler({"httpMethod": "GET", "path": "/health",
                   "headers": {"X-Model-Version": "NOPE!"}})
    assert bad["statusCode"] == 422


def test_http_replica_forwards_model_version():
    replica = HttpReplica("http://127.0.0.1:9")
    with model_version_scope("rel-1"):
        assert replica._headers()["X-Model-Version"] == "rel-1"
    assert "X-Model-Version" not in replica._headers()
    with pytest.raises(ValueError, match="model version too long"):
        validate_model_version("x" * 65)


def test_engine_version_tag_rides_usage_vectors(tiny_llama):
    module, params = tiny_llama
    registry = telemetry.MetricsRegistry()
    ledger = UsageLedger(registry=registry)
    engine = DecodeEngine(module, slots=2, max_new_tokens=4, prompt_buckets=(16,),
                          chunk_steps=2, usage=ledger, registry=registry)
    try:
        engine.generate(params, [[1, 2, 3]], tenant="acme")
        engine.model_version = "rel-1"
        engine.generate(params, [[4, 5, 6]], tenant="acme")
        vec = ledger.report()["tenants"]["acme"]
        assert vec["requests_by_version"] == {"rel-1": 1}
    finally:
        engine.close()


# ------------------------------------------- bind() under fleet pressure


@pytest.mark.chaos
def test_bind_racing_disagg_handoff_holds_guards(tiny_llama):
    module, params = tiny_llama
    params2 = _copy_params(params)
    reg = telemetry.MetricsRegistry()
    shared = RadixPrefixCache(registry=reg)
    fi = FaultInjector()
    kw = dict(slots=2, max_new_tokens=48, prompt_buckets=(32,), chunk_steps=2,
              prefix_cache=shared, registry=reg)
    pre = DecodeEngine(module, phase="prefill", **kw)
    dec = DecodeEngine(module, phase="decode", fault_injector=fi, **kw)
    router_ = DisaggRouter(
        [EngineReplica(pre, params, name="p0"), EngineReplica(dec, params, name="d0")],
        policy=RouterPolicy(health_ttl_s=0.0, backoff_base_s=0.0, jitter_s=0.0),
        registry=reg, flight=telemetry.FlightRecorder(),
    )
    prompt = list(range(1, 21))
    solo = _solo(params, prompt, 48, max_len=dec.cache_len)
    try:
        handle = pre.prefill_export(params, prompt)
        assert handle["cached_tokens"] > 0 and shared.entries > 0
        _bind_when_idle(pre, params2)
        assert shared.entries == 0
        handle["lease"].release()
        assert _walk_refcounts(shared) == []
        fi.arm("engine.dispatch", nth=1, count=8, delay_s=0.1)
        stream = router_.generate_stream(prompt)
        got = list(next(stream))
        got.extend(next(stream))
        with pytest.raises(RuntimeError, match="while requests are in"):
            dec.bind(params2)
        got.extend(t for chunk in stream for t in chunk)
        assert got == solo
        _wait_for(lambda: _walk_refcounts(shared) == [], what="leases released")
        _bind_when_idle(dec, params2)
        assert shared.entries == 0
        out = [t for c in router_.generate_stream(prompt) for t in c]
        assert out == solo
        _wait_for(lambda: _walk_refcounts(shared) == [], what="leases released")
    finally:
        router_.close()
        pre.close()
        dec.close()


@pytest.mark.chaos
def test_bind_racing_preemption_resume_holds_guards(tiny_llama):
    module, params = tiny_llama
    params2 = _copy_params(params)
    reg = telemetry.MetricsRegistry()
    flight = telemetry.FlightRecorder()
    engine = DecodeEngine(
        module, paged=True, slots=2, max_new_tokens=48, prompt_buckets=(64,), chunk_steps=2,
        pipeline_depth=2, kv_block_size=16, kv_pool_blocks=5,
        prefix_cache=RadixPrefixCache(block_size=16, registry=reg), registry=reg, flight=flight,
    )
    try:
        rng = np.random.default_rng(0)
        low_prompt = rng.integers(1, 97, 8).tolist()
        high_prompt = rng.integers(1, 97, 8).tolist()
        low_out, errors, high_out = [], [], []

        def low_client():
            try:
                for chunk in engine.generate_stream(params, low_prompt, priority="low"):
                    low_out.extend(chunk)
            except BaseException as exc:
                errors.append(exc)

        def high_client():
            try:
                high_out.append(engine.generate(params, [high_prompt], max_new_tokens=8,
                                                priority="high")[0])
            except BaseException as exc:
                errors.append(exc)

        t_low = threading.Thread(target=low_client)
        t_low.start()
        _wait_for(lambda: low_out, what="first low token")
        t_high = threading.Thread(target=high_client)
        t_high.start()
        _wait_for(lambda: any(e["kind"] == "preempt" for e in flight.dump()),
                  what="preemption")
        with pytest.raises(RuntimeError, match="while requests are in"):
            engine.bind(params2)
        t_low.join(timeout=120)
        t_high.join(timeout=120)
        assert not t_low.is_alive() and not t_high.is_alive()
        assert not errors, f"caller-visible failure: {errors}"
        assert low_out == _solo(params, low_prompt, 48, max_len=engine.cache_len)
        assert high_out[0] == _solo(params, high_prompt, 8, max_len=engine.cache_len)
        _wait_for(lambda: engine.stats()["kv_pool"]["blocks_in_use"] == 0,
                  what="pool drained")
        _bind_when_idle(engine, params2)
        assert engine.prefix_cache.entries == 0
        assert _walk_refcounts(engine.prefix_cache) == []
        probe = rng.integers(1, 97, 8).tolist()
        assert engine.generate(params2, [probe])[0] == _solo(params, probe, 48,
                                                             max_len=engine.cache_len)
        st = engine.stats()["kv_pool"]
        assert st["blocks_in_use"] == 0 and st["blocks_reserved"] == 0
    finally:
        engine.close()


# ------------------------------------------------------ chaos acceptance


@pytest.mark.chaos
def test_rollout_chaos_fleet_under_flood(tiny_llama, tmp_path):
    """An engine-backed fleet on the stdlib transport has a bad version
    rolled forward and auto-rolled back mid-flood (shadow parity
    regression), then a clean version baked through a canary OOM-kill
    mid-shadow and promoted — zero caller-visible failures, every live
    token equal to the JAX package's solo greedy generate, the canary pool
    reaped with lease refcounts at baseline, and the release
    reconstructible from /debug/flight, /debug/rollout and a stitched
    /debug/trace?rid= timeline."""
    httpx = pytest.importorskip("httpx")
    module, params = tiny_llama
    params_good = _copy_params(params)
    params_bad = tree_map(lambda x: -x, params)
    jparams_bad = jax.tree_util.tree_map(lambda x: -x, _JAX_TWIN[id(params)][1])
    reg = telemetry.MetricsRegistry()
    flight = telemetry.FlightRecorder()
    tracer = telemetry.TraceRecorder()
    fi = FaultInjector()

    def make_engine(**extra):
        return DecodeEngine(module, slots=4, max_new_tokens=8, prompt_buckets=(16,),
                            chunk_steps=4, registry=reg,
                            prefix_cache=RadixPrefixCache(registry=reg), **extra)

    engines = [make_engine() for _ in range(2)]
    canary_engines = []

    def factory():
        e = make_engine(fault_injector=fi)
        canary_engines.append(e)
        return e, params

    router_ = FleetRouter(
        [EngineReplica(engines[i], params, name=f"r{i}") for i in range(2)],
        policy=RouterPolicy(health_ttl_s=0.0, jitter_s=0.0, backoff_base_s=0.0),
        registry=reg, flight=flight, tracer=tracer,
    )
    app = make_router_app(router_, registry=reg)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"

    vreg = VersionRegistry(tmp_path / "versions")
    vreg.publish("good", {"w": torch.zeros(2)})
    vreg.publish("bad", {"w": torch.ones(2)})
    ctl = RolloutController(
        router_, EngineReplicaProvisioner(factory), vreg,
        policy=RolloutPolicy(canary_replicas=1, canary_percent=0.0, shadow=True,
                             shadow_queue=64, bake_evals=2, sustain_evals=2,
                             warm_blocks=0, drain_timeout_s=60.0),
        params_loader=lambda v: {"good": params_good, "bad": params_bad}[v],
        registry=reg, flight=flight,
    )
    oracle_len = engines[0].cache_len
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, n).tolist() for n in (5, 8, 11, 14)]
    solo = {tuple(p): _solo(params, p, 8, max_len=oracle_len) for p in prompts}
    assert _solo(params, prompts[0], 8, max_len=oracle_len,
                 jparams=jparams_bad) != solo[tuple(prompts[0])]

    failures, results = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def flood(idx):
        j = 0
        while not stop.is_set():
            p = prompts[(idx + j) % len(prompts)]
            j += 1
            try:
                if j % 2:
                    r = httpx.post(f"{base}/predict", json={"features": [p]}, timeout=120)
                    assert r.status_code == 200, r.text
                    assert r.headers["x-model-version"] == "auto"
                    toks = r.json()[0]
                else:
                    toks = []
                    with httpx.stream("POST", f"{base}/predict/stream",
                                      json={"features": p}, timeout=120) as resp:
                        assert resp.status_code == 200
                        assert resp.headers["x-model-version"] == "auto"
                        for line in resp.iter_lines():
                            if line.startswith("data: "):
                                ev = json.loads(line[len("data: "):])
                                if not ev.get("done"):
                                    toks.extend(ev["tokens"])
                with lock:
                    results.append((tuple(p), toks))
            except BaseException as exc:
                with lock:
                    failures.append(exc)
                return
            time.sleep(0.01)

    threads = [threading.Thread(target=flood, args=(i,)) for i in range(4)]
    deadline = time.monotonic() + 240
    try:
        for e in engines:
            e.warmup(params)
        for t in threads:
            t.start()

        ctl.start_rollout("bad")
        while ctl.dashboard()["stage"] == "provisioning" and time.monotonic() < deadline:
            ctl.evaluate()
            time.sleep(0.02)
        assert ctl.dashboard()["stage"] == "baking"
        assert "canary-bad-0" in router_.members()
        decision, last = None, 0
        while time.monotonic() < deadline:
            d = ctl.dashboard()["shadow"]["diverged"]
            if d > last:
                last = d
                decision = ctl.evaluate()
                if decision["decision"] == "rollout_rollback":
                    break
            time.sleep(0.02)
        assert decision is not None and (decision["decision"], decision["reason"]) == (
            "rollout_rollback", "parity_regression")
        assert ctl.dashboard()["stage"] == "idle"
        assert set(router_.members()) == {"r0", "r1"}

        ctl.start_rollout("good")
        while ctl.dashboard()["stage"] == "provisioning" and time.monotonic() < deadline:
            ctl.evaluate()
            time.sleep(0.02)
        assert ctl.dashboard()["stage"] == "baking"
        assert canary_engines[1].cache_len == oracle_len
        fi.arm("engine.dispatch", exc=xla_oom_error())
        _wait_for(lambda: ctl.dashboard()["shadow"]["error"] >= 1, timeout=120,
                  what="OOM-killed shadow dispatch")
        matched = ctl.dashboard()["shadow"]["match"]
        _wait_for(lambda: ctl.dashboard()["shadow"]["match"] > matched, timeout=120,
                  what="shadow match after canary recovery")
        while ctl.dashboard()["stage"] != "idle" and time.monotonic() < deadline:
            ctl.evaluate()
            time.sleep(0.05)
        assert ctl.dashboard()["stage"] == "idle"
        assert router_.live_version == "good"
        for i in range(2):
            assert router_.replica_handle(f"r{i}").version == "good"
        r = httpx.post(f"{base}/predict", json={"features": [prompts[0]]},
                       headers={"X-Model-Version": "good"}, timeout=120)
        assert r.status_code == 200
        assert r.headers["x-model-version"] == "good"
        assert r.json()[0] == solo[tuple(prompts[0])]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)

    try:
        assert not failures, f"caller-visible failures: {failures[:3]}"
        assert len(results) > 20
        for p, toks in results:
            assert toks == solo[p], (p, toks, solo[p])
        assert set(router_.members()) == {"r0", "r1"}
        assert len(canary_engines) == 2
        for e in engines:
            _wait_for(lambda e=e: _walk_refcounts(e.prefix_cache) == [],
                      what="live leases released")
        snap = reg.snapshot()
        assert snap["unionml_rollout_canary_replicas"] == {"": 0.0}
        decisions = snap["unionml_rollout_decisions_total"]
        for key in ("reason=parity_regression", "reason=complete",
                    "reason=canary_ready", "reason=promote_replica"):
            assert any(key in k for k in decisions), (key, decisions)
        shadow_events = [e for e in flight.dump() if e["kind"] == "rollout_shadow"]
        assert shadow_events, "diverged shadows must land in the ring"
        fl = httpx.get(f"{base}/debug/flight", timeout=30).text
        assert "rollout_rollback" in fl and "rollout_advance" in fl
        dash = httpx.get(f"{base}/debug/rollout", timeout=30).json()
        assert dash["stage"] == "idle"
        assert dash["live_version"] == "good"
        assert dash["shadow"]["diverged"] >= 2
        assert any(h["reason"] == "parity_regression" for h in dash["history"])
        rid = shadow_events[0]["rid"]
        tr = httpx.get(f"{base}/debug/trace?rid={rid}", timeout=30).text
        assert "shadow" in tr, "the shadow span must stitch under the rid"
    finally:
        ctl.close()
        app.shutdown()
        vreg.close()
        for e in engines + canary_engines:
            e.close()


# ------------------------------------------- one release, both packages


def _scripted_release(pkgs, tmp_path):
    """One release scripted on a fake clock over fake replicas: a burn
    blip, a sustained burn rollback, a provision failure with backoff, a
    clean warm-joined bake and promotion, a shadow-diffed parity rollback
    and a dead canary. Returns the ``(decision, reason)`` of every call and
    the registry's versions."""
    tel, rt, asc, fl, pc, ro, arr = pkgs
    Fake, Prov = _fakes(rt.ReplicaHandle, fl.EngineUnavailable, asc.ReplicaProvisioner,
                        pc.RadixPrefixCache, tel.MetricsRegistry)
    clock = _Clock()
    donor = pc.RadixPrefixCache(block_size=4, registry=tel.MetricsRegistry())
    donor.insert(list(range(100, 112)), 0, [((arr(np.full((1, 4, 2), i, np.float32)),),)
                                             for i in range(3)])
    live = [Fake("r0", cache=donor), Fake("r1")]
    rtr = _fleet(live, pkg=rt, tel=tel)
    vreg = ro.VersionRegistry(tmp_path / "versions")
    vreg._manager.save(1, {"w": arr(np.arange(4, dtype=np.float32))})
    vreg._manager.wait()
    for i, v in enumerate(("rel-1", "rel-2", "rel-3")):
        vreg.publish(v, {"w": arr(np.full(4, float(i), np.float32))},
                     metadata={"i": i, "notes": v.upper()})
    seq = []

    def rec(d):
        seq.append((d["decision"], d["reason"]))
        return d

    # 1. a burn blip holds, a sustained burn rolls back
    prov = Prov(fail_times=1)
    ctl = _controller(rtr, prov, vreg, clock, pkg=ro, warm_blocks=8)
    try:
        rec(ctl.start_rollout("rel-1", percent=25.0))
        rec(ctl.evaluate())                      # provision_failed
        clock.advance(0.5)
        rec(ctl.evaluate())                      # provision_backoff
        clock.advance(1.0)
        rec(ctl.evaluate())                      # canary_ready (warm)
        prov.provisioned[-1].burn = 5.0
        rec(ctl.evaluate())
        prov.provisioned[-1].burn = 0.0
        rec(ctl.evaluate())
        prov.provisioned[-1].burn = 5.0
        rec(ctl.evaluate())
        rec(ctl.evaluate())                      # slo_burn rollback
        # 2. a clean bake promotes the fleet
        rec(ctl.start_rollout("rel-2"))
        for _ in range(7):
            rec(ctl.evaluate())
        rec(ctl.evaluate())                      # idle
    finally:
        ctl.close()
    # 3. the canary disagrees: shadows diverge, parity rollback
    prov = Prov(tokens=(9, 9))
    ctl = _controller(rtr, prov, vreg, clock, pkg=ro, shadow=True)
    try:
        rec(ctl.start_rollout("rel-3", percent=0.0))
        rec(ctl.evaluate())
        for _ in range(2):
            before = ctl.dashboard()["shadow"]["diverged"]
            rtr.generate([5, 6, 7])
            _wait_for(lambda: ctl.dashboard()["shadow"]["diverged"] > before,
                      what="shadow divergence")
            rec(ctl.evaluate())
        # 4. a dead canary degrades the shadow, then rolls back
        rec(ctl.start_rollout("rel-3"))
        rec(ctl.evaluate())
        prov.provisioned[-1].dead = True
        for _ in range(3):
            rec(ctl.evaluate())
    finally:
        ctl.close()
    versions = vreg.versions()
    vreg.close()
    return seq, versions, [r.version for r in live], rtr.live_version


def test_scripted_release_decides_as_the_jax_package(tmp_path):
    """The same script through both packages: the same sequence of
    ``(decision, reason)`` pairs, the same derived version ids and
    metadata, the same fleet versions at the end."""
    port = _scripted_release(
        (telemetry, router, autoscaler, faults, prefix_cache, rollout, torch.from_numpy),
        tmp_path / "port")
    ref = _scripted_release(
        (jtelemetry, jrouter, jautoscaler, jfaults, jprefix_cache, jrollout, np.asarray),
        tmp_path / "jax")
    assert port == ref
    seq = port[0]
    assert ("rollout_rollback", "slo_burn") in seq
    assert ("rollout_rollback", "parity_regression") in seq
    assert ("rollout_rollback", "canary_dead") in seq
    assert ("rollout_advance", "complete") in seq
    assert list(port[1]) == ["v1", "rel-1", "rel-2", "rel-3"]
