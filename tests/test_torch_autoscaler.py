"""Autoscaler choreography tests (docs/robustness.md "Autoscaling &
self-healing"): the closed loop must scale OUT on sustained multiwindow
SLO burn or headroom exhaustion (never on a blip), warm-join new
capacity from the fleet's hottest prefix blocks before it takes
traffic, scale IN only through the hysteresis band and never while
failure recovery is in flight, survive a broken provisioner with
backoff instead of wedging, repair the fleet under repeated kills, and
— THE acceptance — replace a replica killed mid-flood with zero
caller-visible failures and token parity, then shrink back to baseline
when the load drops.

The PyTorch port's twin of the reference's ``tests/unit/test_autoscaler.py``: the same
cases against :mod:`unionml_tpu_torch` on the CPU. Cases with fake replicas
carry over as they are; the engine-backed ones run the port's
``DecodeEngine(device="cpu")`` on the JAX tiny Llama's weights
(``from_jax_params``, fp32 activations) and hold its tokens to the JAX
package's solo greedy generate, token for token.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.serving.autoscaler import (
    AutoscalerPolicy,
    EngineReplicaProvisioner,
    FleetAutoscaler,
    HttpReplicaProvisioner,
    ReplicaProvisioner,
)
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.serving.faults import (
    EngineUnavailable,
    FaultInjector,
    xla_oom_error,
)
from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    ReplicaHandle,
    RouterPolicy,
)
from unionml_tpu_torch.serving.usage import UsageLedger

import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.chaos


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeSlo:
    """Settable stand-in for SloWatchdog's burn read."""

    def __init__(self):
        self.fast = 0.0
        self.slow = 0.0
        self.evals = 0

    def evaluate(self, now=None):
        self.evals += 1
        return {}

    def burn_scores(self):
        return {"fast": self.fast, "slow": self.slow}


class FakeReplica(ReplicaHandle):
    """Scriptable replica with an optional REAL prefix cache (warm-join
    export/import rides the genuine block machinery)."""

    def __init__(self, name, tokens=(1, 2, 3, 4), *, chunk=2,
                 queue_depth=0, burn=0.0, status="ok", cache=None,
                 breaker_open=False):
        self.name = name
        self.tokens = list(tokens)
        self.chunk = chunk
        self.queue_depth = queue_depth
        self.burn = burn
        self.status = status
        self.cache = cache
        self.breaker_open = breaker_open
        self.dead = False
        self.dispatches = 0
        self.drained = False

    def generate_stream(self, prompt, *, max_new_tokens=None):
        if self.dead:
            raise EngineUnavailable(
                f"{self.name} is dead", reason="unreachable",
            )
        self.dispatches += 1
        for i in range(0, len(self.tokens), self.chunk):
            yield self.tokens[i:i + self.chunk]

    def health(self):
        if self.dead:
            raise ConnectionError(f"{self.name} is dead")
        return {
            "status": self.status,
            "queue_depth": self.queue_depth,
            "burn": self.burn,
            "breaker_open": self.breaker_open,
        }

    def cached_prefix_len(self, prompt):
        return 0 if self.cache is None else self.cache.peek(prompt)

    def cache_blocks(self):
        return 0 if self.cache is None else self.cache.entries

    def export_hot_blocks(self, max_blocks=64):
        if self.cache is None:
            return []
        return self.cache.export_hot(max_blocks=max_blocks)

    def import_cache_blocks(self, entries):
        return 0 if self.cache is None else self.cache.import_blocks(entries)

    def drain(self, timeout=None):
        self.drained = True
        return True


class FakeProvisioner(ReplicaProvisioner):
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
        cache = (
            RadixPrefixCache(
                block_size=4, registry=telemetry.MetricsRegistry(),
            )
            if self.with_cache else None
        )
        replica = FakeReplica(name, tokens=self.tokens, cache=cache)
        self.provisioned.append(replica)
        return replica

    def release(self, handle):
        self.released.append(handle.name)


def _fleet(replicas, clock, **router_kw):
    router_kw.setdefault("health_ttl_s", 0.0)
    router_kw.setdefault("jitter_s", 0.0)
    router_kw.setdefault("backoff_base_s", 0.0)
    return FleetRouter(
        replicas,
        policy=RouterPolicy(**router_kw),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        clock=clock,
        sleep=lambda s: None,
    )


def _autoscaler(router, provisioner, clock, *, slo=None, usage=None,
                flight=None, **policy_kw):
    policy_kw.setdefault("cooldown_out_s", 10.0)
    policy_kw.setdefault("cooldown_in_s", 10.0)
    return FleetAutoscaler(
        router, provisioner,
        policy=AutoscalerPolicy(**policy_kw),
        slo=slo, usage=usage,
        registry=telemetry.MetricsRegistry(),
        flight=flight if flight is not None else router._flight,
        clock=clock,
    )


def _seed_cache(cache, n_blocks, base=100):
    tokens = list(range(base, base + 4 * n_blocks))
    rows = [
        ((np.full((1, 4, 2), i, np.float32),),) for i in range(n_blocks)
    ]
    cache.insert(tokens, 0, rows)
    return tokens


# ---------------------------------------------------------------- policy


def test_policy_validation():
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalerPolicy(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        AutoscalerPolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="sustain_evals"):
        AutoscalerPolicy(sustain_evals=0)
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscalerPolicy(headroom_out=0.5, headroom_in=0.4)
    with pytest.raises(ValueError, match="warm_blocks"):
        AutoscalerPolicy(warm_blocks=-1)
    with pytest.raises(ValueError, match="reap_unhealthy_evals"):
        AutoscalerPolicy(reap_unhealthy_evals=0)


# ------------------------------------------------------------- scale out


def test_scale_out_on_sustained_burn_not_blip():
    """Both windows must burn past threshold for sustain_evals
    consecutive evaluations — a one-evaluation blip buys nothing, the
    sustained burn buys a replica."""
    clock = _Clock()
    slo = FakeSlo()
    router = _fleet([FakeReplica("r0")], clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, slo=slo, sustain_evals=2, max_replicas=3,
    )

    # a blip: hot once, then clear — no scale
    slo.fast, slo.slow = 20.0, 5.0
    assert auto.evaluate(now=clock())["decision"] == "scale_hold"
    slo.fast, slo.slow = 0.0, 0.0
    clock.advance(1)
    assert auto.evaluate(now=clock())["decision"] == "scale_hold"
    assert prov.attempts == 0

    # sustained: hot for two consecutive evaluations — scale out
    slo.fast, slo.slow = 20.0, 5.0
    clock.advance(1)
    auto.evaluate(now=clock())
    clock.advance(1)
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_out"
    assert decision["reason"] == "slo_burn"
    assert "auto-0" in router.health()["replicas"]
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "scale_out" in kinds and "join" in kinds

    # fast window alone must NOT trigger (multiwindow discipline)
    slo.fast, slo.slow = 20.0, 0.0
    for _ in range(4):
        clock.advance(20)
        assert auto.evaluate(now=clock())["decision"] == "scale_hold"
    assert prov.attempts == 1


def test_scale_out_on_headroom_exhaustion_and_max_cap():
    """Recent-window headroom under headroom_out scales out; the
    max_replicas cap holds further growth (decision explainable as
    at_max)."""
    clock = _Clock()
    ledger = UsageLedger(registry=telemetry.MetricsRegistry())
    router = _fleet([FakeReplica("r0")], clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, usage=ledger,
        headroom_out=0.3, headroom_in=0.6, max_replicas=2,
        cooldown_out_s=1.0,
    )
    auto.evaluate(now=clock())  # baseline sample (captures totals)

    ledger.attribute({"t": 95}, device_s=1.0, slot_steps=100.0)
    clock.advance(5)
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_out"
    assert decision["reason"] == "headroom"
    assert decision["headroom"] == pytest.approx(0.05)

    # still exhausted, but the fleet is at max_replicas now
    ledger.attribute({"t": 95}, device_s=1.0, slot_steps=100.0)
    clock.advance(5)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "at_max",
    )
    holds = router._flight.dump(kind="scale_hold")
    assert holds and holds[-1]["reason"] == "at_max"


def test_scale_out_cooldown_hysteresis_on_synthetic_clock():
    """Per-direction cooldown: a second trigger inside cooldown_out_s
    holds (explainably), after the window it scales — deterministic on
    the synthetic clock."""
    clock = _Clock()
    slo = FakeSlo()
    slo.fast, slo.slow = 20.0, 5.0
    router = _fleet([FakeReplica("r0")], clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, slo=slo, sustain_evals=1,
        cooldown_out_s=30.0, max_replicas=4,
    )
    assert auto.evaluate(now=clock())["decision"] == "scale_out"
    clock.advance(5)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "cooldown_out",
    )
    clock.advance(26)  # past the cooldown
    assert auto.evaluate(now=clock())["decision"] == "scale_out"
    assert prov.attempts == 2


# ------------------------------------------------------------ warm joins


def test_warm_join_imports_hot_blocks_from_warmest_donor():
    """The joiner is fleet-warmed BEFORE it becomes routable: hottest
    blocks from the donor with the most resident cache blocks."""
    clock = _Clock()
    cold = RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())
    warm = RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())
    _seed_cache(cold, 1)
    tokens = _seed_cache(warm, 3)
    router = _fleet(
        [FakeReplica("r0", cache=cold), FakeReplica("r1", cache=warm)],
        clock,
    )
    prov = FakeProvisioner(with_cache=True)
    auto = _autoscaler(
        router, prov, clock, min_replicas=3, max_replicas=4, warm_blocks=8,
    )
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_out", "below_min",
    )
    assert decision["donor"] == "r1"           # warmest, not r0
    assert decision["warmed_blocks"] == 3
    joiner = prov.provisioned[0]
    assert joiner.cache.entries == 3
    assert joiner.cache.peek(tokens) == 12     # warm prefixes ready
    event = router._flight.dump(kind="scale_out")[-1]
    assert event["donor"] == "r1" and event["warmed_blocks"] == 3
    assert int(auto._m_warmed.value) == 3


def test_warm_join_with_zero_exportable_blocks():
    """An empty fleet cache must not break the join: the replica joins
    cold, explainably (warmed_blocks=0, no donor)."""
    clock = _Clock()
    router = _fleet(
        [FakeReplica("r0", cache=RadixPrefixCache(
            block_size=4, registry=telemetry.MetricsRegistry(),
        ))],
        clock,
    )
    prov = FakeProvisioner(with_cache=True)
    auto = _autoscaler(router, prov, clock, min_replicas=2, max_replicas=3)
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_out"
    assert decision["donor"] is None and decision["warmed_blocks"] == 0
    assert prov.provisioned[0].cache.entries == 0
    assert "auto-0" in router.health()["replicas"]


# ------------------------------------------------------------- scale in


def test_scale_in_drains_coldest_lowest_load_with_hysteresis():
    """Scale-in picks the coldest-cache, lowest-load victim, and only
    fires when the PROJECTED post-removal headroom clears the band —
    mid-band utilization holds even though no trigger is hot."""
    clock = _Clock()
    ledger = UsageLedger(registry=telemetry.MetricsRegistry())
    warm = RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())
    _seed_cache(warm, 3)
    replicas = [
        FakeReplica("r0", cache=warm, queue_depth=1),
        FakeReplica("r1", queue_depth=3),   # cold cache, deeper queue
        FakeReplica("r2", queue_depth=0),   # cold cache, idle -> victim
    ]
    router = _fleet(replicas, clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, usage=ledger,
        headroom_out=0.1, headroom_in=0.5, cooldown_in_s=5.0,
    )
    auto.evaluate(now=clock())  # baseline totals

    # mid-band: headroom 0.4 -> projected 1 - 0.6*3/2 = 0.1 < 0.5: HOLD
    ledger.attribute({"t": 60}, slot_steps=100.0)
    clock.advance(6)
    assert auto.evaluate(now=clock())["decision"] == "scale_hold"
    assert len(router.health()["replicas"]) == 3

    # light traffic: headroom 0.9 -> projected 0.85 > 0.5: scale in
    ledger.attribute({"t": 10}, slot_steps=100.0)
    clock.advance(6)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_in", "surplus",
    )
    assert decision["replica"] == "r2"     # coldest cache, lowest load
    assert replicas[2].drained
    assert "r2" not in router.health()["replicas"]
    event = router._flight.dump(kind="scale_in")[-1]
    assert event["replica"] == "r2"

    # cooldown_in: an immediately-following idle eval holds
    for r in replicas:
        r.queue_depth = 0   # idle consolidation also needs empty queues
    clock.advance(1)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "cooldown_in",
    )
    # past the cooldown, the idle fleet keeps consolidating
    clock.advance(6)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_in", "idle",
    )
    # and never below min_replicas: one replica left -> steady forever
    clock.advance(6)
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_hold"
    assert len(router.health()["replicas"]) == 1


def test_scale_in_holds_during_ejection_breaker_and_drain():
    """Scale decisions must not fight failure recovery: an ejected
    replica, an open breaker, or an in-flight drain each hold
    scale-in — explainably."""
    clock = _Clock()
    replicas = [FakeReplica("r0"), FakeReplica("r1"), FakeReplica("r2")]
    router = _fleet(replicas, clock)
    prov = FakeProvisioner()
    auto = _autoscaler(router, prov, clock, cooldown_in_s=0.0)

    # racing an ejection: r0 mid-recovery
    router._replicas["r0"].state = "ejected"
    router._replicas["r0"].rejoin_at = clock() + 100.0
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "recovery_in_flight",
    )
    assert len(router.health()["replicas"]) == 3
    router._replicas["r0"].state = "live"

    # an open circuit breaker anywhere holds
    replicas[1].breaker_open = True
    clock.advance(1)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "breaker_open",
    )
    replicas[1].breaker_open = False

    # a drain in flight holds
    router.drain_replica("r2")
    clock.advance(1)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "drain_in_flight",
    )
    router.rejoin_replica("r2")

    # recovery over: the idle fleet may consolidate again
    clock.advance(1)
    assert auto.evaluate(now=clock())["decision"] == "scale_in"


def test_scale_in_respects_router_min_live_floor():
    """The router's own min_live floor outranks the autoscaler's
    appetite: live-1 < min_live holds even when min_replicas allows."""
    clock = _Clock()
    router = _fleet(
        [FakeReplica("r0"), FakeReplica("r1")], clock, min_live=2,
    )
    auto = _autoscaler(
        router, FakeProvisioner(), clock,
        min_replicas=1, cooldown_in_s=0.0,
    )
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "min_live",
    )


# ----------------------------------------------- provisioner resilience


def test_provisioner_failure_retries_with_backoff_not_wedge():
    """A broken provisioner schedules exponential-backoff retries; the
    loop keeps evaluating and succeeds once the provisioner heals."""
    clock = _Clock()
    slo = FakeSlo()
    slo.fast, slo.slow = 20.0, 5.0
    router = _fleet([FakeReplica("r0")], clock)
    prov = FakeProvisioner(fail_times=2)
    auto = _autoscaler(
        router, prov, clock, slo=slo, sustain_evals=1,
        provision_backoff_s=1.0, provision_backoff_max_s=8.0,
        cooldown_out_s=0.0, max_replicas=3,
    )
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "provision_failed",
    )
    # inside the backoff: held WITHOUT another provision attempt
    clock.advance(0.5)
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "provision_backoff",
    )
    assert prov.attempts == 1
    # past the backoff: retry fires (and fails; backoff doubles to 2 s)
    clock.advance(0.6)
    decision = auto.evaluate(now=clock())
    assert decision["reason"] == "provision_failed"
    assert prov.attempts == 2
    clock.advance(1.0)   # inside the DOUBLED backoff
    assert auto.evaluate(now=clock())["reason"] == "provision_backoff"
    clock.advance(1.1)   # past it: healed provisioner succeeds
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_out"
    assert prov.attempts == 3
    assert int(auto._m_provision_failures.value) == 2
    fails = [
        e for e in router._flight.dump(kind="scale_hold")
        if e["reason"] == "provision_failed"
    ]
    assert len(fails) == 2 and "retry_in_s" in fails[0]


def test_min_replicas_floor_under_repeated_kills():
    """Self-healing: every kill is reaped and replaced back to
    min_replicas, cooldown exempt (repair must not wait out a scale
    cooldown)."""
    clock = _Clock()
    replicas = [FakeReplica("r0"), FakeReplica("r1")]
    router = _fleet(replicas, clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, min_replicas=2, max_replicas=2,
        cooldown_out_s=1000.0, reap_unhealthy_evals=2,
    )
    victims = [replicas[0], replicas[1]]
    for round_, victim in enumerate(victims):
        victim.dead = True
        # eval 1: corpse seen (at_max until reaped -> hold)
        clock.advance(1)
        decision = auto.evaluate(now=clock())
        assert decision["decision"] == "scale_hold"
        # eval 2: corpse reaped AND replacement provisioned
        clock.advance(1)
        decision = auto.evaluate(now=clock())
        assert (decision["decision"], decision["reason"]) == (
            "scale_out", "below_min",
        ), f"round {round_}: {decision}"
        members = router.health()["replicas"]
        assert victim.name not in members
        assert len(members) == 2
        assert router.health()["live_replicas"] == 2
    assert int(auto._m_reaped.value) == 2
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "scale_reap" in kinds
    # kill a provisioned replica too: reaping releases it
    prov.provisioned[0].dead = True
    clock.advance(1)
    auto.evaluate(now=clock())
    clock.advance(1)
    auto.evaluate(now=clock())
    assert prov.provisioned[0].name in prov.released


def test_http_provisioner_spawn_and_teardown():
    spawned, torn = [], []

    def spawn(name):
        spawned.append(name)
        return f"http://127.0.0.1:1/{name}"

    prov = HttpReplicaProvisioner(
        spawn, teardown=lambda h: torn.append(h.name), timeout_s=3.0,
    )
    handle = prov.provision("auto-7")
    assert spawned == ["auto-7"]
    assert handle.name == "auto-7"
    assert handle.timeout_s == 3.0
    prov.release(handle)
    assert torn == ["auto-7"]


def test_stats_and_decision_counters_reconstruct_decisions():
    """Every evaluation lands in exactly one decisions_total child —
    the counter stream alone reconstructs out/in/hold history."""
    clock = _Clock()
    slo = FakeSlo()
    router = _fleet([FakeReplica("r0"), FakeReplica("r1")], clock)
    auto = _autoscaler(
        router, FakeProvisioner(), clock, slo=slo,
        sustain_evals=1, cooldown_in_s=0.0, max_replicas=3,
    )
    n_evals = 0
    for fast, slow in [(0, 0), (20, 5), (0, 0), (0, 0)]:
        slo.fast, slo.slow = float(fast), float(slow)
        clock.advance(20)
        auto.evaluate(now=clock())
        n_evals += 1
    total = sum(
        child.value for _, child in auto._m_decisions.children()
    )
    assert total == n_evals
    by_decision = {}
    for values, child in auto._m_decisions.children():
        by_decision[values[0]] = by_decision.get(values[0], 0) + child.value
    assert by_decision.get("scale_out") == 1    # the burn eval
    assert by_decision.get("scale_in", 0) >= 1  # idle consolidation
    stats = auto.stats()
    assert stats["last_decision"]["decision"] in (
        "scale_out", "scale_in", "scale_hold",
    )


# -------------------------------------------- engine-backed (THE test)


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


class KillableEngineReplica(EngineReplica):
    """An EngineReplica that can 'die' like a crashed process: armed
    fault kills the in-flight batch (retryable, PR 3 recovery), the
    kill flag makes every later dispatch/health read unreachable."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.killed = False

    def kill(self):
        self.killed = True

    def generate_stream(self, prompt, *, max_new_tokens=None):
        if self.killed:
            raise EngineUnavailable(
                f"{self.name} process died", reason="unreachable",
            )
        return super().generate_stream(
            prompt, max_new_tokens=max_new_tokens
        )

    def generate(self, prompt, *, max_new_tokens=None):
        if self.killed:
            raise EngineUnavailable(
                f"{self.name} process died", reason="unreachable",
            )
        return super().generate(prompt, max_new_tokens=max_new_tokens)

    def health(self):
        if self.killed:
            raise ConnectionError(f"{self.name} process died")
        return super().health()


def test_autoscaler_replaces_killed_replica_under_flood(tiny_llama):
    """THE acceptance: a sustained flood drives headroom under the
    scale-out floor, a replica is killed mid-flood, and the autoscaler
    (a) scales out, (b) reaps and replaces the corpse (warm-joined
    from a donor's hot prefix blocks), with ZERO caller-visible
    failures and exact token parity throughout; after the flood the
    fleet scales back in to baseline within the cooldown."""
    module, params = tiny_llama
    n_new = 16
    slots, bucket, chunk_steps = 2, 32, 4
    ledger = UsageLedger(registry=telemetry.MetricsRegistry())
    fis = [FaultInjector(), FaultInjector()]

    def make_engine(fi=None):
        return DecodeEngine(
            module, slots=slots, max_new_tokens=n_new,
            prompt_buckets=(bucket,), chunk_steps=chunk_steps,
            prefix_cache=True, usage=ledger, max_queue_depth=64,
            **({"fault_injector": fi} if fi is not None else {}),
        )

    engines = [make_engine(fis[0]), make_engine(fis[1])]
    replicas = [
        KillableEngineReplica(engines[i], params, name=f"r{i}")
        for i in range(2)
    ]
    flight = telemetry.FlightRecorder()
    router = FleetRouter(
        replicas,
        policy=RouterPolicy(
            health_ttl_s=0.0, jitter_s=0.0, backoff_base_s=0.0,
            max_attempts=4, retry_budget_burst=50.0,
            retry_budget_ratio=1.0, eject_consecutive=1,
            eject_cooldown_s=1000.0,  # a corpse stays ejected; reap ends it
        ),
        registry=telemetry.MetricsRegistry(),
        flight=flight,
    )
    aux_engines = []

    def factory():
        engine = make_engine()
        aux_engines.append(engine)
        return engine, params

    auto = FleetAutoscaler(
        router,
        EngineReplicaProvisioner(factory),
        policy=AutoscalerPolicy(
            min_replicas=2, max_replicas=3,
            headroom_out=0.7, headroom_in=0.95,
            cooldown_out_s=0.0, cooldown_in_s=0.0,
            warm_blocks=32, reap_unhealthy_evals=2,
            drain_timeout_s=30.0,
        ),
        usage=ledger,
        registry=telemetry.MetricsRegistry(),
        flight=flight,
    )
    rng = np.random.default_rng(0)
    distinct = [
        rng.integers(1, 97, bucket // 2).tolist() for _ in range(6)
    ]
    try:
        for e in engines:
            e.warmup(params)
        solo = {
            tuple(p): _solo(
                module, params, p, n_new, max_len=engines[0].cache_len,
            ) for p in distinct
        }
        results, failures, lock = [], [], threading.Lock()
        clients, n_req = 6, 60
        started = threading.Event()

        def client(idx):
            for j in range(n_req // clients):
                p = distinct[(idx + j) % len(distinct)]
                if idx == 0 and j == 1:
                    started.set()
                try:
                    out = router.generate(p)
                    with lock:
                        results.append((tuple(p), out))
                except BaseException as exc:  # EVERY failure counts
                    with lock:
                        failures.append(f"{type(exc).__name__}: {exc}")

        threads = [
            threading.Thread(target=client, args=(i,))
            for i in range(clients)
        ]
        for t in threads:
            t.start()
        started.wait(timeout=60)

        # the control loop, driven explicitly (the production ticker
        # is just this on a timer)
        killed = [False]
        deadline = time.monotonic() + 240.0
        while any(t.is_alive() for t in threads):
            if time.monotonic() > deadline:
                pytest.fail("flood did not complete")
            auto.evaluate()
            members = router.health()["replicas"]
            if not killed[0] and "auto-0" in members:
                # scale-out happened: NOW kill r0 mid-flood (fault
                # poisons the in-flight batch retryably, then the
                # replica reads as a dead process)
                fis[0].arm("engine.dispatch", exc=xla_oom_error())
                replicas[0].kill()
                killed[0] = True
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=60)

        assert killed[0], "the mid-flood kill never armed (no scale-out?)"
        assert not failures, (
            f"{len(failures)} caller-visible failures (want 0): "
            f"{sorted(set(failures))[:3]}"
        )
        bad = sum(1 for key, out in results if out != solo[key])
        assert bad == 0, f"{bad}/{len(results)} lost token parity"
        assert len(results) == n_req

        # the corpse was reaped and replaced: r0 gone, fleet healthy
        def settle(max_evals=20):
            for _ in range(max_evals):
                auto.evaluate()
                members = router.health()["replicas"]
                if "r0" not in members and all(
                    m["state"] == "live" for m in members.values()
                ):
                    return members
                time.sleep(0.05)
            return router.health()["replicas"]

        members = settle()
        assert "r0" not in members, f"corpse not reaped: {members}"
        assert int(auto._m_reaped.value) >= 1

        # scale-out was fleet-WARMED: the joiner imported hot blocks
        outs = flight.dump(kind="scale_out")
        assert outs, "no scale_out flight event"
        assert any(e.get("warmed_blocks", 0) > 0 for e in outs), outs
        assert int(auto._m_warmed.value) > 0
        # and the joiner served with parity (asserted above) from a
        # cache that actually holds fleet prefixes
        warmed = [e for e in outs if e.get("warmed_blocks", 0) > 0]
        assert warmed[0]["donor"] in ("r0", "r1", "auto-0")

        # flood over: no traffic -> the fleet consolidates to baseline
        for _ in range(30):
            auto.evaluate()
            if len(router.health()["replicas"]) <= 2:
                break
            time.sleep(0.02)
        members = router.health()["replicas"]
        assert len(members) == 2, f"did not scale back in: {members}"
        kinds = [e["kind"] for e in flight.dump()]
        assert "scale_in" in kinds

        # every decision is reconstructible: one counter per evaluation
        total = sum(
            child.value for _, child in auto._m_decisions.children()
        )
        assert total > 0
    finally:
        auto.close()
        for e in engines + aux_engines:
            e.close()


def test_scale_in_holds_while_work_is_queued():
    """Queued work anywhere contradicts idle/surplus regardless of
    ledger wiring: a fleet run with usage=None must not shrink itself
    under load just because no capacity signal exists."""
    clock = _Clock()
    replicas = [
        FakeReplica("r0", queue_depth=3), FakeReplica("r1", queue_depth=2),
    ]
    router = _fleet(replicas, clock)
    auto = _autoscaler(router, FakeProvisioner(), clock, cooldown_in_s=0.0)
    for _ in range(4):
        clock.advance(10)
        decision = auto.evaluate(now=clock())
        assert decision["decision"] == "scale_hold", decision
    assert len(router.health()["replicas"]) == 2
    # queues drain -> the idle fleet may consolidate
    for r in replicas:
        r.queue_depth = 0
    clock.advance(10)
    assert auto.evaluate(now=clock())["decision"] == "scale_in"


def test_join_name_collision_releases_handle_and_retries_fresh():
    """add_replica raising (e.g. an operator-registered replica
    already owns the name) must release the provisioned handle and
    surface as a decision — and the next attempt picks a fresh name."""
    clock = _Clock()
    router = _fleet([FakeReplica("r0"), FakeReplica("auto-0")], clock)
    prov = FakeProvisioner()
    auto = _autoscaler(
        router, prov, clock, min_replicas=3, max_replicas=4,
        cooldown_out_s=0.0, provision_backoff_s=0.0,
    )
    decision = auto.evaluate(now=clock())
    assert (decision["decision"], decision["reason"]) == (
        "scale_hold", "provision_failed",
    )
    assert prov.released == ["auto-0"]          # no leaked handle
    clock.advance(1)
    decision = auto.evaluate(now=clock())
    assert decision["decision"] == "scale_out"
    assert decision["replica"] == "auto-1"      # fresh name, no loop
    assert "auto-1" in router.health()["replicas"]
