"""Fleet-router chaos tests (docs/robustness.md "Fleet robustness"):
the cluster front door must make a replica loss, hang, or drain
invisible to callers — mid-stream replica death retries transparently
on a survivor with token parity, ejection walks the
eject→half-open→rejoin lifecycle with cooldown hysteresis, the
fleet-wide retry budget bounds amplification, hedging races a second
replica past the latency quantile, and drain/join choreography moves
traffic without dropping a request.

The PyTorch port's twin of the reference's ``tests/unit/test_router.py``: the same
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
from unionml_tpu_torch.serving.engine import DecodeEngine as _DecodeEngine
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    FaultInjector,
    Overloaded,
    deadline_scope,
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


def _resident(engine):
    with engine._lock:
        return sum(r is not None for r in engine._occupant)


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    pytest.fail(f"timed out waiting for {what}")


class FakeReplica(ReplicaHandle):
    """Scriptable in-process replica: serves ``tokens`` in ``chunk``-
    sized chunks, optionally failing (``fail_with``) or stalling
    (``delay_s`` per chunk); counts dispatches."""

    def __init__(self, name, tokens=(1, 2, 3, 4), *, chunk=2,
                 fail_with=None, fail_times=0, delay_s=0.0, queue_depth=0,
                 cached=0, burn=0.0, status="ok"):
        self.name = name
        self.tokens = list(tokens)
        self.chunk = chunk
        self.fail_with = fail_with
        self.fail_times = fail_times  # 0 = fail every dispatch
        self.delay_s = delay_s
        self.queue_depth = queue_depth
        self.cached = cached
        self.burn = burn
        self.status = status
        self.dispatches = 0
        self.health_calls = 0
        self.drained = False
        self.resumed = False

    def generate_stream(self, prompt, *, max_new_tokens=None):
        self.dispatches += 1
        if self.fail_with is not None and (
            self.fail_times == 0 or self.dispatches <= self.fail_times
        ):
            raise self.fail_with
        for i in range(0, len(self.tokens), self.chunk):
            if self.delay_s:
                time.sleep(self.delay_s)
            self.chunks_yielded = getattr(self, "chunks_yielded", 0) + 1
            yield self.tokens[i:i + self.chunk]

    def health(self):
        self.health_calls += 1
        return {
            "status": self.status,
            "queue_depth": self.queue_depth,
            "burn": self.burn,
        }

    def cached_prefix_len(self, prompt):
        return self.cached

    def drain(self, timeout=None):
        self.drained = True
        return True

    def resume(self):
        self.resumed = True


def _router(replicas, **policy_kw):
    policy_kw.setdefault("health_ttl_s", 0.0)
    policy_kw.setdefault("jitter_s", 0.0)
    policy_kw.setdefault("backoff_base_s", 0.0)
    clock = policy_kw.pop("clock", time.monotonic)
    return FleetRouter(
        replicas,
        policy=RouterPolicy(**policy_kw),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        clock=clock,
        sleep=lambda s: None,
    )


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ----------------------------------------------------------------- policy


def test_policy_validation():
    with pytest.raises(ValueError, match="max_attempts"):
        RouterPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="retry_budget_ratio"):
        RouterPolicy(retry_budget_ratio=1.5)
    with pytest.raises(ValueError, match="hedge_quantile"):
        RouterPolicy(hedge_quantile=1.0)
    with pytest.raises(ValueError, match="eject_consecutive"):
        RouterPolicy(eject_consecutive=0)
    with pytest.raises(ValueError, match="at least one replica"):
        FleetRouter([], registry=telemetry.MetricsRegistry())
    with pytest.raises(ValueError, match="unique"):
        FleetRouter(
            [FakeReplica("a"), FakeReplica("a")],
            registry=telemetry.MetricsRegistry(),
        )


# ----------------------------------------------------------------- picking


def test_pick_prefers_cache_locality():
    """The replica holding the longest cached prefix wins the pick
    (SGLang-style cache-aware routing)."""
    a = FakeReplica("a", cached=0)
    b = FakeReplica("b", cached=6)
    router = _router([a, b])
    router.generate([1, 2, 3, 4, 5, 6, 7, 8])
    assert b.dispatches == 1 and a.dispatches == 0


def test_pick_avoids_deep_queue_and_breaker():
    a = FakeReplica("a", queue_depth=5)
    b = FakeReplica("b", queue_depth=0)
    router = _router([a, b])
    router.generate([1, 2, 3])
    assert b.dispatches == 1 and a.dispatches == 0

    # breaker-open replica is scored far below a clean one
    c = FakeReplica("c")
    d = FakeReplica("d")
    c.health = lambda: {
        "status": "degraded", "queue_depth": 0, "breaker_open": True,
    }
    r2 = _router([c, d])
    r2.generate([1, 2, 3])
    assert d.dispatches == 1 and c.dispatches == 0


def test_pick_shifts_off_slo_burn():
    """A replica burning SLO budget loses the pick before it formally
    breaches — load shifts ahead of the page."""
    a = FakeReplica("a", burn=2.0)
    b = FakeReplica("b", burn=0.0)
    router = _router([a, b])
    router.generate([1, 2, 3])
    assert b.dispatches == 1 and a.dispatches == 0


def test_pick_skips_draining_replica_health():
    """A replica whose OWN health says draining (drained directly, not
    through the router) is not routed to."""
    a = FakeReplica("a", status="draining")
    b = FakeReplica("b")
    router = _router([a, b])
    for _ in range(4):
        router.generate([1, 2, 3])
    assert a.dispatches == 0 and b.dispatches == 4


# ---------------------------------------------------------------- failover


def test_retry_fails_over_to_survivor():
    boom = EngineUnavailable("replica down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom, cached=8)   # picked first
    b = FakeReplica("b", tokens=(9, 8, 7))
    router = _router([a, b])
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [9, 8, 7]
    assert a.dispatches == 1 and b.dispatches == 1
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "route" in kinds and "retry" in kinds


def test_non_retryable_errors_surface():
    """The caller's own deadline and validation errors must NOT burn
    retries — a second attempt is just as wrong."""
    a = FakeReplica("a", fail_with=DeadlineExceeded("too late"), cached=8)
    b = FakeReplica("b")
    router = _router([a, b])
    with pytest.raises(DeadlineExceeded):
        router.generate([1, 2, 3, 4, 5, 6, 7, 8])
    assert b.dispatches == 0

    c = FakeReplica("c", fail_with=ValueError("bad prompt"), cached=8)
    d = FakeReplica("d")
    r2 = _router([c, d])
    with pytest.raises(ValueError):
        r2.generate([1, 2, 3, 4, 5, 6, 7, 8])
    assert d.dispatches == 0


def test_retry_budget_bounds_amplification():
    """With every dispatch failing, total dispatches stay within
    requests + burst + ratio * requests — the retry-storm bound."""
    boom = EngineUnavailable("down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom)
    b = FakeReplica("b", fail_with=boom)
    n, ratio, burst = 20, 0.2, 2.0
    router = _router(
        [a, b], retry_budget_ratio=ratio, retry_budget_burst=burst,
        max_attempts=5,
    )
    failures = 0
    for _ in range(n):
        with pytest.raises(EngineUnavailable):
            router.generate([1, 2, 3])
        failures += 1
    dispatches = a.dispatches + b.dispatches
    retries = dispatches - n
    assert failures == n
    assert retries <= burst + ratio * n, (
        f"{retries} retries for {n} requests exceeds the "
        f"{burst} + {ratio} * {n} budget"
    )
    assert int(router._m_budget_exhausted.value) > 0


def test_retry_honors_retry_after_hint():
    slept = []
    a = FakeReplica(
        "a", fail_with=Overloaded("busy", retry_after_s=0.7), cached=8,
    )
    b = FakeReplica("b")
    router = FleetRouter(
        [a, b],
        policy=RouterPolicy(
            health_ttl_s=0.0, jitter_s=0.0, backoff_base_s=0.01,
        ),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
        sleep=slept.append,
    )
    router.generate([1, 2, 3, 4, 5, 6, 7, 8])
    assert slept and slept[0] >= 0.7  # the hint outranks the backoff


# ---------------------------------------------------- ejection lifecycle


def test_eject_half_open_rejoin_lifecycle():
    """THE hysteresis walk: consecutive failures eject, the cooldown
    expires into half-open, one probe flows, success rejoins and
    resets the ladder; a failed probe re-ejects with doubled
    cooldown."""
    clock = _Clock()
    boom = EngineUnavailable("down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom, cached=8)  # preferred & failing
    b = FakeReplica("b", tokens=(5, 5))
    router = _router(
        [a, b], clock=clock, eject_consecutive=2, eject_cooldown_s=10.0,
        retry_budget_burst=100.0, retry_budget_ratio=1.0,
    )
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]

    # two failing requests (each retried onto b) eject a
    for _ in range(2):
        assert router.generate(prompt) == [5, 5]
    assert router.health()["replicas"]["a"]["state"] == "ejected"
    assert int(router._m_ejections.labels("a").value) == 1
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "eject" in kinds

    # while ejected, traffic all lands on b
    before = a.dispatches
    for _ in range(4):
        router.generate(prompt)
    assert a.dispatches == before

    # cooldown expiry → half-open → a probe flows (rr trickle), but a
    # still fails → re-eject with DOUBLED cooldown
    clock.advance(10.5)
    for _ in range(10):  # enough picks for the probe trickle to fire
        router.generate(prompt)
    assert router.health()["replicas"]["a"]["state"] == "ejected"
    assert int(router._m_ejections.labels("a").value) == 2
    state = router._replicas["a"]
    assert state.rejoin_at - clock() == pytest.approx(20.0, abs=0.6)
    eject_events = [
        e for e in router._flight.dump(kind="eject")
        if e.get("replica") == "a"
    ]
    assert eject_events[-1]["cause"] == "probe_failed"

    # heal the replica; second probe succeeds → rejoin, ladder reset
    a.fail_with = None
    a.tokens = [5, 5]
    clock.advance(20.5)
    for _ in range(10):
        router.generate(prompt)
    assert router.health()["replicas"]["a"]["state"] == "live"
    assert router.health()["replicas"]["a"]["eject_count"] == 0
    assert int(router._m_rejoins.labels("a").value) == 1
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "probe" in kinds and "rejoin" in kinds
    # healed replica takes traffic again (it holds the cached prefix)
    before = a.dispatches
    router.generate(prompt)
    assert a.dispatches == before + 1


def test_router_health_degrades_below_floor():
    """All replicas ejected: the router answers degraded health (the
    balancer above sheds) instead of blackholing."""
    clock = _Clock()
    boom = EngineUnavailable("down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom)
    router = _router(
        [a], clock=clock, eject_consecutive=1, max_attempts=1,
    )
    with pytest.raises(EngineUnavailable):
        router.generate([1, 2, 3])
    assert router.health()["status"] == "degraded"
    assert router.health()["live_replicas"] == 0
    with pytest.raises(EngineUnavailable, match="no live replicas"):
        router.generate([1, 2, 3])
    assert int(router._g_live.value) == 0


# ----------------------------------------------------------------- hedging


def test_hedge_second_dispatch_wins_tail():
    """A dispatch stuck past the hedge delay races a second replica;
    the fast answer wins and the loser is recorded."""
    a = FakeReplica("a", tokens=(1, 1, 1, 1), delay_s=0.4, cached=8)
    b = FakeReplica("b", tokens=(1, 1, 1, 1))
    router = _router(
        [a, b], hedge=True, hedge_min_s=0.05, hedge_warmup=10**9,
    )
    # warmup never reached → delay = max(hedge_min_s, 1.0) would be 1s;
    # shrink by seeding samples is the honest path, so drop the floor:
    router._hedge_delay_s = lambda: 0.05
    t0 = time.perf_counter()
    out = router.generate([1, 2, 3, 4, 5, 6, 7, 8])
    elapsed = time.perf_counter() - t0
    assert out == [1, 1, 1, 1]
    assert b.dispatches == 1, "hedge lane must have dispatched"
    assert elapsed < 0.8, f"hedge should beat the 1.6s slow lane ({elapsed:.2f}s)"
    wins = int(router._m_hedges.labels("b", "win").value)
    assert wins == 1
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "hedge" in kinds


def test_failed_hedge_lane_does_not_abort_primary():
    """A hedge lane that fails fast (its replica is down) sets the
    done event with NO winner — the healthy, still-streaming primary
    lane must keep going and win, not abandon itself."""
    a = FakeReplica("a", tokens=(7, 7, 7, 7), delay_s=0.15, cached=8)
    boom = EngineUnavailable("down", reason="unreachable")
    b = FakeReplica("b", fail_with=boom)
    router = _router(
        [a, b], hedge=True, hedge_min_s=0.02, hedge_warmup=10**9,
    )
    router._hedge_delay_s = lambda: 0.02
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [7, 7, 7, 7]
    assert b.dispatches == 1  # the hedge fired, failed, and was ignored


def test_hedge_falls_back_to_retry_envelope():
    """With hedge=True, a transient failure of the primary BEFORE the
    hedge delay must still be retried (the hedge cannot weaken the
    retry contract) — the fallback draws a budget token and succeeds
    on a survivor."""
    boom = EngineUnavailable("transient", reason="unreachable")
    a = FakeReplica("a", fail_with=boom, cached=8)  # picked first, dies
    b = FakeReplica("b", tokens=(6, 6))
    router = _router([a, b], hedge=True, hedge_min_s=5.0, hedge_warmup=0)
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [6, 6]
    # the fallback envelope may re-try a (still live below the eject
    # threshold, and it holds the cached prefix) before failing over
    assert a.dispatches >= 1 and b.dispatches >= 1


def test_probe_slot_freed_on_non_retryable_probe_exit():
    """A half-open probe that ends in a caller error (non-retryable)
    says nothing about replica health: the probe slot must be freed —
    not leaked — so a later probe can still rejoin the replica."""
    clock = _Clock()
    boom = EngineUnavailable("down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom, cached=8)
    b = FakeReplica("b", tokens=(5, 5))
    router = _router(
        [a, b], clock=clock, eject_consecutive=1, eject_cooldown_s=10.0,
        retry_budget_burst=100.0, retry_budget_ratio=1.0,
    )
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    router.generate(prompt)            # a fails once -> ejected
    assert router.health()["replicas"]["a"]["state"] == "ejected"
    clock.advance(10.5)
    # the probe dispatch hits a CALLER error (non-retryable)
    a.fail_with = ValueError("bad prompt for this replica")
    got_value_error = 0
    for i in range(16):                # rr trickle reaches the probe
        try:
            router.generate(prompt)
        except ValueError:
            got_value_error += 1
            break
    assert got_value_error == 1, "a probe must have flowed to a"
    assert router._replicas["a"].probe_inflight is False
    # heal a: the NEXT probe must still be possible (no leaked slot)
    a.fail_with = None
    a.tokens = [5, 5]
    for _ in range(16):
        router.generate(prompt)
    assert router.health()["replicas"]["a"]["state"] == "live"


def test_requests_total_outcomes_sum_to_dispatches():
    """Every dispatch lands in exactly ONE outcome bucket: a request
    that exhausts retries counts its last dispatch as error, the
    hidden ones as retried_away — never both."""
    boom = EngineUnavailable("down", reason="unreachable")
    a = FakeReplica("a", fail_with=boom)
    b = FakeReplica("b", fail_with=boom)
    router = _router(
        [a, b], max_attempts=2, retry_budget_burst=100.0,
        retry_budget_ratio=1.0, eject_consecutive=10**9,
    )
    for _ in range(5):
        with pytest.raises(EngineUnavailable):
            router.generate([1, 2, 3])
    outcomes = {
        values: child.value
        for values, child in router._m_routed.children()
    }
    assert sum(outcomes.values()) == a.dispatches + b.dispatches
    errors = sum(v for k, v in outcomes.items() if k[1] == "error")
    assert errors == 5  # one terminal failure per request


def test_hedge_loser_abandons_stream():
    """The losing lane must stop consuming once a winner exists — not
    decode to completion (that would double device work on exactly the
    degraded fleet hedging protects)."""
    a = FakeReplica("a", tokens=tuple(range(40)), chunk=2, delay_s=0.06,
                    cached=8)                       # slow loser: 20 chunks
    b = FakeReplica("b", tokens=tuple(range(40)), chunk=40)
    router = _router(
        [a, b], hedge=True, hedge_min_s=0.02, hedge_warmup=10**9,
    )
    router._hedge_delay_s = lambda: 0.02
    out = router.generate(list(range(1, 9)))
    assert out == list(range(40))
    time.sleep(0.5)  # give the loser lane time to notice and bail
    assert getattr(a, "chunks_yielded", 0) < 20, (
        "loser decoded to completion instead of abandoning"
    )
    # outcome disjointness holds for hedged requests too
    outcomes = {
        values: child.value for values, child in router._m_routed.children()
    }
    assert outcomes.get(("b", "ok")) == 1
    assert outcomes.get(("a", "hedge_lose")) == 1


def test_hedge_fallback_excludes_failed_lanes():
    """The hedge-failure fallback must not immediately re-pick the
    replica that just failed (cache affinity still scores it highest
    until it ejects)."""
    boom = EngineUnavailable("transient", reason="unreachable")
    a = FakeReplica("a", fail_with=boom, cached=8)   # fails fast, always
    b = FakeReplica("b", tokens=(6, 6))
    router = _router(
        [a, b], hedge=True, hedge_min_s=5.0, hedge_warmup=0,
        max_attempts=2,
    )
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [6, 6]
    # the fallback went straight to b: a saw ONLY the original lane
    # dispatch, not a doomed fallback re-pick
    assert a.dispatches == 1 and b.dispatches == 1


def test_hedge_not_fired_under_quantile():
    a = FakeReplica("a", tokens=(2, 2), cached=8)
    b = FakeReplica("b", tokens=(2, 2))
    router = _router([a, b], hedge=True, hedge_min_s=5.0, hedge_warmup=0)
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [2, 2]
    assert b.dispatches == 0  # fast first lane: no hedge spent


def test_hedge_spends_no_budget_without_second_replica():
    """On a 1-replica fleet, a slow request past the hedge delay must
    NOT burn a retry-budget token on a lane whose pick would fail —
    that would drain the bucket and starve genuine retries."""
    a = FakeReplica("a", tokens=(3, 3), delay_s=0.1)
    router = _router(
        [a], hedge=True, hedge_min_s=0.01, hedge_warmup=10**9,
        retry_budget_burst=2.0,
    )
    router._hedge_delay_s = lambda: 0.01
    assert router.generate([1, 2, 3]) == [3, 3]
    assert router._budget_tokens == 2.0  # nothing spent
    assert int(router._m_budget_exhausted.value) == 0
    assert not [e for e in router._flight.dump(kind="hedge")]


def test_http_replica_forwards_token_cap_in_payload():
    """max_new_tokens crosses the /predict hop as a payload field (the
    old loud refusal was a stopgap — disaggregated two-leg dispatch
    needs the cap to survive the hop for token parity): explicit
    argument first, else the ambient token_cap_scope, else absent."""
    from unionml_tpu_torch.serving.scheduler import token_cap_scope

    replica = HttpReplica("http://example.invalid:1", name="remote")
    assert replica._payload([1, 2, 3], 8) == {
        "features": [[1, 2, 3]], "max_new_tokens": 8,
    }
    with token_cap_scope(5):
        assert replica._payload([1, 2, 3], None)["max_new_tokens"] == 5
        # explicit beats ambient
        assert replica._payload([1, 2, 3], 8)["max_new_tokens"] == 8
    assert "max_new_tokens" not in replica._payload([1, 2, 3], None)


def test_router_app_multi_prompt_concurrent():
    """A multi-prompt predict dispatches rows concurrently (so replica
    engines can continuous-batch them), preserves row order, and
    relays a row's failure."""
    a = FakeReplica("a", tokens=(9, 9), delay_s=0.05)
    router = _router([a])
    app = make_router_app(router, registry=telemetry.MetricsRegistry())
    t0 = time.perf_counter()
    out = app.predict({"features": [[1, 2], [3, 4], [5, 6], [7, 8]]})
    elapsed = time.perf_counter() - t0
    assert out == [[9, 9]] * 4
    # 4 rows x 2 chunks x 50ms each would be 400ms serialized; the
    # concurrent dispatch overlaps them (generous bound for slow CI)
    assert elapsed < 0.35, f"rows appear serialized ({elapsed:.2f}s)"


# ------------------------------------------------------ drain/join dance


def test_drain_join_choreography():
    a = FakeReplica("a", tokens=(1, 2), cached=8)
    b = FakeReplica("b", tokens=(3, 4))
    router = _router([a, b])
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    assert router.generate(prompt) == [1, 2]

    assert router.drain_replica("a") is True
    assert a.drained
    assert router.health()["replicas"]["a"]["state"] == "draining"
    for _ in range(3):  # all traffic shifts to b, no caller failures
        assert router.generate(prompt) == [3, 4]
    assert a.dispatches == 1

    router.rejoin_replica("a")
    assert a.resumed
    assert router.generate(prompt) == [1, 2]  # affinity restored
    kinds = [e["kind"] for e in router._flight.dump()]
    assert "drain" in kinds and "rejoin" in kinds

    # fleet-wide drain: router itself refuses, health says draining
    assert router.drain() is True
    assert router.health()["status"] == "draining"
    with pytest.raises(EngineUnavailable, match="draining"):
        router.generate(prompt)
    router.resume()
    assert router.health()["status"] == "ok"
    assert router.generate(prompt) == [1, 2]


def test_add_remove_replica_membership():
    a = FakeReplica("a", tokens=(1,))
    router = _router([a])
    b = FakeReplica("b", tokens=(2,), cached=8)
    router.add_replica(b)
    with pytest.raises(ValueError, match="already present"):
        router.add_replica(FakeReplica("b"))
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [2]
    assert router.remove_replica("b") is True
    assert b.drained
    assert "b" not in router.health()["replicas"]
    assert router.generate([1, 2, 3, 4, 5, 6, 7, 8]) == [1]


# ------------------------------------------- engine-backed chaos (THE test)


def test_replica_killed_midstream_invisible_to_caller(tiny_llama):
    """THE acceptance scenario: a replica dies mid-stream (OOM-shaped
    device fault via PR 3's FaultInjector) and the caller sees ZERO
    failures — the router transparently retries on a survivor, replays
    past the tokens already emitted, and the concatenated stream is
    token-identical to the solo run. The victim is NOT ejected for one
    failure (hysteresis threshold), and the flight recorder explains
    the failover."""
    module, params = tiny_llama
    n_new = 24
    fis = [FaultInjector(), FaultInjector()]
    engines = [
        DecodeEngine(
            module, slots=2, max_new_tokens=n_new, prompt_buckets=(8,),
            chunk_steps=2, fault_injector=fis[i],
        )
        for i in range(2)
    ]
    replicas = [
        EngineReplica(engines[i], params, name=f"r{i}") for i in range(2)
    ]
    flight = telemetry.FlightRecorder()
    router = FleetRouter(
        replicas,
        policy=RouterPolicy(
            health_ttl_s=0.0, jitter_s=0.0, backoff_base_s=0.0,
        ),
        registry=telemetry.MetricsRegistry(),
        flight=flight,
    )
    prompt = [3, 1, 4, 1, 5]
    try:
        # two idle identical replicas tie on score: the deterministic
        # round-robin tie-break sends the first request to r0 — so the
        # victim is known a priori, and the fault is armed BEFORE the
        # stream starts (the 2nd decode-chunk dispatch dies), closing
        # the race where a fast CPU decode outruns a late arm()
        victim = 0
        fis[victim].arm("engine.dispatch", nth=2, exc=xla_oom_error())
        tokens = [t for c in router.generate_stream(prompt) for t in c]
        assert tokens == _solo(module, params, prompt, n_new, max_len=engines[0].cache_len)
        assert fis[victim].injected("engine.dispatch") == 1, (
            "the fault must actually have fired mid-stream"
        )
        # the failover is visible to operators, not to the caller
        kinds = [e["kind"] for e in flight.dump()]
        assert "retry" in kinds
        name = f"r{victim}"
        assert int(router._m_routed.labels(name, "retried_away").value) == 1
        assert int(engines[victim]._m_recoveries.value) == 1
        # one failure < eject_consecutive: the victim recovered and
        # stays live (PR 3's supervised recovery handles the process;
        # the router's job was only to hide the blast radius)
        assert router.health()["replicas"][name]["state"] == "live"
        # and the fleet keeps serving with solo parity across the pick
        # spread — the recovered victim included (doubles as the
        # round-robin correctness check, on the already-built engines)
        for p in (prompt, [1, 2, 3], [4, 5, 6], [2, 3, 4]):
            assert router.generate(p) == _solo(
                module, params, p, n_new, max_len=engines[0].cache_len
            )
    finally:
        for e in engines:
            e.close()


def test_cache_affinity_routes_to_warm_engine(tiny_llama):
    """After one request lands on a replica, its radix cache holds the
    prompt's prefix — the router's peek sends the follow-up with the
    same prefix back to the warm replica."""
    module, params = tiny_llama
    n_new = 8
    engines = [
        DecodeEngine(
            module, slots=2, max_new_tokens=n_new, prompt_buckets=(32,),
            chunk_steps=4, prefix_cache=True,
        )
        for _ in range(2)
    ]
    router = FleetRouter(
        [EngineReplica(engines[i], params, name=f"r{i}") for i in range(2)],
        policy=RouterPolicy(health_ttl_s=0.0),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
    )
    try:
        # 16 tokens = one full radix block (default block_size): the
        # peek has something to see once the harvester inserts it
        shared = list(range(1, 17))
        router.generate(shared)
        # the insert happens on the harvester; wait for the peek to see it
        _wait_for(
            lambda: any(
                e.prefix_cache is not None and e.prefix_cache.peek(shared) > 0
                for e in engines
            ),
            what="prefix inserted into some replica's cache",
        )
        warm = next(
            i for i, e in enumerate(engines)
            if e.prefix_cache.peek(shared) > 0
        )
        routes = [
            e for e in router._flight.dump(kind="route")
        ]
        n_before = len(routes)
        router.generate(shared + [77, 78])
        last = router._flight.dump(kind="route")[-1]
        assert len(router._flight.dump(kind="route")) == n_before + 1
        assert last["replica"] == f"r{warm}"
    finally:
        for e in engines:
            e.close()


# ------------------------------------------------- context propagation


def test_scopes_propagate_through_engine_replica(tiny_llama):
    """X-Deadline-Ms semantics survive the router hop: an expired
    ambient deadline sheds at the replica's dequeue, surfacing the
    typed 504 error — NOT a retry (retrying a missed deadline is just
    as late)."""
    module, params = tiny_llama
    engine = DecodeEngine(
        module, slots=1, max_new_tokens=32, prompt_buckets=(8,),
        chunk_steps=2,
    )
    router = FleetRouter(
        [EngineReplica(engine, params, name="r0")],
        policy=RouterPolicy(health_ttl_s=0.0),
        registry=telemetry.MetricsRegistry(),
        flight=telemetry.FlightRecorder(),
    )
    try:
        done = {}

        def occupy():
            done["a"] = router.generate([1, 2, 3])

        t = threading.Thread(target=occupy)
        t.start()
        _wait_for(lambda: _resident(engine) == 1, what="slot occupied")
        with pytest.raises(DeadlineExceeded):
            with deadline_scope(1.0):
                router.generate([4, 5, 6])
        t.join(timeout=120)
        assert not isinstance(done.get("a"), BaseException)
    finally:
        engine.close()


def test_http_replica_emits_propagation_headers():
    """The outbound hop re-emits ambient deadline/tenant/trace scopes
    as headers, so the remote transport re-opens them and the trace
    tree + ledger span the fleet."""
    from unionml_tpu_torch.serving.usage import tenant_scope

    replica = HttpReplica("http://example.invalid:1", name="remote")
    ctx = telemetry.TraceContext(
        trace_id="0af7651916cd43dd8448eb211c80319c",
        span_id="b7ad6b7169203331",
    )
    with deadline_scope(1500.0), tenant_scope("acme"), \
            telemetry.trace_scope(ctx):
        headers = replica._headers()
    assert headers["X-Deadline-Ms"] == "1500.0"
    assert headers["X-Tenant-ID"] == "acme"
    assert headers["traceparent"].startswith(
        "00-0af7651916cd43dd8448eb211c80319c-"
    )
    # and the unreachable host maps to the retryable typed error
    with pytest.raises(EngineUnavailable, match="unreachable"):
        list(replica.generate_stream([1, 2, 3]))


def test_http_replica_maps_typed_statuses():
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        code = 429

        def do_POST(self):
            self.send_response(self.code)
            self.send_header("Retry-After", "7")
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, fmt, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        replica = HttpReplica(base, name="remote")
        with pytest.raises(Overloaded) as exc_info:
            list(replica.generate_stream([1, 2, 3]))
        assert exc_info.value.retry_after_s == 7.0
        Handler.code = 503
        with pytest.raises(EngineUnavailable):
            list(replica.generate_stream([1, 2, 3]))
        Handler.code = 504
        with pytest.raises(DeadlineExceeded):
            list(replica.generate_stream([1, 2, 3]))
        # a 4xx validation reject is DETERMINISTIC: it maps to the
        # non-retryable class so the router never burns budget on it
        Handler.code = 422
        with pytest.raises(ValueError):
            list(replica.generate_stream([1, 2, 3]))
        Handler.code = 500  # other 5xx stay retryable
        with pytest.raises(EngineUnavailable):
            replica.generate([1, 2, 3])
    finally:
        server.shutdown()
        server.server_close()


def test_fastapi_seam_accepts_prebuilt_core():
    """fastapi.serving_app(core=...) mounts a pre-built app (the router
    front door) instead of constructing one — with app=None it hands the
    core back unchanged (the dependency-free path; the FastAPI mount
    itself is gated on the optional import)."""
    from unionml_tpu_torch.serving.fastapi import serving_app

    a = FakeReplica("a", tokens=(4, 2))
    router = _router([a])
    core = make_router_app(router, registry=telemetry.MetricsRegistry())
    assert serving_app(None, core=core) is core
    assert core.predict({"features": [1, 2, 3]}) == [[4, 2]]


# ------------------------------------------------- HTTP front door e2e


def test_router_app_full_stack(tiny_llama):
    """make_router_app over two engine replicas, served on the stdlib
    transport, consumed through HttpReplica — the same dialect top to
    bottom: predict parity with solo, SSE stream parity, health/stats/
    metrics surfaces, drain → 503 with Retry-After."""
    httpx = pytest.importorskip("httpx")
    module, params = tiny_llama
    n_new = 12
    engines = [
        DecodeEngine(
            module, slots=2, max_new_tokens=n_new, prompt_buckets=(8,),
            chunk_steps=4,
        )
        for _ in range(2)
    ]
    registry = telemetry.MetricsRegistry()
    router = FleetRouter(
        [EngineReplica(engines[i], params, name=f"r{i}") for i in range(2)],
        policy=RouterPolicy(health_ttl_s=0.0),
        registry=registry,
        flight=telemetry.FlightRecorder(),
    )
    app = make_router_app(router, registry=registry)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    prompt = [1, 2, 3, 4]
    try:
        solo = _solo(module, params, prompt, n_new, max_len=engines[0].cache_len)
        resp = httpx.post(
            f"{base}/predict", json={"features": [prompt]}, timeout=120,
        )
        assert resp.status_code == 200
        assert resp.json() == [solo]
        assert "X-Request-ID" in resp.headers

        # SSE streaming through the front door
        with httpx.stream(
            "POST", f"{base}/predict/stream", json={"features": prompt},
            timeout=120,
        ) as sresp:
            assert sresp.status_code == 200
            events = []
            for line in sresp.iter_lines():
                if line.startswith("data: "):
                    import json as _json

                    events.append(_json.loads(line[len("data: "):]))
        assert events[-1]["done"] is True
        streamed = [t for e in events[:-1] for t in e["tokens"]]
        assert streamed == solo

        # the same endpoint consumed through HttpReplica (a router CAN
        # front another router — the interface is closed under HTTP)
        remote = HttpReplica(base, name="front")
        assert FleetRouter(
            [remote],
            policy=RouterPolicy(health_ttl_s=0.0),
            registry=telemetry.MetricsRegistry(),
            flight=telemetry.FlightRecorder(),
        ).generate(prompt) == solo

        health = httpx.get(f"{base}/health", timeout=30).json()
        assert health["status"] == "ok" and health["live_replicas"] == 2
        stats = httpx.get(f"{base}/stats", timeout=30).json()
        assert stats["engine"] == "router"
        metrics = httpx.get(f"{base}/metrics", timeout=30).text
        assert "unionml_router_requests_total" in metrics
        assert "unionml_router_live_replicas" in metrics

        # drain: predict answers 503 + Retry-After; health says draining
        app.drain(timeout=30)
        resp = httpx.post(
            f"{base}/predict", json={"features": [prompt]}, timeout=120,
        )
        assert resp.status_code == 503
        assert "retry-after" in {k.lower() for k in resp.headers}
        assert httpx.get(f"{base}/health", timeout=30).status_code == 503
        app.resume()
        assert httpx.get(f"{base}/health", timeout=30).json()["status"] == "ok"
        resp = httpx.post(
            f"{base}/predict", json={"features": [prompt]}, timeout=120,
        )
        assert resp.status_code == 200 and resp.json() == [solo]

        # validation errors stay 422 through the front door
        resp = httpx.post(f"{base}/predict", json={}, timeout=30)
        assert resp.status_code == 422
    finally:
        app.shutdown()
        for e in engines:
            e.close()


# -------------------------------------- weighted least-request picking


def test_latency_weight_sheds_slow_replica_without_ejection():
    """PR 10's named follow-up: with latency_weight on, a healthy-but-
    slow replica's rolling dispatch latency pushes its score down, so
    it sheds share smoothly — no failures, no ejection."""
    a = FakeReplica("a", tokens=(1, 1), chunk=2, delay_s=0.05)  # slow
    b = FakeReplica("b", tokens=(1, 1), chunk=2)                # fast
    router = _router([a, b], latency_weight=50.0)
    # warmup: with no samples the term is 0 and ties round-robin, so
    # both replicas take traffic and seed their windows
    for _ in range(4):
        router.generate([1, 2, 3])
    warmup_a = a.dispatches
    assert warmup_a >= 1, "round-robin warmup must reach the slow replica"
    # steady state: the slow replica's ~50ms mean costs it 2.5 score
    # points — it loses every subsequent pick
    for _ in range(12):
        router.generate([1, 2, 3])
    assert a.dispatches == warmup_a, (
        f"slow replica kept winning picks ({a.dispatches} vs warmup "
        f"{warmup_a})"
    )
    assert b.dispatches == 16 - warmup_a
    # shed share, NOT ejected: the replica never failed
    assert router.health()["replicas"]["a"]["state"] == "live"
    assert int(router._m_ejections.labels("a").value) == 0


def test_latency_weight_off_by_default():
    a = FakeReplica("a", tokens=(1, 1), delay_s=0.03)
    b = FakeReplica("b", tokens=(1, 1))
    router = _router([a, b])
    for _ in range(8):
        router.generate([1, 2, 3])
    # pure round-robin ties: the slow replica keeps its half
    assert a.dispatches == 4 and b.dispatches == 4


# ------------------------------------------------- remote cache peek


def test_fleet_cached_prefix_len_is_max_over_routable():
    a = FakeReplica("a", cached=4)
    b = FakeReplica("b", cached=12)
    c = FakeReplica("c", cached=99)
    router = _router([a, b, c])
    router.drain_replica("c")  # draining replicas don't count
    assert router.cached_prefix_len([1, 2, 3]) == 12


def test_remote_cache_peek_e2e_with_ttl(tmp_path):
    """Satellite: HttpReplica.cached_prefix_len probes the remote
    GET /debug/cache/peek (it hardcoded 0 before — cross-host
    cache-affinity routing was blind) and TTL-caches the probe like
    health, so it can never become a per-pick round trip."""
    a = FakeReplica("a", cached=8)
    router = _router([a])
    registry = telemetry.MetricsRegistry()
    app = make_router_app(router, registry=registry)
    host, port = app.serve(port=0, blocking=False)
    base = f"http://{host}:{port}"
    try:
        remote = HttpReplica(base, name="front", peek_ttl_s=60.0)
        prompt = list(range(1, 17))

        def peek_requests(expect):
            # the stdlib handler lands its request series in a finally
            # AFTER the response flushes — bounded wait, like the
            # /metrics scrape smoke
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                n = sum(
                    child.value
                    for values, child in app._m_http_requests.children()
                    if values[1] == "/debug/cache/peek"
                )
                if n >= expect:
                    return n
                time.sleep(0.01)
            return n

        for _ in range(5):
            assert remote.cached_prefix_len(prompt) == 8
        assert peek_requests(1) == 1, (
            "TTL cache must collapse repeat probes"
        )
        # ttl=0 means always-fresh (same contract as health_ttl_s)
        fresh = HttpReplica(base, name="fresh", peek_ttl_s=0.0)
        for _ in range(3):
            assert fresh.cached_prefix_len(prompt) == 8
        assert peek_requests(4) == 4
        # a different prompt is a different cache key
        assert remote.cached_prefix_len([7, 7, 7]) == 8
        # the probe feeds the real pick: a second-tier router over the
        # HTTP replica scores cache affinity across the hop
        assert remote.cached_prefix_len(prompt) > 0
    finally:
        app.shutdown()


def test_remote_cache_peek_degrades_to_zero():
    """No endpoint / unreachable host / bad prompt — the probe answers
    0 and never raises: affinity is an optimization, not a routing
    prerequisite."""
    unreachable = HttpReplica("http://example.invalid:1", name="r")
    assert unreachable.cached_prefix_len([1, 2, 3]) == 0


def test_serving_app_cache_peek_route_contract():
    """ServingApp.debug_cache_peek: 422-shaped errors for a missing
    peek source or an unparseable prompt; the engine-backed wiring is
    one kwarg."""
    from unionml_tpu_torch.serving.http import ServingApp

    class _Model:
        name = "m"
        artifact = object()

    app = ServingApp(_Model())
    with pytest.raises(ValueError, match="no cache peek"):
        app.debug_cache_peek("1,2,3")
    peeked = []
    app2 = ServingApp(
        _Model(), cache_peek=lambda toks: peeked.append(toks) or 16,
    )
    assert app2.debug_cache_peek("1,2,3") == {"cached_prefix_len": 16}
    assert peeked == [[1, 2, 3]]
    with pytest.raises(ValueError):
        app2.debug_cache_peek("")
    with pytest.raises(ValueError):
        app2.debug_cache_peek("1,x,3")


def test_remote_cache_peek_negative_caches_missing_endpoint():
    """A remote WITHOUT the peek route (HTTP 404, any transport's 404
    shape) is negative-cached permanently: one probe, then zero — an
    old replica must not cost a wasted RTT per novel prompt."""
    import http.server

    hits = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            body = b'{"detail": "Not Found"}'  # FastAPI's 404 shape
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        replica = HttpReplica(
            f"http://127.0.0.1:{server.server_address[1]}", name="old",
            peek_ttl_s=0.0,   # always-fresh: only the negative cache saves us
        )
        assert replica.cached_prefix_len([1, 2, 3]) == 0
        assert replica.cached_prefix_len([9, 9, 9]) == 0
        assert replica.cached_prefix_len([5, 5, 5]) == 0
        assert len(hits) == 1, f"endpoint probed {len(hits)} times"
        assert replica._peek_supported is False
    finally:
        server.shutdown()
        server.server_close()


def test_remote_cache_peek_keys_on_prefix():
    """The probe cache keys (and queries) only the first
    peek_prompt_tokens tokens — unique-suffix traffic, the normal LLM
    workload, still hits the TTL cache."""
    a = FakeReplica("a", cached=8)
    router = _router([a])
    app = make_router_app(router, registry=telemetry.MetricsRegistry())
    host, port = app.serve(port=0, blocking=False)
    try:
        remote = HttpReplica(
            f"http://{host}:{port}", name="front",
            peek_ttl_s=60.0, peek_prompt_tokens=4,
        )
        prefix = [1, 2, 3, 4]
        for suffix in ([9], [8, 7], [6, 5, 4]):
            assert remote.cached_prefix_len(prefix + suffix) == 8
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            n = sum(
                child.value
                for values, child in app._m_http_requests.children()
                if values[1] == "/debug/cache/peek"
            )
            if n >= 1:
                break
            time.sleep(0.01)
        assert n == 1, f"prefix-keyed cache missed ({n} probes)"
    finally:
        app.shutdown()
