"""SLO-driven fleet autoscaler: the loop that operates the fleet.

The PyTorch port of :mod:`unionml_tpu.serving.autoscaler`, unchanged:
``EngineReplicaProvisioner.release`` closes the engine, and a closed
:class:`~unionml_tpu_torch.serving.engine.DecodeEngine` drops its device
buffers, so a scale-in hands the card memory back.

The :class:`~unionml_tpu_torch.serving.router.FleetRouter` has every actuator
(``add_replica``/``remove_replica``, drain/join choreography,
``min_live``) and the stack emits every signal (per-replica queue depth
and breaker state, :meth:`~unionml_tpu_torch.slo.SloWatchdog.burn_score`, the
usage ledger's decode capacity headroom) — but nothing closed the loop:
an operator scaled the fleet by hand, and a freshly joined replica
served cold. This module is the closing piece
(docs/robustness.md "Autoscaling & self-healing"):

- :class:`FleetAutoscaler` evaluates fleet health on a deterministic
  injectable clock (``evaluate(now=...)``, synthetic-clock testable
  exactly like ``SloWatchdog.evaluate``) and acts through the router's
  existing actuators. **Scale out** on sustained SLO burn — the fast
  window must burn hard AND the slow window must confirm it for
  ``sustain_evals`` consecutive evaluations, the same multiwindow
  discipline Google-SRE paging uses, so a blip never buys hardware —
  or on capacity-headroom exhaustion (recent-window deltas of
  :meth:`~unionml_tpu_torch.serving.usage.UsageLedger.capacity_totals`), or
  to repair the fleet back to ``min_replicas`` after a replica dies.
  **Scale in** by draining the coldest-cache, lowest-load replica, and
  only when the *projected post-removal* headroom still clears the
  ``headroom_in`` hysteresis band — never below ``min_replicas`` (or
  the router's own ``min_live`` floor), never while any breaker is
  open, a replica is mid-recovery (ejected/half-open), or a drain is
  in flight: scale decisions must not fight failure recovery.
- new capacity is **fleet-warmed before it is routable**
  (Mooncake/SGLang cache-aware lineage): the join hook exports the
  warmest donor replica's hottest prefix blocks
  (:meth:`~unionml_tpu_torch.serving.prefix_cache.RadixPrefixCache
  .export_hot` — host-RAM block entries under lease pinning) and
  imports them into the joiner *before* ``add_replica`` opens traffic,
  so a fresh replica's first requests hit warm prefixes instead of
  recomputing them.
- replicas come from a :class:`ReplicaProvisioner`:
  :class:`EngineReplicaProvisioner` builds in-process
  :class:`~unionml_tpu_torch.serving.router.EngineReplica` s (tests,
  benches, single-host multi-engine), :class:`HttpReplicaProvisioner`
  wraps a spawn callable returning a base URL (subprocess / container
  / cloud API — the real path). A provision failure schedules an
  exponential-backoff retry and the autoscaler keeps evaluating — a
  broken provisioner degrades scaling, it never wedges the loop.

Every decision is explainable post-hoc: a flight-recorder event
(``scale_out`` / ``scale_in`` / ``scale_hold`` with its reason and the
signals that drove it) plus the ``unionml_autoscaler_*`` series
(decision counters by reason, live-replica and recent-headroom gauges,
provision failures, warmed blocks). Reasons are a CLOSED set
(:data:`DECISION_REASONS`) so label cardinality stays bounded.

Deterministic by construction: no wall clock (``clock`` is injectable
monotonic seconds), no randomness; ``start()``/``stop()`` run the
production ticker on a daemon thread exactly like the SLO watchdog's.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.router import (
    EngineReplica,
    FleetRouter,
    HttpReplica,
    ReplicaHandle,
)
from unionml_tpu_torch.serving.scheduler import validate_phase

__all__ = [
    "AutoscalerPolicy",
    "DECISION_REASONS",
    "EngineReplicaProvisioner",
    "FleetAutoscaler",
    "HttpReplicaProvisioner",
    "ReplicaProvisioner",
]

# the CLOSED reason vocabulary (metric label values + flight-event
# reasons; free-form detail rides the flight event's other fields)
DECISION_REASONS = (
    # scale_out
    "below_min",          # self-healing: routable count under min_replicas
    "slo_burn",           # sustained fast+slow-window burn
    "headroom",           # recent decode headroom under headroom_out
    # scale_in
    "surplus",            # projected post-removal headroom clears the band
    "idle",               # no capacity-bearing traffic since last eval
    # scale_hold
    "steady",             # nothing to do
    "at_max",             # out wanted, max_replicas cap reached
    "cooldown_out",       # out wanted, per-direction cooldown running
    "cooldown_in",        # in wanted, per-direction cooldown running
    "breaker_open",       # in wanted, a replica's circuit breaker is open
    "recovery_in_flight",  # in wanted, a replica is ejected/half-open
    "drain_in_flight",    # a drain is running (fleet or replica)
    "min_live",           # in wanted, would breach the routable floor
    "no_pool_victim",     # in wanted, but every drainable candidate is a
    #                       shared colocated replica this POOL autoscaler
    #                       observes without owning
    "provision_failed",   # provisioner raised; backoff retry scheduled
    "provision_backoff",  # out wanted, still inside the failure backoff
)


class ReplicaProvisioner:
    """Where new replicas come from (and where removed ones go).

    The autoscaler's only dependency on infrastructure: ``provision``
    must return a routable :class:`~unionml_tpu_torch.serving.router
    .ReplicaHandle` named ``name`` (raise on failure — the autoscaler
    retries with exponential backoff), ``release`` tears down a
    replica the autoscaler previously provisioned and has already
    drained + removed from the router."""

    def provision(self, name: str) -> ReplicaHandle:
        raise NotImplementedError

    def release(self, handle: ReplicaHandle) -> None:
        """Default: close the handle (subclasses stop the process /
        delete the VM / return the engine to a pool)."""
        handle.close()


class EngineReplicaProvisioner(ReplicaProvisioner):
    """In-process provisioner: ``factory() -> (engine, params)`` builds
    a fresh :class:`~unionml_tpu_torch.serving.engine.DecodeEngine` (tests,
    benches, and single-host multi-engine deployments). ``release``
    closes the engine, so a scale-in actually frees its device
    memory."""

    def __init__(self, factory: Callable[[], tuple]):
        self._factory = factory

    def provision(self, name: str) -> ReplicaHandle:
        engine, params = self._factory()
        return EngineReplica(engine, params, name=name)

    def release(self, handle: ReplicaHandle) -> None:
        engine = getattr(handle, "engine", None)
        if engine is not None:
            engine.close()
        handle.close()


class HttpReplicaProvisioner(ReplicaProvisioner):
    """The real-path stub: ``spawn(name) -> base_url`` launches a
    serving process somewhere (subprocess, container, cloud API) and
    returns its URL; the handle is an :class:`~unionml_tpu_torch.serving
    .router.HttpReplica` over it. ``teardown(handle)`` (optional)
    reverses the spawn on scale-in. Extra kwargs pass through to
    :class:`~unionml_tpu_torch.serving.router.HttpReplica` (timeouts, peek
    TTL)."""

    def __init__(
        self,
        spawn: Callable[[str], str],
        *,
        teardown: Optional[Callable[[ReplicaHandle], None]] = None,
        **replica_kwargs,
    ):
        self._spawn = spawn
        self._teardown = teardown
        self._replica_kwargs = dict(replica_kwargs)

    def provision(self, name: str) -> ReplicaHandle:
        base_url = self._spawn(name)
        return HttpReplica(base_url, name=name, **self._replica_kwargs)

    def release(self, handle: ReplicaHandle) -> None:
        if self._teardown is not None:
            self._teardown(handle)
        handle.close()


class AutoscalerPolicy:
    """Tunables for :class:`FleetAutoscaler` (one object, bench/test
    sweeps name their configuration in one place — RouterPolicy's
    convention).

    **Scale-out triggers.** Sustained SLO burn: the fast window must
    burn at ``fast_burn_threshold`` AND the slow window at
    ``slow_burn_threshold`` for ``sustain_evals`` consecutive
    evaluations (defaults 2.0/1.0 × budget — scaling acts *earlier*
    than the 14.4/6 paging thresholds: hardware is cheaper than a
    page). Headroom: the recent-window decode headroom (deltas of the
    ledger's capacity counters between evaluations) under
    ``headroom_out``. Self-healing: routable replicas under
    ``min_replicas`` scales out immediately, cooldown exempt — repair
    must not wait out a cooldown that a scale action started.

    **Scale-in trigger + hysteresis.** Only when burn is fully clear
    (fast window ≤ ``burn_clear``) and the *projected post-removal*
    headroom — current utilization re-spread over one fewer replica,
    ``1 - (1 - headroom) * live / (live - 1)`` — still clears
    ``headroom_in``. The band between ``headroom_out`` and
    ``headroom_in`` is the hysteresis that keeps out/in from
    oscillating: with the defaults (0.1 / 0.5) a removal is only
    attempted when the survivors would still run under half capacity,
    so the removal itself cannot re-trigger a scale-out.

    **Cooldowns** are per-direction (``cooldown_out_s`` short — under-
    capacity hurts users; ``cooldown_in_s`` long — flapping hurts
    caches) and only start on a *successful* action.

    **Provision failures** back off exponentially
    (``provision_backoff_s · 2^(failures-1)`` capped at
    ``provision_backoff_max_s``) without blocking evaluation.

    **Reaping.** A replica that stays dead — ejected, or its health
    probe unreachable, for ``reap_unhealthy_evals`` consecutive
    evaluations — is removed from the router and released (flight
    event ``scale_reap``): a crashed process that will never rejoin
    must not pin the fleet at ``max_replicas`` and block its own
    replacement, nor hold scale-in hostage forever. The dead replica
    was not routable, so reaping changes membership, never capacity;
    the ``below_min`` repair path then provisions the replacement.

    ``warm_blocks`` bounds the donor export per join (0 disables fleet
    warming); ``drain_timeout_s`` bounds the scale-in drain.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        fast_burn_threshold: float = 2.0,
        slow_burn_threshold: float = 1.0,
        sustain_evals: int = 2,
        burn_clear: float = 0.0,
        headroom_out: float = 0.1,
        headroom_in: float = 0.5,
        cooldown_out_s: float = 30.0,
        cooldown_in_s: float = 120.0,
        provision_backoff_s: float = 1.0,
        provision_backoff_max_s: float = 30.0,
        warm_blocks: int = 64,
        drain_timeout_s: float = 30.0,
        reap_unhealthy_evals: int = 4,
        name_prefix: str = "auto",
    ):
        if reap_unhealthy_evals < 1:
            raise ValueError(
                f"reap_unhealthy_evals must be >= 1, got "
                f"{reap_unhealthy_evals}"
            )
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas {min_replicas}"
            )
        if sustain_evals < 1:
            raise ValueError(f"sustain_evals must be >= 1, got {sustain_evals}")
        if not 0.0 <= headroom_out < headroom_in <= 1.0:
            raise ValueError(
                f"need 0 <= headroom_out < headroom_in <= 1 (the "
                f"hysteresis band), got {headroom_out} / {headroom_in}"
            )
        if warm_blocks < 0:
            raise ValueError(f"warm_blocks must be >= 0, got {warm_blocks}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self.sustain_evals = int(sustain_evals)
        self.burn_clear = float(burn_clear)
        self.headroom_out = float(headroom_out)
        self.headroom_in = float(headroom_in)
        self.cooldown_out_s = float(cooldown_out_s)
        self.cooldown_in_s = float(cooldown_in_s)
        self.provision_backoff_s = float(provision_backoff_s)
        self.provision_backoff_max_s = float(provision_backoff_max_s)
        self.warm_blocks = int(warm_blocks)
        self.drain_timeout_s = float(drain_timeout_s)
        self.reap_unhealthy_evals = int(reap_unhealthy_evals)
        self.name_prefix = str(name_prefix)


class FleetAutoscaler:
    """The closed loop over a :class:`~unionml_tpu_torch.serving.router
    .FleetRouter` (module docstring has the full story).

    Args:
        router: the fleet to operate.
        provisioner: where new replicas come from.
        policy: :class:`AutoscalerPolicy` (defaults are conservative).
        slo: an optional fleet-level :class:`~unionml_tpu_torch.slo
            .SloWatchdog` — evaluated each tick on the autoscaler's
            clock for the sustained fast+slow burn trigger. Without
            one, the max per-replica ``burn`` from the replicas' own
            health dicts stands in for BOTH windows (replica
            watchdogs only refresh the fast read).
        usage: an optional :class:`~unionml_tpu_torch.serving.usage
            .UsageLedger` shared by the replica engines — its capacity
            counters, differenced between evaluations, are the
            recent-window headroom signal. Without one, scale-in can
            only infer "idle" from empty replica queues (queued work
            anywhere always holds scale-in), which cannot see
            decode-in-flight work — wire a ledger for load-aware
            consolidation.
        registry / flight: explicit telemetry sinks (process-global by
            default).
        clock: injectable monotonic seconds — deterministic tests pass
            a synthetic clock and drive :meth:`evaluate(now=...)
            <evaluate>` directly.
    """

    def __init__(
        self,
        router: FleetRouter,
        provisioner: ReplicaProvisioner,
        *,
        policy: Optional[AutoscalerPolicy] = None,
        slo=None,
        usage=None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        flight: Optional[telemetry.FlightRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
        phase: Optional[str] = None,
    ):
        self.router = router
        self.provisioner = provisioner
        self.policy = policy if policy is not None else AutoscalerPolicy()
        # per-pool scaling (docs/serving.md "Disaggregated serving"):
        # when set, this autoscaler observes the replicas of its phase
        # PLUS shared colocated members (the phase-aware router routes
        # either leg to those, so they are real pool capacity and
        # their corpses must be reaped by somebody), but only ACTS —
        # scale-in drains — on exact-phase members it owns. A
        # phase-split fleet runs one autoscaler per pool, each with
        # its own signal wiring (a TTFT-objective watchdog scales
        # prefill; the decode pool's ledger headroom scales decode)
        # and its own min/max band. Provisioned replicas are stamped
        # with the phase so the router's phase-aware pick and the
        # next evaluation both see them in the right pool.
        # None (default) operates the whole fleet — the single-pool
        # behavior, unchanged.
        self.phase = None if phase is None else validate_phase(phase)
        # pool-scoped names: two pool autoscalers (possibly sharing
        # one policy object — custom name_prefix included) each start
        # their counters at 0, so the phase must be IN the name or
        # the second pool's first scale-out dies on the router's
        # name-collision join check exactly when it needed capacity
        self._name_prefix = (
            f"{self.policy.name_prefix}-{self.phase}"
            if self.phase is not None else self.policy.name_prefix
        )
        self._slo = slo
        self._usage = usage
        self._clock = clock
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._flight = (
            flight if flight is not None else telemetry.get_flight_recorder()
        )
        self._eval_lock = threading.Lock()
        self._burn_streak = 0
        self._last_out_at = float("-inf")
        # scale-in starts its cooldown at the FIRST evaluation: a
        # just-started autoscaler must not shrink a fleet it has only
        # observed for one tick (scale-out stays immediate — under-
        # capacity hurts users, a grace period doesn't)
        self._last_in_at: Optional[float] = None
        self._provision_failures = 0
        self._provision_retry_at = float("-inf")
        self._next_id = 0
        self._provisioned: Dict[str, ReplicaHandle] = {}
        self._last_cap = 0.0
        self._last_used = 0.0
        self._unhealthy_streak: Dict[str, int] = {}
        self._last_decision: Optional[dict] = None
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        # the fleet dashboard (GET /debug/fleet on the router app)
        # reads the operating autoscaler's view through this link;
        # phase-split fleets additionally register per pool, so the
        # dashboard can show every pool's autoscaler side by side
        router.autoscaler = self
        if isinstance(getattr(router, "autoscalers", None), dict):
            router.autoscalers[self.phase or "fleet"] = self
        R = self._registry
        self._m_decisions = R.counter(
            "unionml_autoscaler_decisions_total",
            "Autoscaler decisions by kind and (closed-set) reason — "
            "every evaluation lands in exactly one child, so the "
            "decision stream is reconstructible from counters alone.",
            ("decision", "reason"),
        )
        self._m_provision_failures = R.counter(
            "unionml_autoscaler_provision_failures_total",
            "Provisioner failures during scale-out (each schedules an "
            "exponential-backoff retry; the loop never wedges).",
        )
        self._m_warmed = R.counter(
            "unionml_autoscaler_warmed_blocks_total",
            "Prefix-cache blocks imported into joining replicas from "
            "warm-donor exports (fleet-warmed joins).",
        )
        self._m_reaped = R.counter(
            "unionml_autoscaler_reaped_total",
            "Dead replicas (ejected/unreachable for reap_unhealthy_"
            "evals consecutive evaluations) removed from the router "
            "so their replacement can provision.",
        )
        self._g_replicas = R.gauge(
            "unionml_autoscaler_replicas",
            "Routable replicas (live or half-open) at the last "
            "autoscaler evaluation.",
        )
        self._g_headroom = R.gauge(
            "unionml_autoscaler_headroom",
            "Recent-window decode capacity headroom at the last "
            "evaluation (1.0 when no ledger is wired or no "
            "capacity-bearing traffic flowed).",
        )

    # -- signals -----------------------------------------------------------

    def _burn(self, signals: Dict[str, dict], now: float) -> Dict[str, float]:
        if self._slo is not None:
            self._slo.evaluate(now=now)
            return self._slo.burn_scores()
        # no fleet watchdog: the replicas' own health-dict burn (their
        # per-replica watchdogs' fast window) stands in for both
        replica_burn = max(
            (
                float(s["health"].get("burn", 0.0) or 0.0)
                for s in signals.values()
            ),
            default=0.0,
        )
        return {"fast": replica_burn, "slow": replica_burn}

    def _recent_headroom(self) -> "tuple[float, bool]":
        """``(headroom, traffic_flowed)`` over the window since the
        previous evaluation — counter deltas, so an idle morning never
        dilutes an overloaded afternoon."""
        if self._usage is None:
            return 1.0, False
        cap, used = self._usage.capacity_totals()
        d_cap = cap - self._last_cap
        d_used = used - self._last_used
        self._last_cap, self._last_used = cap, used
        if d_cap <= 0.0:
            return 1.0, False
        return max(0.0, 1.0 - d_used / d_cap), True

    # -- the decision ------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One decision: gather signals, decide scale out / in / hold,
        act, and record it (flight event + counters). Deterministic
        for a given ``now`` and fleet state; the production ticker
        calls this with no argument."""
        with self._eval_lock:
            if now is None:
                now = self._clock()
            return self._evaluate_locked(now)

    def _pool_signals(self, signals: Dict[str, dict]) -> Dict[str, dict]:
        """Restrict a fleet signal sweep to this autoscaler's pool
        (no-op for a fleet-wide autoscaler). COLOCATED replicas are
        included — the phase-aware router routes either leg to them,
        so they are real pool capacity (and their corpses must still
        be reaped by SOMEBODY in a fleet running only pool
        autoscalers); :meth:`_owned` narrows back to exact-phase
        members wherever the autoscaler ACTS rather than observes.
        Phase rides the signal dicts, so filtering costs no extra
        probes."""
        if self.phase is None:
            return signals
        return {
            n: s for n, s in signals.items()
            if s.get("phase", "colocated") in (self.phase, "colocated")
        }

    def _owned(self, signals: Dict[str, dict]) -> Dict[str, dict]:
        """The members this autoscaler may DRAIN (scale-in victims):
        exact-phase only — a shared colocated replica serves both
        pools, and one pool's consolidation must not remove capacity
        the other depends on."""
        if self.phase is None:
            return signals
        return {
            n: s for n, s in signals.items()
            if s.get("phase", "colocated") == self.phase
        }

    def _evaluate_locked(self, now: float) -> dict:
        p = self.policy
        if self._last_in_at is None:
            self._last_in_at = now
        signals = self._pool_signals(self.router.replica_signals())
        signals = self._reap_dead(signals)
        routable = {
            n: s for n, s in signals.items()
            if s["state"] in ("live", "half_open")
            and s["health"].get("status") not in ("unreachable", "draining")
        }
        live = len(routable)
        draining = [n for n, s in signals.items() if s["state"] == "draining"]
        # anything mid-failure-recovery: ejected/half-open router
        # state, or a dead-but-unreaped (unreachable) replica — while
        # any exists, scale-in must hold (never fight recovery)
        recovering = [
            n for n, s in signals.items()
            if s["state"] in ("ejected", "half_open")
            or s["health"].get("status") == "unreachable"
        ]
        breakers = [
            n for n, s in signals.items()
            if s["health"].get("breaker_open")
        ]
        burn = self._burn(signals, now)
        headroom, traffic = self._recent_headroom()
        self._g_replicas.set(float(live))
        self._g_headroom.set(headroom)

        burn_hot = (
            burn["fast"] >= p.fast_burn_threshold
            and burn["slow"] >= p.slow_burn_threshold
        )
        self._burn_streak = self._burn_streak + 1 if burn_hot else 0
        detail = {
            "live": live,
            "burn_fast": round(burn["fast"], 4),
            "burn_slow": round(burn["slow"], 4),
            "burn_streak": self._burn_streak,
            "headroom": round(headroom, 4),
            "traffic": traffic,
        }

        fleet_draining = (
            self.router.health().get("status") == "draining" or draining
        )

        # -- scale OUT ---------------------------------------------------
        out_reason = None
        if live < p.min_replicas:
            out_reason = "below_min"       # repair: cooldown exempt
        elif self._burn_streak >= p.sustain_evals:
            out_reason = "slo_burn"
        elif traffic and headroom < p.headroom_out:
            out_reason = "headroom"
        if out_reason is not None:
            if fleet_draining:
                return self._hold(now, "drain_in_flight", detail)
            if len(signals) >= p.max_replicas:
                return self._hold(now, "at_max", detail)
            if (
                out_reason != "below_min"
                and now - self._last_out_at < p.cooldown_out_s
            ):
                return self._hold(now, "cooldown_out", detail)
            if now < self._provision_retry_at:
                return self._hold(now, "provision_backoff", detail)
            return self._scale_out(now, out_reason, routable, detail)

        # -- scale IN ----------------------------------------------------
        projected = 1.0
        if live > 1:
            projected = 1.0 - (1.0 - headroom) * live / (live - 1)
        # the "idle" path has NO capacity measurement behind it (no
        # ledger, or no capacity-bearing dispatches since last eval),
        # so it additionally requires every routable queue to be empty
        # — without this, a fleet run with usage=None and no burn
        # source would read every evaluation as idle and shrink itself
        # under full load. The "surplus" path rides the measured
        # headroom signal and keeps its hysteresis-band gate.
        queued = sum(
            float(s["health"].get("queue_depth", 0) or 0)
            for s in routable.values()
        )
        want_in = (
            live > p.min_replicas
            and burn["fast"] <= p.burn_clear
            and self._burn_streak == 0
            and (
                (traffic and projected > p.headroom_in)
                or (not traffic and queued == 0.0)
            )
        )
        if want_in:
            detail["projected_headroom"] = round(projected, 4)
            # scale-in must never fight failure recovery
            if fleet_draining:
                return self._hold(now, "drain_in_flight", detail)
            if breakers:
                return self._hold(
                    now, "breaker_open", {**detail, "replicas": breakers},
                )
            if recovering:
                return self._hold(
                    now, "recovery_in_flight",
                    {**detail, "replicas": recovering},
                )
            if live - 1 < self.router.policy.min_live:
                return self._hold(now, "min_live", detail)
            if now - self._last_in_at < p.cooldown_in_s:
                return self._hold(now, "cooldown_in", detail)
            victims = self._owned(routable)
            if not victims:
                # every drainable candidate is shared colocated
                # capacity this pool autoscaler observes but does not
                # own — consolidating it would steal from the peer pool
                return self._hold(now, "no_pool_victim", detail)
            reason = "surplus" if traffic else "idle"
            return self._scale_in(now, reason, victims, detail)

        return self._hold(now, "steady", detail)

    # -- actions -----------------------------------------------------------

    def _reap_dead(self, signals: Dict[str, dict]) -> Dict[str, dict]:
        """Remove replicas that stayed dead (ejected / unreachable) for
        ``reap_unhealthy_evals`` consecutive evaluations; returns the
        signal set without them. A corpse is not routable, so this
        changes membership, never capacity — and it frees the
        ``max_replicas`` slot its replacement needs."""
        p = self.policy
        for name in list(self._unhealthy_streak):
            if name not in signals:
                self._unhealthy_streak.pop(name)
        reaped: List[str] = []
        for name, s in signals.items():
            dead = (
                s["state"] == "ejected"
                or s["health"].get("status") == "unreachable"
            )
            streak = self._unhealthy_streak.get(name, 0) + 1 if dead else 0
            self._unhealthy_streak[name] = streak
            if (
                dead and streak >= p.reap_unhealthy_evals
                and s["state"] != "draining"
            ):
                reaped.append(name)
        removed: List[str] = []
        for name in reaped:
            logger.info(f"autoscaler: reaping dead replica {name}")
            try:
                self.router.remove_replica(name, drain_timeout=0.0)
            except BaseException as exc:
                # removal failed: record NOTHING — the corpse is still
                # a member, keeps its streak, and is retried next
                # evaluation (a premature counter/event would claim a
                # reap that never happened and re-grant the grace
                # period)
                logger.info(
                    f"autoscaler: reap of {name} failed ({exc!r})"
                )
                continue
            removed.append(name)
            evals = self._unhealthy_streak.pop(name, 0)
            self._flight.record("scale_reap", replica=name, evals=evals)
            self.router.trace_event("scale_reap", replica=name, evals=evals)
            self._m_reaped.inc()
            handle = self._provisioned.pop(name, None)
            if handle is not None:
                try:
                    self.provisioner.release(handle)
                except BaseException:
                    pass
        if removed:
            signals = {
                n: s for n, s in signals.items() if n not in removed
            }
        return signals

    def _record(self, decision: str, reason: str, detail: dict) -> dict:
        self._m_decisions.labels(decision, reason).inc()
        out = {"decision": decision, "reason": reason, **detail}
        self._last_decision = out
        if decision != "scale_hold" or reason != "steady":
            # every acted-or-blocked decision is also a span EVENT on
            # the router's fleet timeline (OTLP export), so a latency
            # spike and the scale decision that caused — or failed to
            # prevent — it sit on one trace axis. Steady holds stay
            # off the timeline for the same reason they stay out of
            # the flight ring.
            self.router.trace_event(decision, reason=reason, **{
                k: v for k, v in detail.items() if k != "traffic"
            })
        return out

    def _hold(self, now: float, reason: str, detail: dict) -> dict:
        # steady holds stay out of the flight ring (a 5 s ticker would
        # flush real request events in hours); every OTHER hold — a
        # trigger wanted an action and a guard stopped it — is recorded
        if reason != "steady":
            self._flight.record("scale_hold", reason=reason, **{
                k: v for k, v in detail.items() if k != "traffic"
            })
        return self._record("scale_hold", reason, detail)

    def _scale_out(
        self, now: float, reason: str,
        routable: Dict[str, dict], detail: dict,
    ) -> dict:
        p = self.policy
        name = f"{self._name_prefix}-{self._next_id}"
        try:
            handle = self.provisioner.provision(name)
            if self.phase is not None:
                # the joiner belongs to this autoscaler's pool: the
                # phase-aware pick and the next evaluation's filter
                # both key on the handle's tag
                handle.phase = self.phase
        except BaseException as exc:
            self._provision_failures += 1
            backoff = min(
                p.provision_backoff_s * (2 ** (self._provision_failures - 1)),
                p.provision_backoff_max_s,
            )
            self._provision_retry_at = now + backoff
            self._m_provision_failures.inc()
            self._flight.record(
                "scale_hold", reason="provision_failed", replica=name,
                error=f"{type(exc).__name__}: {exc}",
                retry_in_s=round(backoff, 3), **detail,
            )
            logger.info(
                f"autoscaler: provision {name} failed ({exc!r}); "
                f"retrying in {backoff:.1f}s"
            )
            return self._record("scale_hold", "provision_failed", detail)
        self._provision_failures = 0
        self._provision_retry_at = float("-inf")
        self._next_id += 1

        # fleet-warm the joiner BEFORE it takes traffic: hottest blocks
        # from the warmest donor (most resident cache blocks)
        donor_name, imported = None, 0
        if p.warm_blocks > 0 and routable:
            donor_name = max(
                routable, key=lambda n: (routable[n]["cache_blocks"], n),
            )
            if routable[donor_name]["cache_blocks"] <= 0:
                donor_name = None
        if donor_name is not None:
            try:
                donor = self.router.replica_handle(donor_name)
                entries = donor.export_hot_blocks(max_blocks=p.warm_blocks)
                imported = int(handle.import_cache_blocks(entries))
            except BaseException as exc:  # warming is best-effort
                logger.info(
                    f"autoscaler: warm-join from {donor_name} failed "
                    f"({exc!r}); {name} joins cold"
                )
                imported = 0
        if imported:
            self._m_warmed.inc(imported)

        try:
            self.router.add_replica(handle)     # now routable
        except BaseException as exc:
            # a join failure (e.g. a name collision with an operator-
            # registered replica) must release the handle — a leaked
            # engine pins device memory for the process lifetime —
            # and surface as a decision, not an exception out of
            # evaluate(); _next_id already advanced, so the retry
            # picks a fresh name
            try:
                self.provisioner.release(handle)
            except BaseException:
                pass
            self._m_provision_failures.inc()
            self._flight.record(
                "scale_hold", reason="provision_failed", replica=name,
                error=f"{type(exc).__name__}: {exc}", **{
                    k: v for k, v in detail.items() if k != "traffic"
                },
            )
            logger.info(
                f"autoscaler: join of {name} failed ({exc!r})"
            )
            return self._record("scale_hold", "provision_failed", detail)
        self._provisioned[name] = handle
        self._last_out_at = now
        self._burn_streak = 0
        self._flight.record(
            "scale_out", replica=name, reason=reason,
            donor=donor_name, warmed_blocks=imported, **{
                k: v for k, v in detail.items() if k != "traffic"
            },
        )
        logger.info(
            f"autoscaler: scale out -> {name} ({reason}; donor="
            f"{donor_name}, warmed {imported} blocks)"
        )
        return self._record("scale_out", reason, {
            **detail, "replica": name, "donor": donor_name,
            "warmed_blocks": imported,
        })

    def _scale_in(
        self, now: float, reason: str,
        routable: Dict[str, dict], detail: dict,
    ) -> dict:
        # victim: coldest cache first, then lowest load, then name (a
        # deterministic tie-break the tests rely on)
        victim = min(
            routable,
            key=lambda n: (
                routable[n]["cache_blocks"],
                float(routable[n]["health"].get("queue_depth", 0)),
                n,
            ),
        )
        self._flight.record(
            "scale_in", replica=victim, reason=reason,
            cache_blocks=routable[victim]["cache_blocks"],
            queue_depth=routable[victim]["health"].get("queue_depth", 0),
            **{k: v for k, v in detail.items() if k != "traffic"},
        )
        drained = self.router.remove_replica(
            victim, drain_timeout=self.policy.drain_timeout_s,
        )
        handle = self._provisioned.pop(victim, None)
        if handle is not None:
            try:
                self.provisioner.release(handle)
            except BaseException as exc:
                logger.info(
                    f"autoscaler: release of {victim} failed ({exc!r})"
                )
        self._last_in_at = now
        logger.info(
            f"autoscaler: scale in -> removed {victim} ({reason}, "
            f"drained={drained})"
        )
        return self._record("scale_in", reason, {
            **detail, "replica": victim, "drained": drained,
        })

    # -- views / lifecycle -------------------------------------------------

    def stats(self) -> dict:
        with self._eval_lock:
            return {
                "last_decision": dict(self._last_decision or {}),
                "burn_streak": self._burn_streak,
                "provisioned": sorted(self._provisioned),
                "provision_failures": self._provision_failures,
            }

    def dashboard(self, signals: Optional[Dict[str, dict]] = None) -> dict:
        """The operator view ``GET /debug/fleet`` serves (through
        :meth:`~unionml_tpu_torch.serving.router.FleetRouter.fleet_report`,
        which passes its already-gathered ``signals`` so one dashboard
        call costs one fleet sweep, not three): the burn windows and
        usage headroom the next decision will read, plus the last
        decision and its reason. READ-ONLY and NON-BLOCKING for the
        decision loop — the headroom is computed against the stored
        counters without advancing them, the burn read is the
        watchdog's last evaluation, and any replica health sweep
        happens OUTSIDE ``_eval_lock`` (a wedged remote replica under
        the lock would stall the very evaluation the autoscaler
        exists to make)."""
        if self._slo is not None:
            burn = self._slo.burn_scores()
        else:
            # the replica-health fallback may touch the network —
            # never under the evaluation lock
            if signals is None:
                signals = self.router.replica_signals()
            pool = self._pool_signals(signals)
            replica_burn = max(
                (
                    float(s["health"].get("burn", 0.0) or 0.0)
                    for s in pool.values()
                ),
                default=0.0,
            )
            burn = {"fast": replica_burn, "slow": replica_burn}
        with self._eval_lock:
            headroom, traffic = 1.0, False
            if self._usage is not None:
                cap, used = self._usage.capacity_totals()
                d_cap = cap - self._last_cap
                d_used = used - self._last_used
                if d_cap > 0.0:
                    headroom = max(0.0, 1.0 - d_used / d_cap)
                    traffic = True
            return {
                # which pool this autoscaler operates (None = the
                # whole fleet — the single-pool view, unchanged)
                "phase": self.phase,
                "burn": burn,
                "burn_streak": self._burn_streak,
                "headroom": round(headroom, 4),
                "traffic_since_last_eval": traffic,
                "last_decision": dict(self._last_decision or {}),
                "provisioned": sorted(self._provisioned),
                "provision_failures": self._provision_failures,
                "policy": {
                    "min_replicas": self.policy.min_replicas,
                    "max_replicas": self.policy.max_replicas,
                    "headroom_out": self.policy.headroom_out,
                    "headroom_in": self.policy.headroom_in,
                },
            }

    def start(self, interval_s: float = 5.0) -> None:
        """Evaluate every ``interval_s`` on a daemon thread (the
        production loop; deterministic tests drive :meth:`evaluate`
        directly). Idempotent."""
        if self._ticker is not None and self._ticker.is_alive():
            return
        self._ticker_stop.clear()

        def tick():
            while not self._ticker_stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:
                    logger.info("autoscaler: evaluation failed", exc_info=True)

        self._ticker = threading.Thread(
            target=tick, daemon=True, name="unionml-tpu-autoscaler"
        )
        self._ticker.start()

    def stop(self) -> None:
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None

    def close(self) -> None:
        """Stop the ticker and release every replica this autoscaler
        provisioned (for teardown paths; the router keeps serving with
        whatever remains registered)."""
        self.stop()
        for name, handle in list(self._provisioned.items()):
            try:
                self.provisioner.release(handle)
            except BaseException:
                pass
            self._provisioned.pop(name, None)
