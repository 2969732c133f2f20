"""Zero-downtime model lifecycle: versioned rollouts with canary
pools, shadow traffic, and SLO-guarded auto-rollback.

The PyTorch port of :mod:`unionml_tpu_torch.serving.rollout`, with the same
decisions and the same closed reason vocabulary. The registry sits on
the port's checkpoints (:func:`~unionml_tpu_torch.checkpoint.async_writer
.is_committed`, :func:`~unionml_tpu_torch.checkpoint
.make_checkpoint_manager`); a canary that is reaped or rolled back is
released through its provisioner, and
:class:`~unionml_tpu_torch.serving.autoscaler.EngineReplicaProvisioner`
closes its :class:`~unionml_tpu_torch.serving.engine.DecodeEngine`, which
hands the card memory back.

Two pieces (docs/robustness.md "Rollouts & rollback"):

- :class:`VersionRegistry` — a versioned weight store backed by the
  checkpoint manager (:func:`~unionml_tpu_torch.checkpoint.make_checkpoint_
  manager`). A *version* is a committed checkpoint plus metadata: the
  commit-marker protocol means a torn or in-progress publish is simply
  not a version (refused exactly as ``restore`` refuses it), so the
  registry can never hand a rollout half-written weights.
- :class:`RolloutController` — choreographs a release end-to-end
  through the router's existing actuators. It owns no dispatch path of
  its own: canaries are provisioned through the same
  :class:`~unionml_tpu_torch.serving.autoscaler.ReplicaProvisioner` +
  warm-join donor machinery the autoscaler uses (canaries join
  cache-warm), traffic splits through the router's version-aware pick
  (percentage, per-tenant, or a hard ``X-Model-Version`` request pin),
  promotion is the existing drain → ``bind()`` → rejoin rolling
  restart, and abort/rollback drains ONLY canaries — live capacity is
  never touched by a failed rollout.

Shadow traffic: while a canary bakes, live requests are duplicated
onto it (dispatched directly on the canary handle from a dedicated
worker thread — never through the router envelope, so a shadow can
never consume the live retry budget, count toward live SLO burn, or
bill a live tenant). The engine decodes deterministically, so the
shadow's tokens are diffed **exactly** against the live answer: any
divergence is a real model-behavior delta, not sampling noise. A
wedged or dead canary degrades shadowing to *off* (flight
``rollout_hold{shadow_degraded}``) — never an error on the live path.

Control discipline is copied from the
:class:`~unionml_tpu_torch.serving.autoscaler.FleetAutoscaler`: one decision
per :meth:`~RolloutController.evaluate` tick, an injectable monotonic
clock (never wall time — an NTP step must not corrupt a bake window),
a CLOSED reason vocabulary (:data:`ROLLOUT_REASONS`, lint-enforced
against the docs), and hysteresis so one bad request cannot flap a
rollout. Every transition is reconstructible post-hoc from
``unionml_rollout_decisions_total{decision,reason}``, the flight ring,
the fleet timeline, and ``GET /debug/rollout``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.checkpoint.async_writer import is_committed
from unionml_tpu_torch.checkpoint import make_checkpoint_manager
from unionml_tpu_torch.serving.autoscaler import ReplicaProvisioner
from unionml_tpu_torch.serving.scheduler import (
    DEFAULT_MODEL_VERSION,
    current_model_version,
    model_version_scope,
    priority_scope,
    validate_model_version,
)
from unionml_tpu_torch.serving.usage import tenant_scope

logger = logging.getLogger("unionml_tpu_torch.serving")

# the tenant shadow dispatches bill to: live tenants must never pay
# for duplicate traffic, but the canary's ledger should still show
# where its load came from
SHADOW_TENANT = "rollout-shadow"

ROLLOUT_DECISIONS = ("rollout_advance", "rollout_hold", "rollout_rollback")

# CLOSED decision-reason vocabulary (docs/robustness.md "Rollout
# decision table"; scripts/lint_basics.py enforces the doc two-way).
# Every evaluate() tick and every operator call lands in exactly one
# (decision, reason) child of unionml_rollout_decisions_total, so the
# whole lifecycle is reconstructible from counters + flight events.
ROLLOUT_REASONS = (
    "operator",           # start()/promote()/abort() operator call
    "canary_join",        # one canary provisioned, warmed, and joined
    "canary_ready",       # canary pool complete → split + shadow open
    "baking",             # observation window running (steady hold)
    "hysteresis",         # bad signal, below the sustain streak
    "bake_complete",      # clean bake window → promotion begins
    "promote_replica",    # one live replica drained, rebound, rejoined
    "drain_timeout",      # a promote target would not drain/bind; held
    "reap_canary",        # one canary drained and released post-promote
    "complete",           # fleet live on the new version; rollout done
    "slo_burn",           # canary SLO burn over threshold → rollback
    "parity_regression",  # shadow divergence over tolerance → rollback
    "canary_dead",        # canary unreachable/ejected too long → rollback
    "shadow_degraded",    # shadowing switched off (wedged/dead canary)
    "provision_failed",   # canary provision/join raised; backoff set
    "provision_backoff",  # provisioning waits out the failure backoff
    "idle",               # no rollout in progress (steady hold)
)

# steady holds stay out of the flight ring and off the fleet timeline
# (a 1 s ticker would flush real request events in minutes); they still
# count in the decisions metric so the tick cadence is observable
_STEADY_REASONS = ("idle", "baking")

_SHADOW_RESULTS = ("match", "diverged", "error", "dropped")

_VERSION_META = "version.json"


class VersionRegistry:
    """Committed checkpoints + metadata as named model versions.

    Backed by a :func:`~unionml_tpu_torch.checkpoint.make_checkpoint_manager`
    store: :meth:`publish` writes the weights through the manager's
    crash-safe commit protocol (tmp dir → fsync'd ``_COMMITTED`` marker
    → atomic rename) and only then drops a ``version.json`` metadata
    sidecar inside the committed dir. :meth:`versions` lists committed
    steps ONLY — a torn or uncommitted dir is invisible, refused
    exactly as :meth:`~unionml_tpu_torch.checkpoint.async_writer
    .AsyncCheckpointManager.restore` refuses it — so a rollout can
    never pick up half-written weights.

    Version ids are validated by the same closed grammar as the
    ``X-Model-Version`` header (:func:`~unionml_tpu_torch.serving.scheduler
    .validate_model_version`); ``auto`` is reserved (the no-pin
    sentinel). A committed checkpoint saved outside :meth:`publish`
    (plain training flow) is still listed, under the derived id
    ``v<step>``.
    """

    def __init__(
        self,
        root: Union[str, Path],
        *,
        manager=None,
        max_versions: Optional[int] = None,
        backend: str = "auto",
    ):
        self.root = Path(root).absolute()
        self._manager = manager if manager is not None else (
            make_checkpoint_manager(
                self.root, max_to_keep=max_versions, backend=backend,
                async_commit=False,
            )
        )

    # -- write side --------------------------------------------------------

    def publish(
        self, version: str, state: Any, *,
        metadata: Optional[dict] = None,
    ) -> str:
        """Durably store ``state`` as ``version``; returns the id.

        The save is synchronous through the manager's commit barrier:
        when :meth:`publish` returns, the version is either fully
        committed and listed, or it never happened — there is no
        observable in-between for a rollout to race."""
        version = validate_model_version(version)
        if version == DEFAULT_MODEL_VERSION:
            raise ValueError(
                f"version id {DEFAULT_MODEL_VERSION!r} is reserved as the "
                "no-pin sentinel — pick a real id"
            )
        if version in self.versions():
            raise ValueError(f"version {version!r} already published")
        steps = self._committed_steps()
        step = (max(steps) if steps else 0) + 1
        self._manager.save(step, state)
        self._manager.wait()
        # metadata sidecar AFTER the commit barrier: a crash between
        # save and this write leaves a committed checkpoint under the
        # derived id, never a version pointing at torn weights. The
        # sidecar itself lands atomically (tmp + rename).
        meta_path = self.root / f"step_{step}" / _VERSION_META
        tmp = meta_path.with_name(_VERSION_META + ".tmp")
        tmp.write_text(json.dumps({
            "version": version, "step": step,
            "metadata": dict(metadata or {}),
        }))
        tmp.replace(meta_path)
        return version

    # -- read side ---------------------------------------------------------

    def _committed_steps(self) -> List[int]:
        steps = []
        for p in self.root.glob("step_*"):
            try:
                step = int(p.name[len("step_"):])
            except ValueError:
                continue  # step_N.tmp-* in-progress dirs
            if is_committed(p):
                steps.append(step)
        return sorted(steps)

    def versions(self) -> Dict[str, dict]:
        """``{version_id: {"step", "metadata"}}`` for every committed
        version, oldest step first. Torn/uncommitted dirs never
        appear."""
        out: Dict[str, dict] = {}
        for step in self._committed_steps():
            meta_path = self.root / f"step_{step}" / _VERSION_META
            vid, metadata = f"v{step}", {}
            if meta_path.exists():
                try:
                    doc = json.loads(meta_path.read_text())
                    vid = validate_model_version(doc.get("version"))
                    metadata = dict(doc.get("metadata") or {})
                except (ValueError, KeyError, TypeError):
                    # a corrupt sidecar degrades to the derived id —
                    # the weights themselves are commit-protected
                    vid, metadata = f"v{step}", {}
            out[vid] = {"step": step, "metadata": metadata}
        return out

    def latest(self) -> Optional[str]:
        """Newest published version id, or ``None`` when empty."""
        vid = None
        for vid in self.versions():
            pass
        return vid

    def resolve(self, version: str) -> dict:
        """The ``{"step", "metadata"}`` record behind ``version``;
        ``ValueError`` (the 422 class) for an id that names no
        committed version."""
        version = validate_model_version(version)
        info = self.versions().get(version)
        if info is None:
            raise ValueError(
                f"unknown model version {version!r} — published: "
                f"{sorted(self.versions())}"
            )
        return info

    def load(self, version: str, state_target: Any) -> Any:
        """Restore ``version``'s weights into ``state_target``'s
        structure. Rides the manager's restore path, so a torn dir
        (crash after the sidecar scan) still refuses to load."""
        info = self.resolve(version)
        return self._manager.restore(state_target, step=info["step"])

    def close(self) -> None:
        self._manager.close()


class RolloutPolicy:
    """Tunable thresholds for one :class:`RolloutController`.

    canary_replicas: canary pool size the provisioning stage builds.
    canary_percent: share (0–100) of *unpinned* traffic the router's
        version-aware pick steers to the canary version while baking.
    shadow / shadow_sample / shadow_queue: duplicate live requests
        onto the canary (all of them at ``shadow_sample=1.0``; the
        bounded queue drops — and counts — shadows under burst, it
        never blocks the live path).
    canary_burn_threshold: canary health-dict SLO burn score at or
        above which an evaluation counts as *bad*.
    divergence_tolerance: shadow divergences tolerated per evaluation
        window before the window counts as bad (0 = any divergence).
    sustain_evals: consecutive bad evaluations before auto-rollback —
        the hysteresis that stops one bad request flapping a rollout.
    bake_evals: consecutive clean evaluations before auto-promotion
        (``auto_promote=False`` holds at baked until operator
        :meth:`~RolloutController.promote`).
    canary_dead_evals: consecutive evaluations with an unreachable/
        ejected canary before rollback (its own hysteresis: a breaker
        blip must not kill a rollout).
    shadow_degrade_failures: consecutive shadow dispatch failures
        before shadowing degrades to off.
    warm_blocks: hot prefix blocks imported into a joining canary from
        the warmest live donor (0 = join cold). NOTE: donor KV was
        computed under the LIVE weights — warm joins are only
        parity-safe when the new version preserves KV semantics
        (republish / serving-config change); set 0 for a real weight
        change or the imported blocks will show up as shadow
        divergences.
    drain_timeout_s: per-replica drain budget during promote/reap.
    provision_backoff_s / provision_backoff_max_s: exponential retry
        schedule after a canary provision failure.
    name_prefix: canary replica names are
        ``{prefix}-{version}-{i}`` — the version is IN the name so
        flight events stay attributable after the pool is reaped.
    """

    def __init__(
        self,
        *,
        canary_replicas: int = 1,
        canary_percent: float = 5.0,
        shadow: bool = True,
        shadow_sample: float = 1.0,
        shadow_queue: int = 16,
        canary_burn_threshold: float = 1.0,
        divergence_tolerance: int = 0,
        sustain_evals: int = 2,
        bake_evals: int = 3,
        auto_promote: bool = True,
        canary_dead_evals: int = 2,
        shadow_degrade_failures: int = 3,
        warm_blocks: int = 64,
        drain_timeout_s: float = 30.0,
        provision_backoff_s: float = 1.0,
        provision_backoff_max_s: float = 30.0,
        name_prefix: str = "canary",
    ):
        if canary_replicas < 1:
            raise ValueError(
                f"canary_replicas must be >= 1, got {canary_replicas}"
            )
        if not 0.0 <= canary_percent <= 100.0:
            raise ValueError(
                f"canary_percent must be in [0, 100], got {canary_percent}"
            )
        if not 0.0 <= shadow_sample <= 1.0:
            raise ValueError(
                f"shadow_sample must be in [0, 1], got {shadow_sample}"
            )
        if shadow_queue < 1:
            raise ValueError(f"shadow_queue must be >= 1, got {shadow_queue}")
        if divergence_tolerance < 0:
            raise ValueError(
                "divergence_tolerance must be >= 0, got "
                f"{divergence_tolerance}"
            )
        for knob, lo in (
            ("sustain_evals", sustain_evals),
            ("bake_evals", bake_evals),
            ("canary_dead_evals", canary_dead_evals),
            ("shadow_degrade_failures", shadow_degrade_failures),
        ):
            if lo < 1:
                raise ValueError(f"{knob} must be >= 1, got {lo}")
        if warm_blocks < 0:
            raise ValueError(f"warm_blocks must be >= 0, got {warm_blocks}")
        self.canary_replicas = int(canary_replicas)
        self.canary_percent = float(canary_percent)
        self.shadow = bool(shadow)
        self.shadow_sample = float(shadow_sample)
        self.shadow_queue = int(shadow_queue)
        self.canary_burn_threshold = float(canary_burn_threshold)
        self.divergence_tolerance = int(divergence_tolerance)
        self.sustain_evals = int(sustain_evals)
        self.bake_evals = int(bake_evals)
        self.auto_promote = bool(auto_promote)
        self.canary_dead_evals = int(canary_dead_evals)
        self.shadow_degrade_failures = int(shadow_degrade_failures)
        self.warm_blocks = int(warm_blocks)
        self.drain_timeout_s = float(drain_timeout_s)
        self.provision_backoff_s = float(provision_backoff_s)
        self.provision_backoff_max_s = float(provision_backoff_max_s)
        self.name_prefix = str(name_prefix)


class RolloutController:
    """One release at a time, one decision per tick.

    Stages: ``idle`` → :meth:`start` → ``provisioning`` (one canary
    provisioned + warm-joined per tick) → ``baking`` (traffic split +
    shadow diffing, burn/parity watched under hysteresis) → ``promoting``
    (one live replica per tick: drain → ``bind()`` → rejoin; then
    canaries reaped one per tick) → ``idle``. :meth:`abort` — or an
    auto-rollback on SLO burn / parity regression / dead canary —
    drains ONLY canaries (and, mid-promote, restores already-promoted
    replicas to the old weights); live capacity is never collateral.

    Mirrors the autoscaler's control discipline: ``evaluate(now=...)``
    with an injectable monotonic clock for deterministic tests,
    :meth:`start`/:meth:`stop` for a wall-thread ticker in production,
    and every decision recorded to
    ``unionml_rollout_decisions_total{decision,reason}`` + the flight
    ring + the router's fleet timeline.
    """

    def __init__(
        self,
        router,
        provisioner: ReplicaProvisioner,
        versions: VersionRegistry,
        *,
        policy: Optional[RolloutPolicy] = None,
        params_loader: Optional[Callable[[str], Any]] = None,
        state_target: Any = None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        flight: Optional[telemetry.FlightRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.router = router
        self.provisioner = provisioner
        self.versions = versions
        self.policy = policy if policy is not None else RolloutPolicy()
        self._loader = params_loader
        self._state_target = state_target
        self._clock = clock
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._flight = (
            flight if flight is not None else telemetry.get_flight_recorder()
        )
        self._eval_lock = threading.RLock()
        self._stage = "idle"
        self._version: Optional[str] = None
        self._params: Any = None
        self._canaries: Dict[str, Any] = {}
        # promoted live replicas keep their OLD weights on file so an
        # abort mid-promote can walk the fleet back, not just forward
        self._promoted: Dict[str, dict] = {}
        self._next_id = 0
        self._provision_failures = 0
        self._provision_retry_at = float("-inf")
        self._bad_streak = 0
        self._clean_evals = 0
        self._dead_streak = 0
        self._last_decision: Optional[dict] = None
        self._history: deque = deque(maxlen=128)
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        # shadow lane state (worker thread + bounded queue)
        self._shadow_on = False
        self._shadow_degraded = False
        self._shadow_degrade_pending = False
        self._shadow_lock = threading.Lock()
        self._shadow_q: deque = deque()
        self._shadow_wake = threading.Event()
        self._shadow_stop = threading.Event()
        self._shadow_worker: Optional[threading.Thread] = None
        self._shadow_rr = 0
        self._sample_n = 0
        self._shadow_failures = 0
        self._shadow_stats = {r: 0 for r in _SHADOW_RESULTS}
        self._diverged_acked = 0
        # GET /debug/rollout and fleet_report read the controller
        # through this link (the autoscaler registration pattern)
        router.rollout = self
        R = self._registry
        self._m_decisions = R.counter(
            "unionml_rollout_decisions_total",
            "Rollout decisions by kind and (closed-set) reason — every "
            "evaluation and operator call lands in exactly one child, "
            "so a release is reconstructible from counters alone.",
            ("decision", "reason"),
        )
        self._m_shadow = R.counter(
            "unionml_rollout_shadow_requests_total",
            "Shadow dispatches onto the canary by outcome (match / "
            "diverged / error / dropped) — deterministic decode makes "
            "'diverged' a real model-behavior delta, not noise.",
            ("result",),
        )
        self._g_canaries = R.gauge(
            "unionml_rollout_canary_replicas",
            "Canary replicas currently joined to the router for the "
            "in-flight rollout (0 when idle — a nonzero value after "
            "rollback means a reap failed).",
        )

    # -- operator API ------------------------------------------------------

    def start_rollout(
        self,
        version: str,
        *,
        percent: Optional[float] = None,
        pin_tenants: Optional[Dict[str, str]] = None,
    ) -> dict:
        """Begin rolling ``version`` out. Fails fast — the version is
        resolved and its weights LOADED before any fleet mutation, so
        a torn checkpoint or unknown id can never strand a half-built
        canary pool."""
        with self._eval_lock:
            if self._stage != "idle":
                raise ValueError(
                    f"a rollout of {self._version!r} is already "
                    f"{self._stage} — abort() it first"
                )
            version = validate_model_version(version)
            self.versions.resolve(version)   # unknown id → ValueError/422
            self._params = self._load_params(version)
            self._version = version
            self._stage = "provisioning"
            self._next_id = 0
            self._provision_failures = 0
            self._provision_retry_at = float("-inf")
            self._bad_streak = self._clean_evals = self._dead_streak = 0
            self._percent = (
                self.policy.canary_percent if percent is None
                else float(percent)
            )
            self._pin_tenants = {
                tenant: validate_model_version(v)
                for tenant, v in (pin_tenants or {}).items()
            }
            self._shadow_degraded = False
            self._shadow_failures = 0
            return self._record("rollout_advance", "operator", {
                "stage": "provisioning", "version": version,
            })

    def promote(self) -> dict:
        """Operator-forced promotion (skips the remaining bake)."""
        with self._eval_lock:
            if self._stage != "baking":
                raise ValueError(
                    f"nothing to promote: rollout stage is {self._stage!r}"
                )
            self._stage = "promoting"
            self._disable_shadow()
            return self._record("rollout_advance", "operator", {
                "stage": "promoting", "version": self._version,
            })

    def abort(self) -> dict:
        """Operator abort: drain canaries (and walk back any promoted
        replicas), never touch live capacity."""
        with self._eval_lock:
            if self._stage == "idle":
                raise ValueError("no rollout in progress")
            return self._rollback("operator", {"stage": self._stage})

    # -- weights -----------------------------------------------------------

    def _load_params(self, version: str):
        if self._loader is not None:
            return self._loader(version)
        if self._state_target is not None:
            return self.versions.load(version, self._state_target)
        raise ValueError(
            "RolloutController cannot load version weights: pass "
            "params_loader= (version id -> params) or state_target= "
            "(the restore structure) at construction"
        )

    @staticmethod
    def _bind_version(handle, params, version: str) -> None:
        """Point one replica at ``version``'s weights. For an engine-
        backed handle the engine itself rebinds — its busy guard
        refuses to swap under in-flight work, and the swap drops the
        old weights' KV (prefix cache + device splice memo) so stale
        blocks can never serve the new tree."""
        engine = getattr(handle, "engine", None)
        if engine is not None:
            engine.bind(params)
            engine.model_version = version
        if hasattr(handle, "params"):
            handle.params = params
        handle.version = version

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One decision per call; deterministic tests pass ``now``."""
        with self._eval_lock:
            return self._evaluate_locked(
                self._clock() if now is None else float(now)
            )

    def _evaluate_locked(self, now: float) -> dict:
        self._g_canaries.set(float(len(self._canaries)))
        if self._stage == "idle":
            return self._record("rollout_hold", "idle", {})
        detail = {"stage": self._stage, "version": self._version}
        if self._shadow_degrade_pending:
            # the shadow worker latched a degrade (wedged/dead canary):
            # surface it as THIS tick's decision so the flight ring
            # shows rollout_hold{shadow_degraded} exactly once
            self._shadow_degrade_pending = False
            return self._record("rollout_hold", "shadow_degraded", {
                **detail, "shadow_failures": self._shadow_failures,
            })
        signals = self.router.replica_signals()
        if self._stage == "provisioning":
            return self._provision_step(now, signals, detail)
        if self._stage == "baking":
            return self._bake_step(now, signals, detail)
        if self._stage == "promoting":
            return self._promote_step(now, signals, detail)
        raise AssertionError(f"unknown rollout stage {self._stage!r}")

    # -- stage: provisioning ----------------------------------------------

    def _provision_step(self, now, signals, detail) -> dict:
        p = self.policy
        if now < self._provision_retry_at:
            return self._record("rollout_hold", "provision_backoff", {
                **detail,
                "retry_in_s": round(self._provision_retry_at - now, 3),
            })
        name = f"{p.name_prefix}-{self._version}-{self._next_id}"
        try:
            handle = self.provisioner.provision(name)
        except BaseException as exc:
            return self._provision_failed(now, name, exc, detail)
        self._next_id += 1
        try:
            # bind BEFORE warming: bind() clears any factory-time
            # prefix cache, so imports after it survive
            self._bind_version(handle, self._params, self._version)
        except BaseException as exc:
            self._release(handle)
            return self._provision_failed(now, name, exc, detail)
        # fleet-warm the canary from the warmest LIVE donor (the
        # autoscaler's donor ranking: most resident cache blocks).
        # Best-effort — a failed warm joins cold, never blocks the join.
        imported, donor_name = 0, None
        live = {
            n: s for n, s in signals.items() if n not in self._canaries
        }
        if p.warm_blocks > 0 and live:
            donor_name = max(
                live, key=lambda n: (live[n]["cache_blocks"], n),
            )
            if live[donor_name]["cache_blocks"] <= 0:
                donor_name = None
        if donor_name is not None:
            try:
                donor = self.router.replica_handle(donor_name)
                entries = donor.export_hot_blocks(max_blocks=p.warm_blocks)
                imported = int(handle.import_cache_blocks(entries))
            except BaseException as exc:
                logger.info(
                    f"rollout: warm-join of {name} from {donor_name} "
                    f"failed ({exc!r}); canary joins cold"
                )
                imported = 0
        try:
            self.router.add_replica(handle)
        except BaseException as exc:
            self._release(handle)
            return self._provision_failed(now, name, exc, detail)
        self._provision_failures = 0
        self._provision_retry_at = float("-inf")
        self._canaries[name] = handle
        self._g_canaries.set(float(len(self._canaries)))
        if len(self._canaries) < p.canary_replicas:
            return self._record("rollout_advance", "canary_join", {
                **detail, "replica": name, "warmed_blocks": imported,
                "pool": len(self._canaries),
            })
        # pool complete: open the traffic split and the shadow lane
        self._stage = "baking"
        self.router.set_version_split(
            self._version, percent=self._percent,
            tenants=self._pin_tenants,
        )
        if p.shadow:
            self._enable_shadow()
        return self._record("rollout_advance", "canary_ready", {
            **detail, "stage": "baking", "replica": name,
            "warmed_blocks": imported, "pool": len(self._canaries),
            "percent": self._percent,
        })

    def _provision_failed(self, now, name, exc, detail) -> dict:
        p = self.policy
        self._provision_failures += 1
        backoff = min(
            p.provision_backoff_s * (2 ** (self._provision_failures - 1)),
            p.provision_backoff_max_s,
        )
        self._provision_retry_at = now + backoff
        logger.info(
            f"rollout: provision {name} failed ({exc!r}); retrying in "
            f"{backoff:.1f}s"
        )
        return self._record("rollout_hold", "provision_failed", {
            **detail, "replica": name,
            "error": f"{type(exc).__name__}: {exc}",
            "retry_in_s": round(backoff, 3),
        })

    # -- stage: baking -----------------------------------------------------

    def _bake_step(self, now, signals, detail) -> dict:
        p = self.policy
        dead = [
            n for n in self._canaries
            if n not in signals
            or signals[n]["state"] == "ejected"
            or signals[n]["health"].get("status") == "unreachable"
        ]
        if dead:
            self._dead_streak += 1
            self._clean_evals = 0
            # a canary the router can't reach can't serve shadows
            # either: degrade shadowing NOW (the worker would only
            # burn its failure budget finding out the hard way)
            if self._shadow_on:
                self._disable_shadow(degraded=True)
            if self._dead_streak >= p.canary_dead_evals:
                return self._rollback("canary_dead", {
                    **detail, "dead": dead, "evals": self._dead_streak,
                })
            return self._record("rollout_hold", "hysteresis", {
                **detail, "signal": "canary_dead", "dead": dead,
                "streak": self._dead_streak,
            })
        self._dead_streak = 0
        burn = max(
            (
                float(signals[n]["health"].get("burn", 0.0) or 0.0)
                for n in self._canaries
            ),
            default=0.0,
        )
        diverged_total = self._shadow_stats["diverged"]
        new_divergences = diverged_total - self._diverged_acked
        self._diverged_acked = diverged_total
        parity_bad = new_divergences > p.divergence_tolerance
        burn_bad = burn >= p.canary_burn_threshold
        if parity_bad or burn_bad:
            self._bad_streak += 1
            self._clean_evals = 0
            reason = "parity_regression" if parity_bad else "slo_burn"
            signal = {
                **detail, "burn": round(burn, 4),
                "divergences": new_divergences,
                "streak": self._bad_streak,
            }
            if self._bad_streak >= p.sustain_evals:
                return self._rollback(reason, signal)
            return self._record("rollout_hold", "hysteresis", {
                **signal, "signal": reason,
            })
        self._bad_streak = 0
        self._clean_evals += 1
        if self._clean_evals >= p.bake_evals and p.auto_promote:
            self._stage = "promoting"
            self._disable_shadow()
            return self._record("rollout_advance", "bake_complete", {
                **detail, "stage": "promoting",
                "clean_evals": self._clean_evals,
                "shadow": dict(self._shadow_stats),
            })
        return self._record("rollout_hold", "baking", {
            **detail, "clean_evals": self._clean_evals,
            "burn": round(burn, 4),
        })

    # -- stage: promoting --------------------------------------------------

    def _promote_step(self, now, signals, detail) -> dict:
        p = self.policy
        targets = sorted(
            n for n, s in signals.items()
            if n not in self._canaries
            and n not in self._promoted
            and getattr(
                self.router.replica_handle(n), "version", None
            ) != self._version
        )
        if targets:
            # one replica per tick: capacity dips by exactly one
            # replica at a time, and every step is a flight event
            name = targets[0]
            handle = self.router.replica_handle(name)
            old = {
                "params": getattr(handle, "params", None),
                "version": getattr(handle, "version", None),
            }
            if not self.router.drain_replica(name, timeout=p.drain_timeout_s):
                self.router.rejoin_replica(name)
                return self._record("rollout_hold", "drain_timeout", {
                    **detail, "replica": name,
                })
            try:
                self._bind_version(handle, self._params, self._version)
            except BaseException as exc:
                # bind's busy guard held (e.g. a preempted stream in
                # evict→resume limbo): the replica rejoins on the OLD
                # weights — correct, just not promoted yet
                self.router.rejoin_replica(name)
                return self._record("rollout_hold", "drain_timeout", {
                    **detail, "replica": name,
                    "error": f"{type(exc).__name__}: {exc}",
                })
            self.router.rejoin_replica(name)
            self._promoted[name] = old
            return self._record("rollout_advance", "promote_replica", {
                **detail, "replica": name,
                "remaining": len(targets) - 1,
            })
        if self._canaries:
            # all live replicas serve the new version: the split has
            # nothing left to split — retire it, then reap canaries
            # one per tick through the normal drain path
            self.router.clear_version_split()
            name = sorted(self._canaries)[0]
            self._reap_canary(name)
            return self._record("rollout_advance", "reap_canary", {
                **detail, "replica": name,
                "remaining": len(self._canaries),
            })
        version = self._version
        self.router.live_version = version
        self.router.clear_version_split()
        self._reset()
        return self._record("rollout_advance", "complete", {
            "version": version,
        })

    # -- rollback ----------------------------------------------------------

    def _rollback(self, reason: str, detail: dict) -> dict:
        """Tear the rollout down WITHOUT touching live capacity:
        shadow off, split cleared, canaries drained + released, and —
        mid-promote — already-promoted replicas walked back to the old
        weights through the same drain → bind → rejoin step."""
        self._disable_shadow()
        self.router.clear_version_split()
        restored, stuck = [], []
        for name, old in sorted(self._promoted.items()):
            try:
                handle = self.router.replica_handle(name)
                if not self.router.drain_replica(
                    name, timeout=self.policy.drain_timeout_s
                ):
                    raise RuntimeError("drain timed out")
                self._bind_version(
                    handle, old["params"],
                    old["version"] or self.router.live_version
                    or DEFAULT_MODEL_VERSION,
                )
                # an unversioned pre-rollout replica goes back to
                # carrying the fleet's implicit live version
                handle.version = old["version"]
                restored.append(name)
            except BaseException as exc:
                # degrade, don't wedge: the replica keeps serving the
                # NEW weights (it is healthy — the rollback was about
                # the canaries); the operator sees it in the detail
                stuck.append(name)
                logger.warning(
                    f"rollout: rollback could not restore {name} "
                    f"({exc!r}); it stays on {self._version}"
                )
            finally:
                try:
                    self.router.rejoin_replica(name)
                except BaseException:
                    pass
        reaped = [
            name for name in sorted(self._canaries)
            if self._reap_canary(name)
        ]
        version = self._version
        self._reset()
        out = {
            "version": version, **detail, "reaped": reaped,
        }
        if restored:
            out["restored"] = restored
        if stuck:
            out["stuck_on_new"] = stuck
        return self._record("rollout_rollback", reason, out)

    def _reap_canary(self, name: str) -> bool:
        handle = self._canaries.pop(name, None)
        self._g_canaries.set(float(len(self._canaries)))
        try:
            self.router.remove_replica(
                name, drain_timeout=self.policy.drain_timeout_s
            )
        except BaseException as exc:
            logger.warning(f"rollout: reap of {name} failed ({exc!r})")
        self._release(handle)
        return True

    def _release(self, handle) -> None:
        if handle is None:
            return
        try:
            self.provisioner.release(handle)
        except BaseException:
            pass

    def _reset(self) -> None:
        self._stage = "idle"
        self._version = None
        self._params = None
        self._canaries = {}
        self._promoted = {}
        self._bad_streak = self._clean_evals = self._dead_streak = 0
        self._g_canaries.set(0.0)

    # -- recording ---------------------------------------------------------

    def _record(self, decision: str, reason: str, detail: dict) -> dict:
        self._m_decisions.labels(decision, reason).inc()
        out = {"decision": decision, "reason": reason, **detail}
        self._last_decision = out
        if reason not in _STEADY_REASONS:
            self._history.append(out)
            self._flight.record(decision, reason=reason, **detail)
            # the fleet timeline: a latency spike and the rollout
            # decision around it sit on one trace axis
            self.router.trace_event(decision, reason=reason, **detail)
        return out

    # -- shadow lane -------------------------------------------------------

    def _enable_shadow(self) -> None:
        if self._shadow_on or self._shadow_degraded:
            return
        self._shadow_on = True
        self._shadow_stop.clear()
        if self._shadow_worker is None or not self._shadow_worker.is_alive():
            self._shadow_worker = threading.Thread(
                target=self._shadow_loop, name="rollout-shadow", daemon=True,
            )
            self._shadow_worker.start()

    def _disable_shadow(self, *, degraded: bool = False) -> None:
        was_on = self._shadow_on
        self._shadow_on = False
        self._shadow_stop.set()
        self._shadow_wake.set()
        with self._shadow_lock:
            dropped = len(self._shadow_q)
            self._shadow_q.clear()
        if dropped:
            self._shadow_stats["dropped"] += dropped
            self._m_shadow.labels("dropped").inc(dropped)
        if degraded and was_on and not self._shadow_degraded:
            self._shadow_degraded = True
            # surfaced as the next tick's rollout_hold{shadow_degraded}
            self._shadow_degrade_pending = True

    def observe_live(
        self, *, rid: str, replica: str, prompt: Sequence[int],
        max_new_tokens: Optional[int], tokens: List[int],
    ) -> None:
        """The router's post-success hook: enqueue one completed LIVE
        request for shadow dispatch onto the canary. Free-rider by
        construction — called after the live answer is fully emitted,
        never blocks (bounded queue, drop + count under burst), never
        raises into the dispatch path."""
        if not self._shadow_on or self._stage != "baking":
            return
        if replica in self._canaries:
            return   # canary-served requests have nothing to diff against
        p = self.policy
        with self._shadow_lock:
            if p.shadow_sample < 1.0:
                # deterministic stride sampling — no RNG, no wall
                # clock: every round(1/rate)-th live request shadows
                self._sample_n += 1
                stride = max(1, int(round(1.0 / p.shadow_sample)))
                if self._sample_n % stride:
                    return
            if len(self._shadow_q) >= p.shadow_queue:
                self._shadow_stats["dropped"] += 1
                self._m_shadow.labels("dropped").inc()
                return
            self._shadow_q.append((
                rid, list(prompt), max_new_tokens, list(tokens),
                telemetry.current_trace_context(),
            ))
        self._shadow_wake.set()

    def _shadow_loop(self) -> None:
        while not self._shadow_stop.is_set():
            self._shadow_wake.wait(timeout=0.2)
            while True:
                with self._shadow_lock:
                    if not self._shadow_q:
                        self._shadow_wake.clear()
                        break
                    item = self._shadow_q.popleft()
                try:
                    self._shadow_one(*item)
                except BaseException:
                    pass   # the loop itself must never die

    def _shadow_one(self, rid, prompt, max_new_tokens, live_tokens, ctx):
        canaries = list(self._canaries.items())
        if not canaries or not self._shadow_on:
            return
        name, handle = canaries[self._shadow_rr % len(canaries)]
        self._shadow_rr += 1
        tracer = self.router.tracer
        shadow_rid = None
        t0 = time.perf_counter()
        try:
            # the shadow runs in the LIVE request's trace (one stitched
            # GET /debug/trace?rid=<live rid> shows both), but under
            # its own tenant + low priority: the canary's ledger shows
            # where the load came from, live tenants are never billed,
            # and on a colocated host a shadow can never preempt live
            # work. The worker thread carries NO ambient deadline —
            # a burned live deadline must not fail the shadow.
            scope = (
                telemetry.trace_scope(ctx) if ctx is not None
                else model_version_scope(None)   # no-op context
            )
            with scope, tenant_scope(SHADOW_TENANT), priority_scope("low"):
                if tracer is not None:
                    shadow_rid = tracer.new_request(
                        "shadow", live_rid=rid, replica=name,
                        version=self._version,
                    )
                tokens = handle.generate(
                    prompt, max_new_tokens=max_new_tokens
                )
            t1 = time.perf_counter()
            result = "match" if list(tokens) == live_tokens else "diverged"
            if tracer is not None and shadow_rid is not None:
                tracer.record_span(
                    shadow_rid, "shadow", t0, t1, replica=name,
                    version=self._version, result=result,
                    live_rid=rid, shadow_tokens=len(tokens),
                )
            if result == "diverged":
                first = next(
                    (
                        i for i, (a, b) in enumerate(zip(tokens, live_tokens))
                        if a != b
                    ),
                    min(len(tokens), len(live_tokens)),
                )
                self._flight.record(
                    "rollout_shadow", rid=rid, replica=name,
                    version=self._version, result="diverged",
                    first_diff=first, live_tokens=len(live_tokens),
                    shadow_tokens=len(tokens),
                )
            self._shadow_stats[result] += 1
            self._m_shadow.labels(result).inc()
            self._shadow_failures = 0
        except BaseException as exc:
            self._shadow_stats["error"] += 1
            self._m_shadow.labels("error").inc()
            self._shadow_failures += 1
            logger.info(
                f"rollout: shadow dispatch to {name} failed ({exc!r}) "
                f"[{self._shadow_failures}/"
                f"{self.policy.shadow_degrade_failures}]"
            )
            if tracer is not None and shadow_rid is not None:
                tracer.record_span(
                    shadow_rid, "shadow", t0, time.perf_counter(),
                    replica=name, version=self._version, result="error",
                    error=type(exc).__name__, live_rid=rid,
                )
            if self._shadow_failures >= self.policy.shadow_degrade_failures:
                # a wedged/dead canary degrades shadowing to OFF —
                # never an error on the live path
                self._disable_shadow(degraded=True)
        finally:
            if tracer is not None and shadow_rid is not None:
                tracer.finish_request(shadow_rid)

    # -- observability -----------------------------------------------------

    def dashboard(self) -> dict:
        """The ``GET /debug/rollout`` body (also embedded in
        ``fleet_report()``): read-only, never blocks dispatch."""
        return {
            "stage": self._stage,
            "version": self._version,
            "live_version": getattr(self.router, "live_version", None),
            "canaries": sorted(self._canaries),
            "promoted": sorted(self._promoted),
            "split": getattr(self.router, "version_split", lambda: None)(),
            "shadow": {
                "on": self._shadow_on,
                "degraded": self._shadow_degraded,
                "queued": len(self._shadow_q),
                **dict(self._shadow_stats),
            },
            "streaks": {
                "bad": self._bad_streak,
                "clean": self._clean_evals,
                "dead": self._dead_streak,
            },
            "last_decision": self._last_decision,
            "history": list(self._history),
            "versions": {
                vid: info["metadata"]
                for vid, info in self.versions.versions().items()
            },
            "policy": {
                "canary_replicas": self.policy.canary_replicas,
                "canary_percent": self.policy.canary_percent,
                "bake_evals": self.policy.bake_evals,
                "sustain_evals": self.policy.sustain_evals,
            },
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        """Run :meth:`evaluate` on a daemon ticker (production mode;
        tests drive ``evaluate(now=...)`` directly)."""
        if self._ticker is not None:
            return
        self._ticker_stop.clear()

        def _tick():
            while not self._ticker_stop.wait(interval_s):
                try:
                    self.evaluate()
                except BaseException:
                    logger.exception("rollout: evaluate failed")

        self._ticker = threading.Thread(
            target=_tick, name="rollout-ticker", daemon=True,
        )
        self._ticker.start()

    def stop(self) -> None:
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5.0)
            self._ticker = None

    def close(self) -> None:
        self.stop()
        self._disable_shadow()
        if self._shadow_worker is not None:
            self._shadow_worker.join(timeout=5.0)
            self._shadow_worker = None


__all__ = [
    "DEFAULT_MODEL_VERSION",
    "ROLLOUT_DECISIONS",
    "ROLLOUT_REASONS",
    "RolloutController",
    "RolloutPolicy",
    "SHADOW_TENANT",
    "VersionRegistry",
    "current_model_version",
    "model_version_scope",
    "validate_model_version",
]
