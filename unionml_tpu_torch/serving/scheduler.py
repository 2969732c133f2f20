"""Preemptive, priority-aware scheduling on the paged KV pool.

ROADMAP item 3: before this module, pool exhaustion PARKED admissions
in a single FIFO slot and the flight recorder merely *named* a
``preempt_candidate`` without acting on it — one bulk tenant could
stall every other caller behind a full pool. This module makes the
engine act under pressure instead of queueing (vLLM/PagedAttention
preemption-by-eviction + Sarathi-Serve stall-free mixing lineage):

- **Priority classes** (:data:`PRIORITIES` — ``high`` / ``normal`` /
  ``low``): every request carries one, set by the ``X-Priority``
  header on all three transports (validated like ``X-Tenant-ID`` —
  closed value set, 422 on garbage, echoed on responses, carried by
  :class:`~unionml_tpu_torch.serving.router.HttpReplica` across the router
  hop) or the ``priority=`` argument of
  :meth:`~unionml_tpu_torch.serving.engine.DecodeEngine.generate`.
- **A real waiting room** (:class:`WaitingRoom`) replacing the
  engine's single internal FIFO + one-request park slot: per-priority,
  per-tenant queues drained by **deficit-weighted round robin**.
  Classes share admission throughput by :attr:`SchedulerConfig
  .class_weights` under stride scheduling (smallest virtual pass
  serves, advancing by cost/weight), so a backlogged ``low`` class is
  starvation-BOUNDED, not starved: it receives exactly
  ``w_low / Σw`` of admitted token throughput — docs/robustness.md
  "Preemption & fairness" derives the bound. Within a class, tenants
  take turns under DRR where each tenant's refill quantum is scaled by
  its :meth:`~unionml_tpu_torch.serving.usage.UsageLedger.fair_share` — a
  tenant that already consumed most of the device gets a smaller
  quantum, so a bulk tenant cannot crowd out its class's light users.
- **Preemption policy** (:meth:`PreemptiveScheduler.select_victim`):
  when a reservation parks on pool exhaustion and a strictly
  lower-priority resident exists, the engine evicts that victim's KV
  blocks to the host prefix-cache block store (pool and cache share
  one block unit — eviction is the existing extract path, resume the
  existing splice path: pointer swaps, not recompute) and re-admits it
  later with exact token parity. Victims: lowest priority class
  first, most recently admitted within the class (LIFO — the
  longest-running streams, closest to completion, are spared), and
  only streams whose resume prompt still fits an admission bucket.
- **Stall-free mixing**: :attr:`SchedulerConfig.mix_prefill_tokens`
  is the Sarathi-style token budget of lead prefill-chunk work the
  dispatcher interleaves into each pass between decode chunks, so a
  long prompt admits faster without stalling the decode lane (chunked
  prefill already existed; this is the knob the scheduler never had).

Telemetry: ``unionml_preemptions_total{engine,cause}`` counts evictions
by cause, ``unionml_sched_waiting_depth{engine,priority}`` gauges the
waiting room per class, and the flight recorder gains ``preempt`` /
``resume`` / ``promote`` lifecycle events (docs/observability.md).

Thread-safety: :class:`WaitingRoom` has its own lock (submitters,
the dispatcher, and the harvester's resume requeue all touch it);
:class:`PreemptiveScheduler` is a thin facade the engine drives.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from unionml_tpu_torch import telemetry

__all__ = [
    "DEFAULT_MODEL_VERSION",
    "DEFAULT_PHASE",
    "DEFAULT_PRIORITY",
    "PHASES",
    "PRIORITIES",
    "PreemptiveScheduler",
    "SchedulerConfig",
    "WaitingRoom",
    "current_model_version",
    "current_priority",
    "current_token_cap",
    "model_version_scope",
    "priority_scope",
    "token_cap_scope",
    "validate_model_version",
    "validate_phase",
    "validate_priority",
    "validate_token_cap",
]

# CLOSED value set (metric-label-safe, like usage.DROP_CAUSES): the
# transports validate against it so a hostile X-Priority can never
# reach the scheduler as an unknown class
PRIORITIES = ("high", "normal", "low")
DEFAULT_PRIORITY = "normal"
_RANK = {p: i for i, p in enumerate(PRIORITIES)}  # 0 = most urgent

# preemption causes are a closed set too (the
# unionml_preemptions_total{cause} label): "priority" = a
# higher-priority waiter displaced a lower-priority resident
PREEMPT_CAUSES = ("priority",)

# serving PHASES (docs/serving.md "Disaggregated serving"): which half
# of a generative request an engine pool owns. ``colocated`` (the
# default) serves both — the historical single-pool architecture; a
# phase-split fleet runs ``prefill`` engines (prompt prefill + KV
# export, DistServe/Splitwise lineage) and ``decode`` engines (KV
# splice + token streaming) behind one phase-aware router. A CLOSED
# set like PRIORITIES: phase rides metric labels, flight-event tags,
# and the fleet dashboard, so the value space must stay enumerable.
PHASES = ("prefill", "decode", "colocated")
DEFAULT_PHASE = "colocated"


def validate_phase(value: Optional[str]) -> str:
    """Normalize an engine/replica ``phase``: ``None``/empty →
    :data:`DEFAULT_PHASE`; anything outside :data:`PHASES` raises
    ``ValueError`` — the set is closed (label- and dashboard-safe)."""
    if value is None or value == "":
        return DEFAULT_PHASE
    phase = str(value).lower()
    if phase not in PHASES:
        raise ValueError(
            f"unknown serving phase {value!r}: must be one of "
            f"{'/'.join(PHASES)}"
        )
    return phase


def validate_priority(value: Optional[str]) -> str:
    """Normalize an ``X-Priority`` header / ``priority=`` argument:
    ``None``/empty → :data:`DEFAULT_PRIORITY`; anything outside
    :data:`PRIORITIES` (case-insensitive) raises ``ValueError`` (the
    transports map it to 422) — mirroring
    :func:`~unionml_tpu_torch.serving.usage.validate_tenant`: a hostile
    header is rejected at the boundary, never minted into scheduler
    state or a label value."""
    if value is None or value == "":
        return DEFAULT_PRIORITY
    priority = str(value).lower()
    if priority not in PRIORITIES:
        raise ValueError(
            f"unknown priority {value!r}: X-Priority must be one of "
            f"{'/'.join(PRIORITIES)}"
        )
    return priority


def priority_rank(priority: str) -> int:
    """Class rank, 0 = most urgent (validated input assumed)."""
    return _RANK[priority]


_priority_tls = threading.local()


@contextmanager
def priority_scope(priority: Optional[str]) -> Iterator[None]:
    """Expose ``priority`` to engine submissions on this thread
    (``None`` leaves any outer scope visible) — the same thread-local
    plumbing as :func:`~unionml_tpu_torch.serving.usage.tenant_scope`; the
    transports open it around the predictor call from ``X-Priority``."""
    if priority is None:
        yield
        return
    prev = getattr(_priority_tls, "priority", None)
    _priority_tls.priority = priority
    try:
        yield
    finally:
        _priority_tls.priority = prev


def current_priority() -> str:
    """The innermost :func:`priority_scope` value on this thread, else
    :data:`DEFAULT_PRIORITY`."""
    priority = getattr(_priority_tls, "priority", None)
    return priority if priority else DEFAULT_PRIORITY


# model-version request pinning (docs/robustness.md "Rollouts &
# rollback"): the ``X-Model-Version`` header vocabulary. Unlike
# PRIORITIES the value space is registry versions, not a static enum,
# so the boundary validates a closed GRAMMAR (label-safe slug, bounded
# length) and the router's version-aware pick rejects ids that name no
# registered version. ``auto`` is the no-pin sentinel: the request
# follows the fleet's live/canary split.
DEFAULT_MODEL_VERSION = "auto"
MAX_MODEL_VERSION_LEN = 64
_MODEL_VERSION_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyz0123456789._-"
)


def validate_model_version(value: Optional[str]) -> str:
    """Normalize an ``X-Model-Version`` header: ``None``/empty →
    :data:`DEFAULT_MODEL_VERSION` (no pin); anything else must be a
    label-safe slug — lowercase alphanumerics plus ``._-``, leading
    alphanumeric, at most :data:`MAX_MODEL_VERSION_LEN` chars — or
    ``ValueError`` (→ 422). Grammar-closed like
    :func:`~unionml_tpu_torch.serving.usage.validate_tenant`: a hostile
    header is rejected at the boundary, never minted into a metric
    label or flight-event field; whether the id names a *registered*
    version is the router pick's check, because only the fleet knows
    its registry."""
    if value is None or value == "":
        return DEFAULT_MODEL_VERSION
    version = str(value).lower()
    if len(version) > MAX_MODEL_VERSION_LEN:
        raise ValueError(
            f"model version too long ({len(version)} chars, max "
            f"{MAX_MODEL_VERSION_LEN})"
        )
    if not version[0].isalnum() or not all(
        c in _MODEL_VERSION_OK for c in version
    ):
        raise ValueError(
            f"invalid model version {value!r}: X-Model-Version must be "
            "a slug of [a-z0-9._-] starting alphanumeric"
        )
    return version


_model_version_tls = threading.local()


@contextmanager
def model_version_scope(version: Optional[str]) -> Iterator[None]:
    """Expose a validated ``X-Model-Version`` pin to the router on
    this thread (``None`` leaves any outer scope visible) — the
    :func:`priority_scope` plumbing applied to version pinning: the
    transports open it around the predictor call, and
    :class:`~unionml_tpu_torch.serving.router.HttpReplica` re-emits it
    across the router hop so a pinned request stays pinned through a
    router-of-routers."""
    if version is None:
        yield
        return
    prev = getattr(_model_version_tls, "version", None)
    _model_version_tls.version = version
    try:
        yield
    finally:
        _model_version_tls.version = prev


def current_model_version() -> str:
    """The innermost :func:`model_version_scope` value on this thread,
    else :data:`DEFAULT_MODEL_VERSION` (no pin)."""
    version = getattr(_model_version_tls, "version", None)
    return version if version else DEFAULT_MODEL_VERSION


def validate_token_cap(value) -> Optional[int]:
    """Normalize a per-request ``max_new_tokens`` cap from a payload
    field: ``None`` → no cap (the engine default applies); anything
    else must be an integer ``>= 1`` or ``ValueError`` (→ 422) — the
    cap crosses the router hop in the ``/predict`` payload, so a
    hostile body must be rejected at the boundary like a hostile
    header."""
    if value is None:
        return None
    if isinstance(value, bool) or (
        not isinstance(value, int) and not (
            isinstance(value, float) and value.is_integer()
        )
    ):
        raise ValueError(
            f"max_new_tokens must be an integer >= 1, got {value!r}"
        )
    cap = int(value)
    if cap < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {cap}")
    return cap


_token_cap_tls = threading.local()


@contextmanager
def token_cap_scope(cap: Optional[int]) -> Iterator[None]:
    """Expose a per-request ``max_new_tokens`` cap to engine
    submissions on this thread (``None`` leaves any outer scope
    visible) — the deadline-scope plumbing applied to the token cap:
    the transports open it from the ``/predict`` payload's
    ``max_new_tokens`` field, so an engine-backed predictor honors the
    caller's cap without threading a kwarg through every wrapper (and
    the cap survives the router hop — disaggregated two-leg dispatch
    needs it for token parity)."""
    if cap is None:
        yield
        return
    prev = getattr(_token_cap_tls, "cap", None)
    _token_cap_tls.cap = int(cap)
    try:
        yield
    finally:
        _token_cap_tls.cap = prev


def current_token_cap() -> Optional[int]:
    """The innermost :func:`token_cap_scope` value on this thread, or
    ``None`` (no per-request cap — the engine default applies)."""
    return getattr(_token_cap_tls, "cap", None)


@dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for :class:`PreemptiveScheduler` / :class:`WaitingRoom`.

    Args:
        class_weights: admission-throughput shares per priority class
            (stride scheduling: the class with the smallest virtual
            pass serves and advances by ``cost / weight``), so under
            full backlog class ``c`` receives ``w_c / Σw`` of admitted
            token throughput — the starvation bound (``low`` is
            slowed, never stopped). Keys must cover
            :data:`PRIORITIES` exactly.
        quantum_tokens: DRR refill per tenant visit, in prompt+decode
            tokens; scaled by the tenant's ledger fair share. Smaller
            quanta interleave tenants finer at more rotation cost.
        min_fair_weight: floor on the usage-fed tenant weight, so a
            tenant that consumed ~100% of the device still drains
            (slowly) instead of deadlocking its queue.
        preempt: ``True`` forces preemption on (raises at engine
            construction when the prerequisites — paged pool + prefix
            cache — are missing), ``False`` disables it (park-only, the
            pre-scheduler behavior), ``None`` (default) auto-enables
            exactly when the engine can evict-and-resume losslessly.
        mix_prefill_tokens: Sarathi-style stall-free mixing budget —
            lead prefill-chunk tokens the dispatcher interleaves into
            ONE pass between decode chunks. ``None`` (default) keeps
            the historical one-admission-step-per-pass cadence;
            a larger budget admits long prompts faster at the cost of
            more prefill compute between decode chunks.
    """

    class_weights: Mapping[str, int] = field(
        default_factory=lambda: {"high": 16, "normal": 4, "low": 1}
    )
    quantum_tokens: int = 256
    min_fair_weight: float = 0.05
    preempt: Optional[bool] = None
    mix_prefill_tokens: Optional[int] = None

    def __post_init__(self):
        if set(self.class_weights) != set(PRIORITIES):
            raise ValueError(
                f"class_weights must cover exactly {PRIORITIES}, got "
                f"{tuple(self.class_weights)}"
            )
        if any(w < 1 for w in self.class_weights.values()):
            raise ValueError("class_weights must all be >= 1")
        if self.quantum_tokens < 1:
            raise ValueError("quantum_tokens must be >= 1")
        if not 0.0 < self.min_fair_weight <= 1.0:
            raise ValueError("min_fair_weight must be in (0, 1]")
        if self.mix_prefill_tokens is not None and self.mix_prefill_tokens < 1:
            raise ValueError("mix_prefill_tokens must be >= 1 when set")


class WaitingRoom:
    """Priority/tenant waiting room: the engine's admission queue.

    Replaces the engine's internal FIFO ``queue.Queue`` + single-slot
    park: requests wait in per-(priority, tenant) deques, drained by
    weighted-class + per-tenant-DRR :meth:`pop`; pool-exhausted
    admissions :meth:`park` into a bounded parked lane (at most one
    entry per priority class — a parked request blocks its own class
    and every class below it, preserving the old FIFO-under-pressure
    contract, while strictly higher classes may still admit past it:
    the ``promote`` path).

    Requests need only ``.priority``, ``.tenant``, ``.prompt`` and
    ``.max_new_tokens`` attributes (the engine's ``_Request``). All
    methods are thread-safe; the engine calls some under its own lock,
    so nothing here calls back into engine state.
    """

    def __init__(
        self,
        config: Optional[SchedulerConfig] = None,
        *,
        usage=None,
        on_depth=None,
    ):
        self.config = config if config is not None else SchedulerConfig()
        self._usage = usage
        self._on_depth = on_depth  # callback(priority, depth) → gauges
        self._lock = threading.Lock()
        # priority → tenant → deque of requests (OrderedDict preserves
        # the DRR rotation order; rotation moves served tenants back)
        self._queues: Dict[str, "OrderedDict[str, deque]"] = {
            p: OrderedDict() for p in PRIORITIES
        }
        self._depths: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # stride-scheduling state across classes: each class carries a
        # virtual "pass"; the eligible class with the smallest pass
        # serves and advances by cost/weight, so admitted-token shares
        # converge EXACTLY to class_weights. _vtime is the pass of the
        # last served class — a class going from empty to backlogged
        # joins at it, so idle periods bank no credit.
        self._class_pass: Dict[str, float] = {p: 0.0 for p in PRIORITIES}
        self._vtime = 0.0
        # per-tenant DRR deficits within each class
        self._deficit: Dict[str, Dict[str, float]] = {
            p: {} for p in PRIORITIES
        }
        # parked lane: pool-exhausted admissions awaiting blocks, at
        # most one per class (strictly-higher classes admit past them)
        self._parked: List[Any] = []

    # ------------------------------------------------------------------ #
    # depth views
    # ------------------------------------------------------------------ #

    def qsize(self) -> int:
        """Queued (not yet popped) requests — the ``max_queue_depth``
        bound's denominator, matching the old FIFO's accounting (parked
        requests were already popped and are counted by the engine's
        ``_admitting``)."""
        with self._lock:
            return sum(self._depths.values())

    def empty(self) -> bool:
        return self.qsize() == 0

    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked)

    def depths(self) -> Dict[str, int]:
        """Per-class queued depth (the waiting-depth gauge view)."""
        with self._lock:
            return dict(self._depths)

    def _publish_locked(self, priority: str) -> None:
        if self._on_depth is not None:
            self._on_depth(priority, self._depths[priority])

    # ------------------------------------------------------------------ #
    # enqueue / dequeue
    # ------------------------------------------------------------------ #

    @staticmethod
    def _cost(req) -> int:
        """A request's admission cost in tokens (prompt + worst-case
        decode) — the unit both DRR layers account in."""
        return len(req.prompt) + int(req.max_new_tokens)

    def put(self, req, *, front: bool = False) -> None:
        """Enqueue ``req`` under its (priority, tenant). ``front=True``
        places it at the head of its queue — the resume path, so a
        preempted stream re-admits before its tenant's fresh arrivals."""
        with self._lock:
            if self._depths[req.priority] == 0:
                # the class joins the stride schedule at the current
                # virtual time: an idle class must not have banked a
                # tiny pass it could monopolize admissions with
                self._class_pass[req.priority] = max(
                    self._class_pass[req.priority], self._vtime
                )
            tenants = self._queues[req.priority]
            q = tenants.get(req.tenant)
            if q is None:
                q = deque()
                tenants[req.tenant] = q
                self._deficit[req.priority].setdefault(req.tenant, 0.0)
            if front:
                q.appendleft(req)
            else:
                q.append(req)
            self._depths[req.priority] += 1
            self._publish_locked(req.priority)

    def _fair_weight(self, tenant: str) -> float:
        """Usage-fed DRR weight: 1 − the tenant's attributed share of
        device time, floored at ``min_fair_weight`` — heavy tenants
        refill slower, light ones catch up (VTC-style fairness on the
        usage ledger)."""
        if self._usage is None:
            return 1.0
        share = self._usage.fair_share(tenant)
        return max(self.config.min_fair_weight, 1.0 - share)

    def _pop_class_locked(self, priority: str):
        """Per-tenant DRR within one class: rotate tenants, refilling
        each visited tenant's deficit by ``quantum × fair_weight``,
        and serve the first head whose deficit covers its cost. The
        rotation always terminates: deficits grow every visit."""
        tenants = self._queues[priority]
        deficits = self._deficit[priority]
        quantum = self.config.quantum_tokens
        # prune empty tenant queues first so the rotation is over live
        # work only; a pruned tenant's deficit resets (classic DRR —
        # an idle tenant must not bank credit for a later burst)
        for t in [t for t, q in tenants.items() if not q]:
            del tenants[t]
            deficits.pop(t, None)
        if not tenants:
            return None
        while True:
            for tenant in list(tenants):
                q = tenants[tenant]
                deficits[tenant] = (
                    deficits.get(tenant, 0.0)
                    + quantum * self._fair_weight(tenant)
                )
                head = q[0]
                cost = self._cost(head)
                if deficits[tenant] >= cost:
                    deficits[tenant] -= cost
                    q.popleft()
                    tenants.move_to_end(tenant)  # round-robin rotation
                    if not q:
                        del tenants[tenant]
                        deficits.pop(tenant, None)
                    self._depths[priority] -= 1
                    self._publish_locked(priority)
                    return head
                tenants.move_to_end(tenant)

    def pop(self, *, above_rank: Optional[int] = None):
        """Dequeue the next admission candidate, or ``None``.

        Class selection is STRIDE SCHEDULING (a deterministic lottery):
        the eligible class with the smallest virtual pass serves, then
        advances its pass by ``cost / weight`` — so admitted-token
        shares converge exactly to :attr:`SchedulerConfig
        .class_weights` under contention. That IS the starvation
        bound: a backlogged class with weight ``w`` receives at least
        ``w / Σ weights`` of admitted token throughput, never zero
        (docs/robustness.md derives the per-request wait bound). While
        anything is parked, only classes STRICTLY more urgent than the
        most-urgent parked request are eligible (the parked head
        blocks its class and below — FIFO-under-pressure is preserved;
        a pop that jumps a parked head is the ``promote`` event the
        engine records). ``above_rank`` narrows eligibility further
        (ranks strictly below it, i.e. more urgent)."""
        with self._lock:
            limit = above_rank
            if self._parked:
                parked_rank = min(
                    priority_rank(r.priority) for r in self._parked
                )
                limit = (
                    parked_rank if limit is None else min(limit, parked_rank)
                )
            eligible = [
                p for p in PRIORITIES
                if self._depths[p] > 0
                and (limit is None or priority_rank(p) < limit)
            ]
            if not eligible:
                return None
            # smallest pass serves; PRIORITIES order breaks ties
            # toward the more urgent class
            best = min(
                eligible,
                key=lambda p: (self._class_pass[p], priority_rank(p)),
            )
            req = self._pop_class_locked(best)
            if req is not None:
                self._vtime = self._class_pass[best]
                self._class_pass[best] += (
                    self._cost(req) / self.config.class_weights[best]
                )
            return req

    # ------------------------------------------------------------------ #
    # parked lane (pool-exhausted admissions)
    # ------------------------------------------------------------------ #

    def park(self, req) -> None:
        """Move a pool-exhausted admission into the parked lane (the
        engine retries it every dispatcher pass via
        :meth:`take_parked`). Bounded by construction: at most one
        parked request per priority class, because :meth:`pop` only
        releases candidates from classes strictly above every parked
        entry."""
        with self._lock:
            if req not in self._parked:
                self._parked.append(req)
                # most-urgent first, FIFO within a class (stable sort)
                self._parked.sort(key=lambda r: priority_rank(r.priority))

    def take_parked(self):
        """The parked request to retry this pass (most urgent first),
        removed from the lane — the engine re-:meth:`park`\\ s it if
        its reservation still fails."""
        with self._lock:
            if not self._parked:
                return None
            return self._parked.pop(0)

    def is_parked(self, req) -> bool:
        with self._lock:
            return req in self._parked

    def pop_all(self) -> List[Any]:
        """Drain everything — queued AND parked — for engine close."""
        with self._lock:
            out: List[Any] = list(self._parked)
            self._parked = []
            for p in PRIORITIES:
                for q in self._queues[p].values():
                    out.extend(q)
                self._queues[p].clear()
                self._depths[p] = 0
                self._publish_locked(p)
            return out


class PreemptiveScheduler:
    """The engine-facing facade: waiting room + victim policy + the
    scheduler's own telemetry series. One per engine instance."""

    def __init__(
        self,
        config: Optional[SchedulerConfig] = None,
        *,
        registry: Optional[telemetry.MetricsRegistry] = None,
        engine_label: str = "engine-0",
        usage=None,
        phase: Optional[str] = None,
    ):
        self.config = config if config is not None else SchedulerConfig()
        # the owning engine's serving phase (prefill/decode/colocated):
        # rides stats() so a phase-split fleet's per-engine scheduler
        # views are attributable to their pool
        self.phase = validate_phase(phase)
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self.engine_label = engine_label
        depth_gauge = self._registry.gauge(
            "unionml_sched_waiting_depth",
            "Waiting-room depth per priority class (requests queued "
            "awaiting admission, parked pool-exhausted admissions "
            "excluded).",
            ("engine", "priority"),
        )
        self._g_depth = {
            p: depth_gauge.labels(engine=engine_label, priority=p)
            for p in PRIORITIES
        }
        preempted = self._registry.counter(
            "unionml_preemptions_total",
            "Resident streams evicted to the host prefix-cache block "
            "store by the preemptive scheduler, by cause (priority = a "
            "higher-priority waiter displaced a lower-priority "
            "resident); every preemption is later resumed via the "
            "splice path with exact token parity.",
            ("engine", "cause"),
        )
        self._m_preempted = {
            cause: preempted.labels(engine=engine_label, cause=cause)
            for cause in PREEMPT_CAUSES
        }
        self.room = WaitingRoom(
            self.config, usage=usage,
            on_depth=lambda p, d: self._g_depth[p].set(d),
        )

    # ------------------------------------------------------------------ #
    # preemption policy
    # ------------------------------------------------------------------ #

    def select_victim(
        self, waiter, residents: List[Tuple[int, Any]]
    ) -> Optional[Tuple[int, Any]]:
        """Pick the resident to evict for ``waiter``, or ``None``.

        Policy (docs/robustness.md "Preemption & fairness"): only
        residents in a STRICTLY lower priority class than the waiter
        are candidates (equal-priority contention parks FIFO, so a
        class can never thrash itself); among candidates, the lowest
        class loses first, ties broken by the most recent admission
        (LIFO — the longest-running streams, closest to completion
        and holding the most reusable KV, are spared). ``residents``
        is the engine's pre-filtered ``(slot, request)`` eligibility
        list (prefill harvested, not abandoned, resume prompt fits a
        bucket)."""
        waiter_rank = priority_rank(waiter.priority)
        candidates = [
            (slot, r) for slot, r in residents
            if priority_rank(r.priority) > waiter_rank
        ]
        if not candidates:
            return None
        return max(
            candidates,
            key=lambda sr: (priority_rank(sr[1].priority), sr[1].submitted),
        )

    def record_preemption(self, cause: str = "priority") -> None:
        if cause not in PREEMPT_CAUSES:  # closed label set
            cause = PREEMPT_CAUSES[0]
        self._m_preempted[cause].inc()

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #

    def preemptions(self) -> int:
        return int(sum(c.value for c in self._m_preempted.values()))

    def stats(self) -> dict:
        """The ``scheduler`` section of ``DecodeEngine.stats()``."""
        return {
            "phase": self.phase,
            "waiting": self.room.depths(),
            "parked": self.room.parked_count(),
            "preemptions": self.preemptions(),
            "class_weights": dict(self.config.class_weights),
            "quantum_tokens": self.config.quantum_tokens,
        }

    def reset_stats(self) -> None:
        for c in self._m_preempted.values():
            c.reset()
