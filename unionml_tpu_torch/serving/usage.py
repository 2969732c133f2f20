"""Per-tenant usage metering: request-level cost attribution ledger.

Multi-tenant adapter serving needs per-tenant fairness
and quotas, but nothing in the stack could previously say *what a
request costs*: the program cost analysis is per-program, the pool telemetry
is global, and trace spans time requests without attributing shared
device work — one decode chunk advances every resident slot at once, so
"this tenant's chunk" is not a thing the hardware knows. This module is
the measurement substrate (S-LoRA / VTC-style fair serving presupposes
per-client token/compute accounting): a :class:`UsageLedger` that
assembles, per request, a **resource vector** —

- ``queue_ms`` — submit-to-admission wait,
- ``prefill_tokens`` / ``cached_tokens`` — prompt tokens actually
  prefilled vs. spliced from the prefix cache (the savings are credited
  to the tenant HOLDING the lease, i.e. the one that reused the rows),
- ``decode_tokens`` — tokens served,
- ``device_seconds`` / ``flops`` — each dispatched program's cost (wall
  between consecutive harvests, the :class:`~unionml_tpu_torch.introspection
  .ProgramTracker`'s counted FLOPs) split across the live occupants
  of the batch/chunk, **weighted by their harvested-token share**,
- ``kv_block_seconds`` — block-seconds integrated over
  :class:`~unionml_tpu_torch.serving.kv_pool.KVBlockPool` hold times (paged
  engines; freed on retirement, abandon, and recovery alike).

Tenant identity flows end to end: the transports accept an
``X-Tenant-ID`` header (validated — see :func:`validate_tenant` — and
echoed on every response), open a :func:`tenant_scope` around the
predictor call the same way deadlines and trace contexts propagate, and
the engine/batcher pick it up at submission via :func:`current_tenant`
(default ``anonymous``).

**Cardinality policy.** Tenant ids are request-derived and therefore
unbounded; metric label values must not be. The ledger exports
``unionml_tenant_*`` series through a **bounded rollup**: the first
``top_k`` distinct tenants that record usage get dedicated label values
(heavy tenants recur and claim their slot on first contact — the
Misra-Gries/space-saving property for never-decremented counters), and
every later tenant lands in the single ``other`` label. Assignment is
sticky, so counters stay monotonic; total exported tenant-label
cardinality is at most ``top_k + 1`` regardless of distinct tenant
count. Exact per-tenant vectors (up to ``max_tenants``, then an
``other`` accumulator) are served at ``GET /debug/usage`` — JSON, not
label values, so the debug surface can afford precision the metric
surface cannot. ``scripts/lint_basics.py`` enforces that no other
module registers a ``unionml_*`` series with a request-derived label.

The ledger is the off-switchable seam: engines and batchers built
without one (``usage=None``, the default) pay a single attr-is-None
check per record site.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from unionml_tpu_torch import telemetry

__all__ = [
    "DEFAULT_TENANT",
    "MAX_TENANT_LEN",
    "OTHER_TENANT",
    "UsageLedger",
    "current_tenant",
    "tenant_scope",
    "validate_tenant",
]

DEFAULT_TENANT = "anonymous"
OTHER_TENANT = "other"
MAX_TENANT_LEN = 64

# drop causes are a CLOSED set (metric label values): free-form error
# detail belongs in the flight recorder, not in label cardinality
DROP_CAUSES = ("abandoned", "deadline_shed", "error")


def validate_tenant(value: Optional[str]) -> str:
    """Normalize a tenant id: ``None``/empty → :data:`DEFAULT_TENANT`;
    values longer than :data:`MAX_TENANT_LEN` or containing
    non-printable characters raise ``ValueError`` (the transports map it
    to 422) — a hostile header must be rejected at the boundary, never
    minted into a label value or a ledger key."""
    if value is None or value == "":
        return DEFAULT_TENANT
    tenant = str(value)
    if len(tenant) > MAX_TENANT_LEN:
        raise ValueError(
            f"tenant id longer than {MAX_TENANT_LEN} chars "
            f"({len(tenant)}): set a stable short identifier in "
            "X-Tenant-ID"
        )
    if not tenant.isprintable():
        raise ValueError(
            "tenant id contains non-printable characters: X-Tenant-ID "
            "must be printable text"
        )
    return tenant


_tenant_tls = threading.local()


@contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[None]:
    """Expose ``tenant`` to engine/batcher submissions on this thread
    (``None`` leaves any outer scope visible). The transports open this
    around the predictor call — deadline-scope-style thread-local
    plumbing, so no predictor wrapper threads a tenant kwarg through."""
    if tenant is None:
        yield
        return
    prev = getattr(_tenant_tls, "tenant", None)
    _tenant_tls.tenant = tenant
    try:
        yield
    finally:
        _tenant_tls.tenant = prev


def current_tenant() -> str:
    """The innermost :func:`tenant_scope` tenant on this thread, else
    :data:`DEFAULT_TENANT`."""
    tenant = getattr(_tenant_tls, "tenant", None)
    return tenant if tenant else DEFAULT_TENANT


class _TenantUsage:
    """One tenant's exact cumulative resource vector (ledger lock)."""

    __slots__ = (
        "requests", "queue_ms", "prefill_tokens", "cached_tokens",
        "decode_tokens", "device_seconds", "flops", "kv_block_seconds",
        "rejected", "deadline_shed", "dropped", "by_priority",
        "by_phase", "by_version",
    )

    def __init__(self):
        self.by_priority: Dict[str, int] = {}
        self.by_phase: Dict[str, int] = {}
        self.by_version: Dict[str, int] = {}
        self.requests = 0
        self.queue_ms = 0.0
        self.prefill_tokens = 0
        self.cached_tokens = 0
        self.decode_tokens = 0
        self.device_seconds = 0.0
        self.flops = 0.0
        self.kv_block_seconds = 0.0
        self.rejected = 0
        self.deadline_shed = 0
        self.dropped = 0

    def vector(self) -> dict:
        return {
            "requests": self.requests,
            # priority breakdown of completed requests (closed value
            # set — scheduler.PRIORITIES — so JSON keys stay bounded;
            # kept out of the metric surface: the per-tenant label
            # cardinality budget is spent)
            "requests_by_priority": dict(self.by_priority),
            # serving-phase breakdown (closed set — scheduler.PHASES):
            # on a disaggregated fleet the prefill pool's 1-token legs
            # and the decode pool's streams are separately countable
            # per tenant (JSON-only, same cardinality argument)
            "requests_by_phase": dict(self.by_phase),
            # model-version breakdown (slug-validated registry ids —
            # a fleet serves at most live + canary during a rollout,
            # so the key set stays bounded; JSON-only like the
            # others): during a canary bake a tenant's bill is
            # splittable by which weights answered
            "requests_by_version": dict(self.by_version),
            "queue_ms": round(self.queue_ms, 3),
            "prefill_tokens": self.prefill_tokens,
            "cached_tokens": self.cached_tokens,
            "decode_tokens": self.decode_tokens,
            "device_seconds": round(self.device_seconds, 9),
            "flops": self.flops,
            "kv_block_seconds": round(self.kv_block_seconds, 9),
            "rejected": self.rejected,
            "deadline_shed": self.deadline_shed,
            "dropped": self.dropped,
        }


class UsageLedger:
    """Request-level cost attribution with bounded-cardinality export.

    One ledger per serving surface (share it between an engine and the
    :class:`~unionml_tpu_torch.serving.http.ServingApp` serving its
    ``/debug/usage``); engines/batchers record into it at admission,
    harvest, and retirement. Thread-safe — the engine calls some sites
    with its own lock held, so the ledger must never call back into
    engine state (it never does: pure accumulation).

    Args:
        registry: explicit :class:`~unionml_tpu_torch.telemetry
            .MetricsRegistry`; defaults to the process-global one.
        top_k: dedicated tenant label slots. Exported
            ``unionml_tenant_*`` cardinality is at most ``top_k + 1``
            (the ``other`` rollup) no matter how many distinct tenants
            appear. Sticky first-contact assignment keeps every series
            monotonic.
        max_tenants: the ledger's host-memory bound, independent of
            the label bound: exact per-tenant vectors tracked for
            ``/debug/usage`` (tenants past the cap accumulate into the
            ``other`` vector), and the cap on remembered tenant ids —
            past it, unseen tenants resolve to the ``other`` label
            without being stored, so a client minting a fresh id per
            request cannot grow memory or the debug body unboundedly.
    """

    def __init__(
        self,
        *,
        registry: Optional[telemetry.MetricsRegistry] = None,
        top_k: int = 8,
        max_tenants: int = 1024,
    ):
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if max_tenants < top_k:
            raise ValueError(
                f"max_tenants {max_tenants} must be >= top_k {top_k}"
            )
        self.top_k = int(top_k)
        self.max_tenants = int(max_tenants)
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self.instance = telemetry.instance_label("usage")
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantUsage] = {}
        self._other = _TenantUsage()       # tenants past max_tenants
        # tenant -> exported label, bounded at max_tenants entries: a
        # client minting a fresh (valid) tenant id per request must not
        # grow host memory without bound, so past the cap unseen
        # tenants resolve to `other` WITHOUT being remembered
        self._labels: Dict[str, str] = {}
        self._dedicated = 0                # label slots assigned (<= top_k)
        self._distinct = 0                 # distinct tenants tracked
        # engine-side totals (the attribution-identity denominator):
        # ALL dispatched work, attributed or not — a chunk harvested
        # with no live owner still burned device time
        self.total_device_seconds = 0.0
        self.total_flops = 0.0
        self.total_tokens = 0
        self._capacity_slot_steps = 0.0
        self._used_slot_steps: Dict[str, float] = {}
        # per-label resolved (decode, device_s, flops) counter children:
        # attribute() runs on the harvester thread once per dispatched
        # chunk, so the family .labels() tuple-hash + lock is cached
        # away (the serve_usage bench holds the overhead bar at <= 2%)
        self._attr_children: Dict[str, tuple] = {}
        self._build_instruments()

    # ------------------------------------------------------------------ #
    # metric families (the ONE home for request-derived labels — the
    # lint_basics cardinality guard exempts exactly this module)
    # ------------------------------------------------------------------ #

    def _build_instruments(self) -> None:
        R, lbl = self._registry, ("ledger", "tenant")

        def counter(name, help):
            return R.counter(name, help, lbl)

        self._f_requests = counter(
            "unionml_tenant_requests_total",
            "Completed requests per tenant (bounded top-K rollup: "
            "tenants past the ledger's label slots report as 'other').",
        )
        self._f_queue_ms = counter(
            "unionml_tenant_queue_ms_total",
            "Submit-to-admission wait milliseconds per tenant.",
        )
        self._f_prefill = counter(
            "unionml_tenant_prefill_tokens_total",
            "Prompt tokens actually prefilled per tenant.",
        )
        self._f_cached = counter(
            "unionml_tenant_cached_tokens_total",
            "Prompt tokens spliced from the prefix cache per tenant "
            "(prefill work saved, credited to the leasing tenant).",
        )
        self._f_decode = counter(
            "unionml_tenant_decode_tokens_total",
            "Tokens served per tenant (batcher ledgers count rows).",
        )
        self._f_device_s = counter(
            "unionml_tenant_device_seconds_total",
            "Attributed device-seconds per tenant: each dispatch's "
            "cost split across the live batch occupants by harvested-"
            "token share.",
        )
        self._f_flops = counter(
            "unionml_tenant_flops_total",
            "Attributed FLOPs per tenant (the ProgramTracker's counted "
            "FLOPs split by token share; 0 when introspection is off).",
        )
        self._f_kv_s = counter(
            "unionml_tenant_kv_block_seconds_total",
            "KV block-seconds per tenant: pool-block hold time "
            "integrated from take to release (retire/abandon/recovery).",
        )
        self._f_rejected = R.counter(
            "unionml_tenant_rejected_total",
            "Admission-control rejections per tenant and reason.",
            ("ledger", "tenant", "reason"),
        )
        self._f_shed = counter(
            "unionml_tenant_deadline_shed_total",
            "Requests shed at dequeue per tenant (deadline expired "
            "before prefill).",
        )
        self._f_dropped = R.counter(
            "unionml_tenant_dropped_total",
            "Requests dropped mid-flight per tenant and cause "
            "(abandoned / deadline_shed / error).",
            ("ledger", "tenant", "cause"),
        )
        self._g_capacity = R.gauge(
            "unionml_tenant_capacity_fraction",
            "Fraction of decode slot-step capacity a tenant consumed "
            "since the last reset (headroom = 1 - sum over tenants).",
            ("ledger", "tenant"),
        )
        self._g_distinct = R.gauge(
            "unionml_tenant_distinct",
            "Distinct tenant ids tracked by this ledger (saturates at "
            "max_tenants — the host-memory bound; label cardinality "
            "stays top_k + 1 regardless).",
            ("ledger",),
        ).labels(self.instance)

    # ------------------------------------------------------------------ #
    # rollup
    # ------------------------------------------------------------------ #

    def label_for(self, tenant: str) -> str:
        """The exported label value for ``tenant``: a dedicated slot
        for the first ``top_k`` distinct tenants (sticky — counters
        must stay monotonic), :data:`OTHER_TENANT` for everyone else.
        The bounded-rollup helper every ``unionml_tenant_*`` increment
        routes through."""
        with self._lock:
            return self._label_locked(tenant)

    def _label_locked(self, tenant: str) -> str:
        label = self._labels.get(tenant)
        if label is None:
            if self._dedicated < self.top_k and tenant != OTHER_TENANT:
                label = tenant
                self._dedicated += 1
            else:
                label = OTHER_TENANT
                if len(self._labels) >= self.max_tenants:
                    # past the memory bound: resolve without remembering
                    return label
            self._labels[tenant] = label
            self._distinct += 1
            self._g_distinct.set(self._distinct)
        return label

    def _acct_locked(self, tenant: str) -> _TenantUsage:
        self._label_locked(tenant)  # seen-tenant bookkeeping
        acct = self._tenants.get(tenant)
        if acct is None:
            if len(self._tenants) >= self.max_tenants:
                return self._other
            acct = _TenantUsage()
            self._tenants[tenant] = acct
        return acct

    # ------------------------------------------------------------------ #
    # recording (engine/batcher call sites)
    # ------------------------------------------------------------------ #

    def finish_request(
        self,
        tenant: str,
        *,
        queue_ms: float = 0.0,
        prefill_tokens: int = 0,
        cached_tokens: int = 0,
        priority: Optional[str] = None,
        phase: Optional[str] = None,
        version: Optional[str] = None,
    ) -> None:
        """One request completed and delivered: the per-request scalars
        (queue wait, prefill split, the scheduling ``priority`` class
        it ran under, the serving ``phase`` of the engine that
        completed it, and the model ``version`` its weights were
        published under) land here; decode tokens and device
        attribution accumulated through :meth:`attribute` as the
        request's chunks harvested."""
        with self._lock:
            label = self._label_locked(tenant)
            acct = self._acct_locked(tenant)
            acct.requests += 1
            acct.queue_ms += queue_ms
            acct.prefill_tokens += int(prefill_tokens)
            acct.cached_tokens += int(cached_tokens)
            if priority is not None:
                acct.by_priority[priority] = (
                    acct.by_priority.get(priority, 0) + 1
                )
            if phase is not None:
                acct.by_phase[phase] = acct.by_phase.get(phase, 0) + 1
            if version is not None:
                acct.by_version[version] = (
                    acct.by_version.get(version, 0) + 1
                )
        lbl = (self.instance, label)
        self._f_requests.labels(*lbl).inc()
        if queue_ms > 0:
            self._f_queue_ms.labels(*lbl).inc(queue_ms)
        if prefill_tokens:
            self._f_prefill.labels(*lbl).inc(int(prefill_tokens))
        if cached_tokens:
            self._f_cached.labels(*lbl).inc(int(cached_tokens))

    def attribute(
        self,
        tenant_tokens: Dict[str, int],
        *,
        device_s: float = 0.0,
        flops: float = 0.0,
        slot_steps: float = 0.0,
    ) -> None:
        """Attribute one dispatch (a decode chunk, a prefill, a batched
        device call): ``device_s`` and ``flops`` split across
        ``tenant_tokens`` weighted by token share; each tenant's tokens
        credit its ``decode_tokens``. Totals accumulate UNATTRIBUTED
        (a chunk whose every occupant went stale still burned device
        time — the identity check's honest denominator).
        ``slot_steps`` grows the capacity denominator for the headroom
        estimate (``chunk_steps * slots`` per decode chunk)."""
        device_s = max(0.0, float(device_s))
        flops = max(0.0, float(flops))
        slot_steps = max(0.0, float(slot_steps))
        total_tokens = sum(tenant_tokens.values())
        shares = []
        with self._lock:
            self.total_device_seconds += device_s
            self.total_flops += flops
            self.total_tokens += total_tokens
            self._capacity_slot_steps += slot_steps
            for tenant, tokens in tenant_tokens.items():
                if tokens <= 0:
                    continue
                w = tokens / total_tokens
                acct = self._acct_locked(tenant)
                acct.decode_tokens += int(tokens)
                acct.device_seconds += device_s * w
                acct.flops += flops * w
                if slot_steps > 0:
                    # only capacity-bearing dispatches (decode chunks)
                    # count as used slot-steps — a prefill's sampled
                    # token or a batcher row is not decode capacity;
                    # untracked tenants roll into the `other` key so
                    # the dict stays max_tenants-bounded
                    key = (
                        tenant if acct is not self._other
                        else OTHER_TENANT
                    )
                    self._used_slot_steps[key] = (
                        self._used_slot_steps.get(key, 0.0) + tokens
                    )
                shares.append(
                    (self._label_locked(tenant), tokens, w)
                )
        for label, tokens, w in shares:
            children = self._attr_children.get(label)
            if children is None:
                lbl = (self.instance, label)
                children = (
                    self._f_decode.labels(*lbl),
                    self._f_device_s.labels(*lbl),
                    self._f_flops.labels(*lbl),
                )
                self._attr_children[label] = children
            children[0].inc(tokens)
            if device_s:
                children[1].inc(device_s * w)
            if flops:
                children[2].inc(flops * w)

    def record_kv_block_seconds(self, tenant: str, seconds: float) -> None:
        """Integrate one request's pool-block hold time (taken → freed;
        the engine calls this on retirement, abandon-drop, AND recovery,
        so no hold window is ever left open)."""
        seconds = max(0.0, float(seconds))
        if seconds == 0.0:
            return
        with self._lock:
            label = self._label_locked(tenant)
            self._acct_locked(tenant).kv_block_seconds += seconds
        self._f_kv_s.labels(self.instance, label).inc(seconds)

    def record_rejected(
        self, tenant: str, reason: str, n: int = 1
    ) -> None:
        """Admission-control rejection (reason is the engine/batcher's
        closed reason set: queue_full / breaker_open / draining /
        pool_full) — overload postmortems can name who was shed."""
        with self._lock:
            label = self._label_locked(tenant)
            self._acct_locked(tenant).rejected += n
        self._f_rejected.labels(self.instance, label, reason).inc(n)

    def record_deadline_shed(self, tenant: str) -> None:
        with self._lock:
            label = self._label_locked(tenant)
            self._acct_locked(tenant).deadline_shed += 1
        self._f_shed.labels(self.instance, label).inc()

    def record_drop(self, tenant: str, cause: str) -> None:
        """A request failed mid-flight. ``cause`` outside the closed
        :data:`DROP_CAUSES` set (free-form error detail) reports as
        ``error`` — detail belongs in the flight recorder, not in label
        cardinality."""
        if cause not in DROP_CAUSES:
            cause = "error"
        with self._lock:
            label = self._label_locked(tenant)
            self._acct_locked(tenant).dropped += 1
        self._f_dropped.labels(self.instance, label, cause).inc()

    def fair_share(self, tenant: str) -> float:
        """``tenant``'s fraction of ATTRIBUTED device-seconds so far
        (0.0 when nothing is attributed yet or the tenant is unknown)
        — the cheap read the preemptive scheduler's deficit queues
        scale their refill quanta by (a tenant that already consumed
        most of the device refills slower, so its class's light users
        catch up). Tenants rolled past ``max_tenants`` share the
        ``other`` accumulator's vector and therefore its share."""
        with self._lock:
            acct = self._tenants.get(tenant)
            if acct is None and len(self._tenants) >= self.max_tenants:
                acct = self._other
            if acct is None or self.total_device_seconds <= 0.0:
                return 0.0
            return min(
                1.0, acct.device_seconds / self.total_device_seconds
            )

    def capacity_totals(self) -> "tuple[float, float]":
        """``(capacity_slot_steps, used_slot_steps)`` — the raw decode
        capacity counters, cumulative since the last reset. A cheap
        read (one lock, no gauge refresh, no report assembly) for
        pollers that difference consecutive samples into a *windowed*
        utilization — the autoscaler's headroom signal works on deltas
        between evaluations, so an idle morning never dilutes an
        overloaded afternoon (docs/robustness.md "Autoscaling &
        self-healing")."""
        with self._lock:
            return (
                self._capacity_slot_steps,
                sum(self._used_slot_steps.values()),
            )

    def capacity_headroom(self) -> float:
        """``1 - used/capacity`` over everything since the last reset
        (1.0 with no capacity dispatched) — the cumulative convenience
        read; pollers that need recency should difference
        :meth:`capacity_totals` instead."""
        cap, used = self.capacity_totals()
        if cap <= 0.0:
            return 1.0
        return max(0.0, 1.0 - used / cap)

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #

    def _capacity_locked(self) -> dict:
        cap = self._capacity_slot_steps
        fractions = {
            tenant: used / cap if cap > 0 else 0.0
            for tenant, used in self._used_slot_steps.items()
        }
        return {
            "slot_steps": cap,
            "per_tenant": {
                t: round(f, 4) for t, f in sorted(
                    fractions.items(), key=lambda kv: -kv[1]
                )
            },
            "headroom": round(
                max(0.0, 1.0 - sum(fractions.values())), 4
            ),
        }

    def report(self) -> dict:
        """The ``GET /debug/usage`` body: exact per-tenant resource
        vectors (every tracked tenant — JSON can afford what label
        cardinality cannot), the attribution-identity totals, cache
        savings, and the decode capacity-headroom estimate. Also
        refreshes the ``unionml_tenant_capacity_fraction`` gauges."""
        with self._lock:
            tenants = {
                t: acct.vector() for t, acct in sorted(
                    self._tenants.items(),
                    key=lambda kv: -kv[1].device_seconds,
                )
            }
            other = self._other.vector()
            capacity = self._capacity_locked()
            labels = dict(self._labels)
            distinct = self._distinct
            totals = {
                "device_seconds": round(self.total_device_seconds, 9),
                "flops": self.total_flops,
                "tokens": self.total_tokens,
            }
        attributed_s = sum(v["device_seconds"] for v in tenants.values())
        attributed_s += other["device_seconds"]
        attributed_tok = sum(v["decode_tokens"] for v in tenants.values())
        attributed_tok += other["decode_tokens"]
        saved = sum(v["cached_tokens"] for v in tenants.values())
        saved += other["cached_tokens"]
        # gauge export aggregates by LABEL: several rolled-up tenants
        # share the `other` series, so their fractions must sum (a
        # per-tenant set() would leave one arbitrary tenant's value)
        by_label: Dict[str, float] = {}
        for tenant, frac in capacity["per_tenant"].items():
            label = labels.get(tenant, OTHER_TENANT)
            by_label[label] = by_label.get(label, 0.0) + frac
        for label, frac in by_label.items():
            self._g_capacity.labels(self.instance, label).set(frac)
        return {
            "ledger": self.instance,
            "top_k": self.top_k,
            "distinct_tenants": distinct,
            "exported_labels": sorted(set(labels.values())),
            "tenants": tenants,
            "other": other,
            "totals": totals,
            "attribution": {
                "attributed_device_seconds": round(attributed_s, 9),
                "attributed_tokens": attributed_tok,
                "device_seconds_coverage": round(
                    attributed_s / totals["device_seconds"], 4
                ) if totals["device_seconds"] else 1.0,
                "token_coverage": round(
                    attributed_tok / totals["tokens"], 4
                ) if totals["tokens"] else 1.0,
            },
            "cache_savings_tokens": saved,
            "capacity": capacity,
        }

    def stats(self) -> dict:
        """The compact ``stats()["usage"]`` section (the full report is
        ``GET /debug/usage``)."""
        report = self.report()
        return {
            "distinct_tenants": report["distinct_tenants"],
            "exported_labels": report["exported_labels"],
            "totals": report["totals"],
            "attribution": report["attribution"],
            "cache_savings_tokens": report["cache_savings_tokens"],
            "capacity_headroom": report["capacity"]["headroom"],
        }

    def reset_stats(self) -> None:
        """Zero vectors, totals, and this ledger's series (benchmarks
        call this between phases). Label-slot assignments are KEPT —
        they describe exported series that still exist, and re-assigning
        them would un-stick the rollup."""
        with self._lock:
            self._tenants.clear()
            self._other = _TenantUsage()
            self.total_device_seconds = 0.0
            self.total_flops = 0.0
            self.total_tokens = 0
            self._capacity_slot_steps = 0.0
            self._used_slot_steps.clear()
        for family in (
            self._f_requests, self._f_queue_ms, self._f_prefill,
            self._f_cached, self._f_decode, self._f_device_s,
            self._f_flops, self._f_kv_s, self._f_rejected, self._f_shed,
            self._f_dropped, self._g_capacity,
        ):
            family.reset()
