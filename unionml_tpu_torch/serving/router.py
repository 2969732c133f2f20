"""Cluster front door: a fault-tolerant multi-replica router.

The PyTorch port of :mod:`unionml_tpu.serving.router`, unchanged: pure
Python over the port's engines and transport (``HttpReplica`` speaks
urllib only).

Everything below one process is production-grade — admission control,
circuit breaker, supervised recovery, tracing, SLO watchdog, per-tenant
metering — but a replica dying still means every client pointed at it
fails. This module is the tier above: a :class:`FleetRouter` fronts N
engine replicas (in-process handles first, HTTP upstreams behind the
same :class:`ReplicaHandle` interface) and makes the *fleet* survive
what one process cannot (docs/robustness.md "Fleet robustness").

Routing composes signals the stack already emits:

- **prefix-cache locality** — the replica holding the longest cached
  prefix of the prompt wins (SGLang-style; the read-only
  :meth:`~unionml_tpu_torch.serving.prefix_cache.RadixPrefixCache.peek`
  probe, so scoring never distorts per-replica cache telemetry);
- **queue depth + breaker state** — from each replica's ``health()``;
- **SLO burn** — :meth:`~unionml_tpu_torch.slo.SloWatchdog.burn_score`
  deprioritizes replicas burning error budget *before* they breach.

Every dispatch is wrapped in a robustness envelope:

- **retry policy** — exponential backoff + deterministic seeded jitter,
  honoring typed ``Retry-After`` hints, retrying only errors that are
  safe and useful to retry (a 422 or a deadline miss is not);
- **retry budget** — a fleet-wide token bucket (deposits a fraction of
  live traffic, each retry spends one token) so a degraded fleet sees
  bounded retry amplification instead of a melt-down retry storm;
- **hedging** (opt-in) — a second dispatch to a *different* replica
  once the first exceeds the observed latency quantile; first answer
  wins, the loser's stream is closed (→ engine-side abandonment);
- **passive outlier ejection** — consecutive failures eject a replica
  with exponential-cooldown hysteresis; after cooldown exactly one
  probe request flows half-open, success rejoins it, failure re-ejects
  with doubled cooldown;
- **drain/join choreography** — ``drain_replica()`` stops new routes,
  delegates to the replica's own ``drain()`` (PR 3) so in-flight
  streams finish, and ``rejoin_replica()`` resumes + re-admits it;
  when the live set thins below ``min_live`` the router itself answers
  ``degraded`` health instead of blackholing.

Context propagates through the hop: in-process replicas inherit the
caller thread's ``deadline_scope``/``tenant_scope``/``trace_scope``
(hedge threads re-open them), and :class:`HttpReplica` re-emits them as
``X-Deadline-Ms`` / ``X-Tenant-ID`` / ``traceparent`` / ``X-Request-ID``
headers — so PR 5's trace tree and PR 8's ledger span the fleet.

Observability: ``unionml_router_*`` series (per-replica route/retry/
hedge/eject counters, live-replica gauge, pick-latency histogram) and
flight-recorder ``route``/``retry``/``hedge``/``eject``/``probe``/
``rejoin``/``drain``/``join`` events make every failover explainable
post-hoc.
"""

from __future__ import annotations

import itertools
import json
import random
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    current_deadline_ms,
    deadline_scope,
)
from unionml_tpu_torch.serving.scheduler import (
    DEFAULT_MODEL_VERSION,
    current_model_version,
    current_priority,
    current_token_cap,
    model_version_scope,
    priority_scope,
    token_cap_scope,
    validate_phase,
    validate_token_cap,
)
from unionml_tpu_torch.serving.usage import current_tenant, tenant_scope

# the router's request id, exposed to replica dispatches on this thread
# (deadline-scope-style): HttpReplica re-emits it as X-Request-ID so the
# remote flight recorder tags the same rid and cross-hop correlation
# ("follow one request") works over HTTP replicas too
_rid_tls = threading.local()


@contextmanager
def _rid_scope(rid: str) -> Iterator[None]:
    prev = getattr(_rid_tls, "rid", None)
    _rid_tls.rid = rid
    try:
        yield
    finally:
        _rid_tls.rid = prev


def current_route_rid() -> Optional[str]:
    """The routing request id of the dispatch on this thread, if any."""
    return getattr(_rid_tls, "rid", None)


__all__ = [
    "EngineReplica",
    "FleetRouter",
    "HttpReplica",
    "ReplicaHandle",
    "RouterPolicy",
    "make_router_app",
]


class ReplicaHandle:
    """The interface one replica presents to the router.

    Subclass for each transport; :class:`EngineReplica` wraps an
    in-process :class:`~unionml_tpu_torch.serving.engine.DecodeEngine`,
    :class:`HttpReplica` a remote serving process. All methods may be
    called concurrently from router worker threads.
    """

    name: str = "replica"

    # True for handles whose observability fetches cross a network
    # (the fleet debug surfaces fan those out on bounded-deadline
    # threads; in-process fetches run inline — a local registry read
    # must not pay a thread spawn per scrape)
    remote: bool = False

    # which serving phase this replica's pool owns (docs/serving.md
    # "Disaggregated serving"): "prefill" / "decode" / "colocated"
    # (default — serves both). The DisaggRouter's phase-aware pick
    # routes by it; fleet_report / GET /debug/fleet tag replicas with
    # it so the operator dashboard shows per-pool state.
    phase: str = "colocated"

    # which model version this replica serves (docs/robustness.md
    # "Rollouts & rollback"): None = the fleet's implicit live version
    # (the router substitutes its `live_version`). The RolloutController
    # stamps canaries and promoted replicas; the version-aware pick and
    # every observability surface key on it.
    version: Optional[str] = None

    def generate_stream(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> Iterator[List[int]]:
        """Yield token chunks for one prompt — the streaming dispatch
        primitive (hedged losers are cancelled by closing the
        iterator, and mid-stream failover replays past emitted
        chunks)."""
        raise NotImplementedError

    def generate(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> List[int]:
        """All tokens for one prompt, blocking — the non-streaming
        dispatch primitive. Default collects :meth:`generate_stream`;
        in-process replicas override with the engine's native blocking
        call (one event wait instead of per-chunk queue hops — the
        passthrough-overhead bench leg rides on this)."""
        out: List[int] = []
        for chunk in self.generate_stream(
            prompt, max_new_tokens=max_new_tokens
        ):
            out.extend(chunk)
        return out

    def health(self) -> dict:
        """The replica's ``/health`` dict: at least ``status`` and
        ``queue_depth``; ``burn`` (SLO burn score) when known."""
        raise NotImplementedError

    def cached_prefix_len(self, prompt: Sequence[int]) -> int:
        """Tokens of ``prompt`` this replica holds a cached KV prefix
        for (0 when unknown — remote replicas without a peek API)."""
        return 0

    def cache_blocks(self) -> int:
        """Resident prefix-cache blocks (0 when unknown) — the
        autoscaler's warm-donor/cold-victim ranking signal."""
        return 0

    def export_hot_blocks(self, max_blocks: int = 64) -> List[dict]:
        """The warm-join donor hook: this replica's hottest cached
        prefix blocks as :meth:`~unionml_tpu_torch.serving.prefix_cache
        .RadixPrefixCache.export_hot` entries (empty when the replica
        has no exportable cache — remote replicas don't ship KV bytes
        over this API yet)."""
        return []

    def import_cache_blocks(self, entries: Sequence[dict]) -> int:
        """The warm-join import hook: attach a donor's exported blocks
        before this replica takes traffic; returns blocks attached (0
        when unsupported)."""
        return 0

    # -- disaggregated prefill/decode hooks (docs/serving.md
    # "Disaggregated serving"): the two-leg dispatch primitives. Every
    # implementation must either work or raise — the DisaggRouter
    # degrades a failed prefill leg to a cold decode-side prefill, so
    # none of these can ever cost a caller-visible failure.

    def prefill_export(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> dict:
        """Run prefill ONLY and finalize the prompt's KV into the
        replica's host block store; returns the KV handle
        (``{"tokens": [first], "cached_tokens": N, "lease": ...}`` —
        see :meth:`~unionml_tpu_torch.serving.engine.DecodeEngine
        .prefill_export`). A replica that CANNOT serve a prefill leg
        (no prefix cache) raises the infra-class
        :class:`~unionml_tpu_torch.serving.faults.EngineUnavailable` — a
        pool misconfiguration must degrade the request to a cold
        decode-side prefill, not surface as a caller error (the
        router re-raises only deterministic caller faults)."""
        raise EngineUnavailable(
            f"{self.name}: replica does not support prefill_export",
            reason="no_prefill",
        )

    def export_request_blocks(self, prompt: Sequence[int]) -> List[dict]:
        """The cross-store handoff donor hook: this replica's cached
        blocks covering ``prompt`` as importable entries
        (:meth:`~unionml_tpu_torch.serving.prefix_cache.RadixPrefixCache
        .export_request`); empty when nothing is cached."""
        return []

    def kv_store(self):
        """The in-process :class:`~unionml_tpu_torch.serving.prefix_cache
        .RadixPrefixCache` behind this replica, when one exists —
        identity comparison is how the router detects SAME-HOST pools
        sharing one store (pointer handoff, no transfer needed)."""
        return None

    # -- fleet observability hooks (docs/observability.md "Fleet
    # observability"): how the router app's federated /metrics, merged
    # /debug/flight, stitched /debug/trace, and fleet /debug/slo +
    # /debug/usage read THIS replica. Defaults say "nothing to
    # contribute"; every implementation must degrade (None/empty),
    # never raise — a dead replica degrades a debug surface, it does
    # not break it.

    def metrics_registry(self) -> Optional[telemetry.MetricsRegistry]:
        """The in-process registry behind :meth:`metrics_text`, when
        one exists — the router app skips replicas whose registry IS
        its own (their series are already in the local exposition)."""
        return None

    def metrics_text(self) -> Optional[str]:
        """This replica's Prometheus exposition body (``None`` =
        nothing to federate)."""
        return None

    def flight_recorder(self) -> Optional[telemetry.FlightRecorder]:
        """The in-process flight ring behind :meth:`flight_events`
        (identity with the router app's ring = already merged)."""
        return None

    def flight_events(self, n: Optional[int] = None) -> Optional[List[dict]]:
        """This replica's newest flight events (oldest first); ``[]``
        = genuinely empty ring, ``None`` = the fetch FAILED (the
        router app counts the failure — an empty ring and a dead
        replica must not read the same)."""
        return []

    def trace_recorder(self) -> Optional[telemetry.TraceRecorder]:
        """The in-process trace recorder behind :meth:`stitched_spans`
        (identity with the router app's recorder = already stitched)."""
        return None

    def stitched_spans(
        self, trace_id: str
    ) -> Optional[Tuple[List[dict], List[dict]]]:
        """``(spans, events)`` this replica holds for ``trace_id``, in
        :func:`~unionml_tpu_torch.telemetry.stitched_trace` span form — the
        fetch half of cross-hop stitching. ``None`` = the fetch
        FAILED (counted by the router app), distinct from holding
        nothing for the trace."""
        return [], []

    def slo_report(self) -> Optional[dict]:
        """This replica's ``/debug/slo`` evaluation (``None`` when it
        runs no watchdog)."""
        return None

    def usage_ledger(self):
        """The in-process :class:`~unionml_tpu_torch.serving.usage
        .UsageLedger` behind :meth:`usage_report`, when one exists —
        replicas sharing ONE ledger must be merged once, not per
        replica."""
        return None

    def usage_report(self) -> Optional[dict]:
        """This replica's ``/debug/usage`` body (``None`` when it
        meters nothing)."""
        return None

    def goodput_report(self) -> Optional[dict]:
        """This replica's ``/debug/goodput`` body — the serving perf
        plane's batch-occupancy report (``None`` when the replica runs
        no plane or the fetch failed)."""
        return None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Finish in-flight work; stop admitting. True when drained."""
        return True

    def resume(self) -> None:
        """Reopen admissions after :meth:`drain`."""

    def close(self) -> None:
        """Release any resources the handle itself owns."""


class EngineReplica(ReplicaHandle):
    """An in-process :class:`~unionml_tpu_torch.serving.engine.DecodeEngine`
    behind the replica interface.

    ``params`` are the replica's bound serving weights. ``slo`` is an
    optional per-replica :class:`~unionml_tpu_torch.slo.SloWatchdog` whose
    :meth:`~unionml_tpu_torch.slo.SloWatchdog.burn_score` rides the health
    dict as the router's load-shifting signal. Ambient deadline/tenant/
    trace scopes propagate by construction: the dispatch runs on the
    caller's (or hedge worker's re-scoped) thread.
    """

    def __init__(self, engine, params, *, name: str, slo=None,
                 phase: Optional[str] = None,
                 version: Optional[str] = None):
        self.engine = engine
        self.params = params
        self.name = name
        self._slo = slo
        # the model version these weights are (None = the fleet's live
        # version); stamped onto the engine so its usage vectors carry
        # the same tag
        self.version = version
        if version is not None:
            engine.model_version = version
        # phase defaults to the engine's own declaration, so a
        # DecodeEngine(phase="prefill") replica routes correctly
        # without repeating itself at wrap time
        self.phase = validate_phase(
            phase if phase is not None
            else getattr(engine, "phase", None)
        )

    def generate_stream(self, prompt, *, max_new_tokens=None):
        return self.engine.generate_stream(
            self.params, prompt, max_new_tokens=max_new_tokens
        )

    def generate(self, prompt, *, max_new_tokens=None):
        return self.engine.generate(
            self.params, [prompt], max_new_tokens=max_new_tokens
        )[0]

    def prefill_export(self, prompt, *, max_new_tokens=None):
        if getattr(self.engine, "prefix_cache", None) is None:
            # misconfigured pool member: speak the infra vocabulary so
            # the disagg router degrades instead of erroring the caller
            raise EngineUnavailable(
                f"{self.name}: engine has no prefix cache — cannot "
                "serve a prefill leg",
                reason="no_prefill",
            )
        return self.engine.prefill_export(self.params, prompt)

    def export_request_blocks(self, prompt) -> List[dict]:
        return self.engine.kv_export(prompt)

    def kv_store(self):
        return getattr(self.engine, "prefix_cache", None)

    def health(self) -> dict:
        out = dict(self.engine.health())
        if self._slo is not None:
            self._slo.evaluate()
            out["burn"] = self._slo.burn_score()
            breached = self._slo.breached()
            if breached and out.get("status") == "ok":
                out["status"] = "degraded"
        return out

    def cached_prefix_len(self, prompt) -> int:
        cache = getattr(self.engine, "prefix_cache", None)
        if cache is None:
            return 0
        return int(cache.peek(prompt))

    def cache_blocks(self) -> int:
        cache = getattr(self.engine, "prefix_cache", None)
        return 0 if cache is None else int(cache.entries)

    def export_hot_blocks(self, max_blocks: int = 64) -> List[dict]:
        cache = getattr(self.engine, "prefix_cache", None)
        if cache is None:
            return []
        return cache.export_hot(max_blocks=max_blocks)

    def import_cache_blocks(self, entries: Sequence[dict]) -> int:
        if getattr(self.engine, "prefix_cache", None) is None:
            return 0
        # through the engine: a multi-rank engine attaches them on every
        # rank at one plan position
        return int(self.engine.kv_import(entries))

    def metrics_registry(self):
        return self.engine.registry

    def metrics_text(self) -> Optional[str]:
        return self.engine.registry.exposition()

    def flight_recorder(self):
        return self.engine.flight

    def flight_events(self, n: Optional[int] = None) -> List[dict]:
        flight = self.engine.flight
        return [] if flight is None else flight.dump(n=n)

    def trace_recorder(self):
        return self.engine.tracer

    def stitched_spans(self, trace_id: str) -> Tuple[List[dict], List[dict]]:
        doc = telemetry.stitched_trace(
            trace_id, self.engine.tracer.requests_for_trace(trace_id)
        )
        return doc["spans"], doc["events"]

    def slo_report(self) -> Optional[dict]:
        return None if self._slo is None else self._slo.evaluate()

    def usage_ledger(self):
        return self.engine.usage

    def usage_report(self) -> Optional[dict]:
        ledger = self.engine.usage
        return None if ledger is None else ledger.report()

    def goodput_report(self) -> Optional[dict]:
        try:
            return self.engine.goodput_report()
        except ValueError:
            return None  # plane off on this engine: degrade, don't error

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.engine.drain(timeout)

    def resume(self) -> None:
        self.engine.resume()


class HttpReplica(ReplicaHandle):
    """A remote serving process (stdlib/FastAPI transport) behind the
    replica interface.

    Dispatch is ``POST {base_url}/predict/stream`` (SSE), health is
    ``GET /health``. Ambient scopes re-emit as headers — the remote
    transport re-opens them, so deadlines keep shedding, tenants keep
    getting billed, and the trace tree stays connected across the hop.
    Connection errors surface as :class:`~unionml_tpu_torch.serving.faults
    .EngineUnavailable` (retryable); the typed 429/503/504 statuses map
    back to their local exceptions, ``Retry-After`` included, so the
    router's retry policy sees one error vocabulary for both replica
    kinds.
    """

    remote = True  # observability fetches cross the network: fan out

    def __init__(
        self, base_url: str, *, name: Optional[str] = None,
        timeout_s: float = 60.0, peek_ttl_s: float = 1.0,
        peek_cache_size: int = 256, peek_timeout_s: float = 2.0,
        peek_prompt_tokens: int = 128, metrics_ttl_s: float = 2.0,
        obs_timeout_s: float = 5.0, phase: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.name = name if name is not None else self.base_url
        # a remote's phase is the OPERATOR's declaration (the process
        # behind the URL can't be introspected per pick): pass
        # phase="prefill"/"decode" when registering pool members
        self.phase = validate_phase(phase)
        self.timeout_s = timeout_s
        # remote cache-peek probe cache (health-TTL-style): the router
        # peeks per pick, and a per-pick HTTP round trip would make
        # every dispatch pay a network RTT per replica. Strict `<` so
        # peek_ttl_s=0 means always-fresh; bounded so a high-entropy
        # prompt stream can't grow host memory. The probe gets its OWN
        # short timeout (a peek must never stall a pick the way the
        # 60 s dispatch timeout would on a wedged-but-accepting host)
        # and keys/queries on only the first `peek_prompt_tokens`
        # tokens — affinity is a property of the PREFIX, so
        # unique-suffix traffic (the normal LLM workload) still hits
        # the cache, and probe URLs stay bounded for 100k-token
        # prompts.
        self.peek_ttl_s = float(peek_ttl_s)
        self.peek_timeout_s = float(peek_timeout_s)
        self.peek_prompt_tokens = int(peek_prompt_tokens)
        self._peek_cache_size = int(peek_cache_size)
        self._peek_cache: Dict[bytes, tuple] = {}
        self._peek_lock = threading.Lock()
        self._peek_supported = True  # flips off on a 404 (older remote)
        # metrics-federation scrape cache (health-TTL pattern, strict
        # `<` so metrics_ttl_s=0 means always-fresh): the router app's
        # /metrics federates every replica, so a hot scraper must not
        # fan out one remote GET per replica per scrape. On failure the
        # LAST-SEEN body keeps serving (a killed replica degrades the
        # fleet scrape to stale-or-absent series, never to an error).
        self.metrics_ttl_s = float(metrics_ttl_s)
        # the operator/debug fetch timeout (flight/slo/usage/trace
        # pulls): bounded so one wedged replica cannot stall a fleet
        # debug surface for the full 60 s dispatch timeout
        self.obs_timeout_s = float(obs_timeout_s)
        self._metrics_lock = threading.Lock()
        self._metrics_cache: Optional[str] = None
        self._metrics_at = float("-inf")

    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        deadline_ms = current_deadline_ms()
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(deadline_ms)
        tenant = current_tenant()
        if tenant:
            headers["X-Tenant-ID"] = tenant
        # the scheduling class survives the hop: the remote transport
        # validates + re-opens it, so a routed high-priority request
        # keeps its preemption rights on the replica's engine
        headers["X-Priority"] = current_priority()
        # the model-version pin survives the hop too: a pinned request
        # routed through a fronting router must hit the same version
        # on the inner fleet (the X-Priority re-emission pattern)
        version = current_model_version()
        if version != DEFAULT_MODEL_VERSION:
            headers["X-Model-Version"] = version
        ctx = telemetry.current_trace_context()
        if ctx is not None:
            headers["traceparent"] = telemetry.format_traceparent(ctx)
        rid = current_route_rid()
        if rid:
            headers["X-Request-ID"] = rid
        return headers

    def _raise_typed(self, status: int, body: str, headers) -> None:
        retry_after = 1.0
        try:
            retry_after = float(headers.get("Retry-After", "1"))
        except (TypeError, ValueError):
            pass
        if status == 429:
            raise Overloaded(
                f"{self.name}: {body}", retry_after_s=retry_after
            )
        if status == 503:
            raise EngineUnavailable(
                f"{self.name}: {body}", retry_after_s=retry_after
            )
        if status == 504:
            raise DeadlineExceeded(f"{self.name}: {body}")
        if 400 <= status < 500:
            # a 4xx (e.g. 422 validation) is deterministic: the same
            # request fails on every replica — ValueError is the
            # NON-retryable class, so the router surfaces it instead
            # of burning budget re-sending a bad prompt
            raise ValueError(f"{self.name}: HTTP {status}: {body}")
        raise EngineUnavailable(  # other 5xx: possibly transient
            f"{self.name}: HTTP {status}: {body}",
            reason="http_error", retry_after_s=retry_after,
        )

    @staticmethod
    def _payload(prompt, max_new_tokens) -> dict:
        """The ``/predict``/``/predict/stream`` request body. The
        per-request token cap rides the payload's ``max_new_tokens``
        field (both transports parse it into a ``token_cap_scope``
        around the engine dispatch) — explicit argument first, else
        the ambient scope, mirroring how ``_headers`` re-emits the
        deadline/tenant scopes: a capped request keeps its cap across
        the hop, which failover token parity and the disaggregated
        two-leg dispatch both depend on."""
        payload = {"features": [list(int(t) for t in prompt)]}
        cap = (
            max_new_tokens if max_new_tokens is not None
            else current_token_cap()
        )
        if cap is not None:
            payload["max_new_tokens"] = int(cap)
        return payload

    def generate_stream(self, prompt, *, max_new_tokens=None):
        payload = self._payload(prompt, max_new_tokens)
        req = urllib.request.Request(
            f"{self.base_url}/predict/stream",
            data=json.dumps(payload).encode(),
            headers=self._headers(),
            method="POST",
        )
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as exc:
            body = exc.read().decode(errors="replace")
            self._raise_typed(exc.code, body, exc.headers)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            raise EngineUnavailable(
                f"{self.name}: unreachable ({exc})", reason="unreachable",
            ) from exc
        return self._sse_chunks(resp)

    @staticmethod
    def _sse_chunks(resp) -> Iterator[List[int]]:
        """Decode the shared SSE wire protocol (one ``{"tokens"}``
        event per chunk, then ``{"done"}``) back into token chunks. A
        connection dropped before ``done`` raises — mid-stream replica
        death must surface as a retryable error, not silent
        truncation."""
        try:
            done = False
            for raw in resp:
                line = raw.decode(errors="replace").strip()
                if not line.startswith("data:"):
                    continue
                event = json.loads(line[len("data:"):])
                if event.get("done"):
                    done = True
                    return
                yield [int(t) for t in event["tokens"]]
            if not done:
                raise EngineUnavailable(
                    "stream dropped before done event",
                    reason="stream_dropped",
                )
        except (OSError, TimeoutError) as exc:
            raise EngineUnavailable(
                f"stream aborted mid-flight ({exc})", reason="stream_dropped",
            ) from exc
        finally:
            resp.close()

    def generate(self, prompt, *, max_new_tokens=None):
        payload = self._payload(prompt, max_new_tokens)
        req = urllib.request.Request(
            f"{self.base_url}/predict",
            data=json.dumps(payload).encode(),
            headers=self._headers(),
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                rows = json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            body = exc.read().decode(errors="replace")
            self._raise_typed(exc.code, body, exc.headers)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            raise EngineUnavailable(
                f"{self.name}: unreachable ({exc})", reason="unreachable",
            ) from exc
        return [int(t) for t in rows[0]]

    def _get_json(
        self, path: str, timeout_s: Optional[float] = None
    ) -> dict:
        req = urllib.request.Request(f"{self.base_url}{path}")
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            # /health answers 503 WITH the body when degraded/draining
            try:
                return json.loads(exc.read().decode())
            except (json.JSONDecodeError, OSError):
                raise EngineUnavailable(
                    f"{self.name}: HTTP {exc.code} on {path}",
                    reason="unreachable",
                ) from exc
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            raise EngineUnavailable(
                f"{self.name}: unreachable ({exc})", reason="unreachable",
            ) from exc

    def health(self) -> dict:
        # the control-plane read gets the bounded observability
        # timeout, not the 60 s dispatch timeout: health is probed on
        # the pick path (TTL-missed) and by /debug/fleet — a wedged-
        # but-accepting host must not stall either for a minute (the
        # same argument that gave the cache peek its own timeout)
        return self._get_json("/health", timeout_s=self.obs_timeout_s)

    def _get_debug_json(self, path: str) -> Optional[dict]:
        """Best-effort debug-surface fetch on the bounded
        ``obs_timeout_s``: any failure — unreachable host, 4xx (the
        surface isn't wired remotely), garbage body — answers ``None``
        so a fleet debug merge degrades instead of erroring."""
        try:
            req = urllib.request.Request(f"{self.base_url}{path}")
            with urllib.request.urlopen(
                req, timeout=self.obs_timeout_s
            ) as resp:
                return json.loads(resp.read().decode())
        except BaseException:
            return None

    def metrics_text(self) -> Optional[str]:
        """The remote ``GET /metrics`` body, TTL-cached
        (``metrics_ttl_s``, strict ``<``); failures serve the
        last-seen body (or ``None`` before the first success) — the
        federation contract: a killed replica degrades the fleet
        scrape, never breaks it."""
        now = time.monotonic()
        with self._metrics_lock:
            if now - self._metrics_at < self.metrics_ttl_s:
                return self._metrics_cache
        body: Optional[str] = None
        try:
            req = urllib.request.Request(f"{self.base_url}/metrics")
            with urllib.request.urlopen(
                req, timeout=self.obs_timeout_s
            ) as resp:
                body = resp.read().decode()
        except BaseException:
            body = None
        with self._metrics_lock:
            if body is not None:
                self._metrics_cache = body
            # a FAILED scrape also refreshes the TTL stamp — and the
            # stamp is taken AFTER the fetch: a black-holed host's
            # obs_timeout_s (5 s) exceeds metrics_ttl_s (2 s), so a
            # pre-fetch stamp would already be expired by the next
            # scrape and every fleet scrape would re-pay the full
            # connect timeout
            self._metrics_at = time.monotonic()
            return self._metrics_cache

    def flight_events(self, n: Optional[int] = None) -> Optional[List[dict]]:
        path = "/debug/flight" + (f"?n={int(n)}" if n is not None else "")
        body = self._get_debug_json(path)
        if body is None:
            return None  # fetch failed: the app counts it
        events = body.get("events", [])
        if not isinstance(events, list):
            return []
        # rebase the REMOTE host's monotonic t_ms onto the wall clock
        # using the anchor the remote computed itself — cross-host
        # monotonic readings are incomparable (each host's epoch is
        # its boot time); wall-anchored ones merge at NTP accuracy.
        # An older remote without the anchor returns raw readings
        # (degraded ordering, still merged).
        offset = body.get("wall_offset_ms")
        if isinstance(offset, (int, float)):
            events = [
                {**e, "t_ms": round(e.get("t_ms", 0.0) + offset, 3)}
                if isinstance(e, dict) else e
                for e in events
            ]
        return events

    def stitched_spans(
        self, trace_id: str
    ) -> Optional[Tuple[List[dict], List[dict]]]:
        body = self._get_debug_json(
            f"/debug/trace?trace={trace_id}&format=stitched"
        )
        if body is None:
            return None  # fetch failed: the app counts it
        return (
            body.get("spans", []) or [],
            body.get("events", []) or [],
        )

    def slo_report(self) -> Optional[dict]:
        return self._get_debug_json("/debug/slo")

    def usage_report(self) -> Optional[dict]:
        return self._get_debug_json("/debug/usage")

    def goodput_report(self) -> Optional[dict]:
        return self._get_debug_json("/debug/goodput")

    def cached_prefix_len(self, prompt) -> int:
        """Cache-affinity across hosts: probe the remote transport's
        ``GET /debug/cache/peek`` (the read-only peek the in-process
        path uses directly) with a TTL cache so the probe can never
        become a per-pick round trip, its own short ``peek_timeout_s``
        so it can never stall one either, and only the first
        ``peek_prompt_tokens`` tokens as the key AND the query (the
        affinity signal lives in the prefix — unique-suffix traffic
        still hits the cache). Any failure — unreachable host, a
        remote without the endpoint (HTTP 404, negative-cached
        permanently), no cache wired (422) — degrades to 0: affinity
        is an optimization, never a routing prerequisite."""
        if not self._peek_supported:
            return 0
        head = [int(t) for t in prompt[:self.peek_prompt_tokens]]
        key = b"".join(
            t.to_bytes(4, "little", signed=True) for t in head
        )
        now = time.monotonic()
        with self._peek_lock:
            hit = self._peek_cache.get(key)
            if hit is not None and now - hit[1] < self.peek_ttl_s:
                return hit[0]
        cached = 0
        url = (
            f"{self.base_url}/debug/cache/peek?prompt="
            + ",".join(str(t) for t in head)
        )
        try:
            with urllib.request.urlopen(
                urllib.request.Request(url), timeout=self.peek_timeout_s,
            ) as resp:
                body = json.loads(resp.read().decode())
            cached = int(body.get("cached_prefix_len", 0))
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                # the route itself is absent (any transport's 404
                # shape) — an older remote: stop asking forever
                self._peek_supported = False
                return 0
            cached = 0  # 422 (no cache wired) and other statuses
        except BaseException:
            cached = 0  # probe failures must never fail (or slow) a pick
        with self._peek_lock:
            if len(self._peek_cache) >= self._peek_cache_size:
                # bounded: drop the stalest ~half instead of growing
                cutoff = sorted(
                    at for _, at in self._peek_cache.values()
                )[len(self._peek_cache) // 2]
                self._peek_cache = {
                    k: v for k, v in self._peek_cache.items()
                    if v[1] > cutoff
                }
            self._peek_cache[key] = (cached, now)
        return cached

    def _post_json(
        self, path: str, body: dict, timeout_s: Optional[float] = None,
    ) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            text = exc.read().decode(errors="replace")
            self._raise_typed(exc.code, text, exc.headers)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            raise EngineUnavailable(
                f"{self.name}: unreachable ({exc})", reason="unreachable",
            ) from exc

    def prefill_export(self, prompt, *, max_new_tokens=None):
        """The remote prefill leg: ONE 1-token ``/predict`` (the cap
        rides the payload) — the remote engine prefills, samples the
        first token, and finalizes the prompt's KV into ITS host
        store through the normal harvest path. The block entries only
        cross the wire later, if and when the decode side actually
        pulls them (:meth:`export_request_blocks`) — a same-fleet
        decode replica that turns out to share the store never pays
        the serialization."""
        out = self.generate(prompt, max_new_tokens=1)
        if not out:
            raise EngineUnavailable(
                f"{self.name}: empty prefill response",
                reason="http_error",
            )
        return {
            "tokens": out[:1],
            "prompt": [int(t) for t in prompt],
            # unknown from here — the transfer step discovers coverage
            "cached_tokens": 0,
            "lease": None,  # remote store: no local pin to hold
            "engine": self.name,
        }

    def _kv_export_wire(self, prompt) -> List[dict]:
        """The remote store's blocks covering ``prompt`` in WIRE form
        (``POST /debug/kv/export``, bounded by ``obs_timeout_s`` — a
        wedged prefill host must degrade the handoff to a cold decode
        prefill, not stall it for the dispatch timeout). The
        disaggregated router's remote→remote handoff relays this form
        untouched: transcoding megabytes of KV through numpy just to
        re-encode them would be pure churn on the handoff path."""
        body = self._post_json(
            "/debug/kv/export",
            {"prompt": [int(t) for t in prompt]},
            timeout_s=self.obs_timeout_s,
        )
        entries = body.get("entries", [])
        return entries if isinstance(entries, list) else []

    def _kv_import_wire(self, encoded: Sequence[dict]) -> int:
        """Push already-wire-form entries over ``POST
        /debug/kv/import``; returns blocks attached remotely."""
        if not encoded:
            return 0
        body = self._post_json(
            "/debug/kv/import", {"entries": list(encoded)},
            timeout_s=self.obs_timeout_s,
        )
        return int(body.get("attached", 0))

    def export_request_blocks(self, prompt) -> List[dict]:
        """The in-process entry form of :meth:`_kv_export_wire` (for
        an in-process importer on this side of the hop)."""
        from unionml_tpu_torch.serving.prefix_cache import decode_entries

        return decode_entries(self._kv_export_wire(prompt))

    def import_cache_blocks(self, entries: Sequence[dict]) -> int:
        """Push block entries into the remote store over
        ``POST /debug/kv/import`` (the cross-host halves of both the
        KV handoff and fleet warming)."""
        from unionml_tpu_torch.serving.prefix_cache import encode_entries

        if not entries:
            return 0
        return self._kv_import_wire(encode_entries(entries))

    def drain(self, timeout: Optional[float] = None) -> bool:
        # remote drain is an operator action on the remote process;
        # the router-side contract is just "stop routing here"
        return True


class RouterPolicy:
    """Tunables for :class:`FleetRouter` (one object so bench/test
    sweeps name their configuration in one place).

    Retry: up to ``max_attempts`` total dispatches per request,
    exponential backoff ``backoff_base_s * 2^(attempt-1)`` capped at
    ``backoff_max_s``, plus deterministic seeded jitter in
    ``[0, jitter_s)``; a typed ``Retry-After`` hint raises the floor.
    Retries draw on a fleet-wide budget: the bucket starts at
    ``retry_budget_burst`` tokens, each *admitted* request deposits
    ``retry_budget_ratio`` tokens (capped back at the burst), each
    retry spends one — so over any horizon
    ``retries <= burst + ratio * requests`` and a degraded fleet sees
    bounded amplification (Finagle/Envoy lineage; docs/robustness.md
    derives the bound).

    Hedging: off by default. When ``hedge=True``, a non-streaming
    request whose first dispatch exceeds the observed
    ``hedge_quantile`` latency (floored at ``hedge_min_s``, and only
    once ``hedge_warmup`` samples exist) dispatches once more to a
    different replica; first finished answer wins, the loser's stream
    is closed (engine-side abandonment reaps the slot). Hedges spend
    retry-budget tokens too — a hedge IS speculative retry load.

    Ejection: ``eject_consecutive`` consecutive retryable failures
    eject a replica for ``eject_cooldown_s``; each re-ejection doubles
    the cooldown (capped at ``eject_cooldown_max_s`` — the hysteresis
    that keeps a flapping replica from oscillating), a successful
    half-open probe rejoins it and resets the cooldown ladder.

    ``min_live``: below this many live replicas the router's own
    ``health()`` degrades — a thin fleet should shed at the balancer
    above, not blackhole at the router.

    Weighted least-request (``latency_weight``, default 0 = off): the
    router keeps a per-replica sliding window (``latency_window``
    samples, :class:`~unionml_tpu_torch.telemetry.SlidingSamples`) of
    successful dispatch latencies and subtracts ``latency_weight *
    rolling_mean_seconds`` from the pick score — so a slow replica
    (overloaded host, thermal throttle, noisy neighbor) sheds share
    smoothly *without* waiting for failures to eject it. The weight is
    score-points per second: at the default queue_weight=2, a replica
    running 500 ms slower on average loses as much score as one extra
    queued request per ``latency_weight``.
    """

    def __init__(
        self,
        *,
        max_attempts: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        jitter_s: float = 0.02,
        retry_budget_ratio: float = 0.2,
        retry_budget_burst: float = 3.0,
        hedge: bool = False,
        hedge_quantile: float = 0.95,
        hedge_min_s: float = 0.05,
        hedge_warmup: int = 20,
        eject_consecutive: int = 3,
        eject_cooldown_s: float = 5.0,
        eject_cooldown_max_s: float = 60.0,
        min_live: int = 1,
        cache_weight: float = 1.0,
        queue_weight: float = 2.0,
        burn_weight: float = 4.0,
        latency_weight: float = 0.0,
        latency_window: int = 128,
        health_ttl_s: float = 0.25,
        seed: int = 0,
    ):
        if latency_weight < 0.0:
            raise ValueError(
                f"latency_weight must be >= 0, got {latency_weight}"
            )
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= retry_budget_ratio <= 1.0:
            raise ValueError(
                f"retry_budget_ratio must be in [0, 1], got "
                f"{retry_budget_ratio}"
            )
        if not 0.0 < hedge_quantile < 1.0:
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got {hedge_quantile}"
            )
        if eject_consecutive < 1:
            raise ValueError(
                f"eject_consecutive must be >= 1, got {eject_consecutive}"
            )
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter_s = jitter_s
        self.retry_budget_ratio = retry_budget_ratio
        self.retry_budget_burst = retry_budget_burst
        self.hedge = hedge
        self.hedge_quantile = hedge_quantile
        self.hedge_min_s = hedge_min_s
        self.hedge_warmup = hedge_warmup
        self.eject_consecutive = eject_consecutive
        self.eject_cooldown_s = eject_cooldown_s
        self.eject_cooldown_max_s = eject_cooldown_max_s
        self.min_live = min_live
        self.cache_weight = cache_weight
        self.queue_weight = queue_weight
        self.burn_weight = burn_weight
        self.latency_weight = latency_weight
        self.latency_window = latency_window
        self.health_ttl_s = health_ttl_s
        self.seed = seed


# replica lifecycle states the router tracks (the replica's OWN health
# is a separate, composed signal)
_LIVE = "live"
_EJECTED = "ejected"
_HALF_OPEN = "half_open"
_DRAINING = "draining"


class _ReplicaState:
    """Router-side bookkeeping for one replica (all mutation under the
    router lock)."""

    __slots__ = (
        "handle", "state", "consecutive_failures", "eject_count",
        "rejoin_at", "probe_inflight", "health_cache", "health_at",
    )

    def __init__(self, handle: ReplicaHandle):
        self.handle = handle
        self.state = _LIVE
        self.consecutive_failures = 0
        self.eject_count = 0           # lifetime ejections → cooldown ladder
        self.rejoin_at = 0.0           # monotonic time the cooldown ends
        self.probe_inflight = False    # half-open: exactly one probe
        self.health_cache: dict = {}
        self.health_at = float("-inf")


def _retryable(exc: BaseException) -> bool:
    """Errors worth retrying on ANOTHER replica: overload/unavailable/
    transport failures and engine-side crashes. NOT retryable: the
    caller's own deadline (a second attempt arrives just as late),
    and validation errors (deterministically wrong on every
    replica)."""
    if isinstance(exc, (Overloaded, EngineUnavailable, TimeoutError)):
        # DeadlineExceeded subclasses TimeoutError — exclude it
        return not isinstance(exc, DeadlineExceeded)
    return isinstance(exc, RuntimeError) and not isinstance(exc, ValueError)


class FleetRouter:
    """Routes requests over N :class:`ReplicaHandle` s with failover,
    retry budgets, optional hedging, outlier ejection, and drain/join
    choreography (module docstring has the full story).

    ``clock`` is injectable (monotonic seconds) so ejection-cooldown
    tests are deterministic; production uses ``time.monotonic``.
    ``sleep`` likewise for backoff.
    """

    # fleet lifecycle events per fleet-timeline rotation: the timeline
    # must FINISH to export (OTLP listeners fire on finish), so a busy
    # fleet rotates often enough that events ship within minutes while
    # a quiet one holds a mostly-empty timeline open
    FLEET_TIMELINE_ROTATE = 256

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        *,
        policy: Optional[RouterPolicy] = None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        flight: Optional[telemetry.FlightRecorder] = None,
        tracer: Optional[telemetry.TraceRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.policy = policy if policy is not None else RouterPolicy()
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaState] = {
            r.name: _ReplicaState(r) for r in replicas
        }
        self._rr = 0  # round-robin tie-break counter
        self._draining = False
        self._rng = random.Random(self.policy.seed)
        self._budget_tokens = self.policy.retry_budget_burst
        self._latency = telemetry.SlidingSamples(maxlen=512)
        # per-replica dispatch-latency windows (the weighted
        # least-request term; populated lazily on first success)
        self._replica_latency: Dict[str, telemetry.SlidingSamples] = {}
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self._flight = (
            flight if flight is not None else telemetry.get_flight_recorder()
        )
        # the stitching recorder: every routed request opens a "route"
        # timeline here (pick / attempt / backoff / hedge-lane spans)
        # parented into the caller's ambient trace scope, and each
        # attempt's child context propagates to the replica — assign
        # None to the `tracer` property to turn the plane off (the
        # bench's paired-leg seam)
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self._fleet_lock = threading.Lock()
        self._fleet_rid: Optional[str] = None
        self._fleet_events = 0
        # set by a FleetAutoscaler operating this router; the fleet
        # dashboard (GET /debug/fleet) reads its last decision through
        # it. A phase-split fleet runs one autoscaler PER POOL (TTFT
        # burn scales prefill, decode headroom scales decode) — each
        # registers under its phase in `autoscalers`, and `autoscaler`
        # keeps pointing at the most recent registration (the single-
        # pool back-compat view).
        self.autoscaler = None
        self.autoscalers: Dict[str, object] = {}
        # model-version rollout state (docs/robustness.md "Rollouts &
        # rollback"): `rollout` is set by a RolloutController operating
        # this router (fleet_report / GET /debug/rollout read through
        # it, and every successful live dispatch offers itself for
        # shadowing through it). `live_version` is the version every
        # version-less replica implicitly serves; the split steers a
        # percentage / per-tenant slice of UNPINNED traffic to the
        # canary version while a rollout bakes.
        self.rollout = None
        self.live_version: Optional[str] = None
        self._version_split: Optional[dict] = None
        self._split_counter = 0
        self._build_instruments()
        self._g_live.set_function(self._live_count)

    @property
    def tracer(self) -> Optional[telemetry.TraceRecorder]:
        """The recorder routing timelines land in (``None`` = trace
        stitching off)."""
        return self._tracer

    @tracer.setter
    def tracer(self, recorder: Optional[telemetry.TraceRecorder]) -> None:
        """Swap (or disable, with ``None``) the stitching recorder —
        ONLY while idle, the same contract as ``engine.usage``: the
        ``serve_fleet_obs`` bench toggles this between its paired
        overhead legs so both run on the SAME router instance."""
        with self._fleet_lock:
            old_rid, old = self._fleet_rid, self._tracer
            self._fleet_rid = None
            self._fleet_events = 0
            self._tracer = recorder
        if old_rid is not None and old is not None:
            old.finish_request(old_rid)

    # -- instruments -------------------------------------------------------

    def _build_instruments(self) -> None:
        reg = self._registry
        self._m_routed = reg.counter(
            "unionml_router_requests_total",
            "Requests dispatched by the fleet router, by replica and "
            "outcome (ok/error/retried_away).",
            ("replica", "outcome"),
        )
        self._m_retries = reg.counter(
            "unionml_router_retries_total",
            "Retry dispatches, by the replica the retry was sent TO.",
            ("replica",),
        )
        self._m_hedges = reg.counter(
            "unionml_router_hedges_total",
            "Hedge dispatches, by replica and result (win/lose).",
            ("replica", "result"),
        )
        self._m_ejections = reg.counter(
            "unionml_router_ejections_total",
            "Outlier ejections, by replica.",
            ("replica",),
        )
        self._m_rejoins = reg.counter(
            "unionml_router_rejoins_total",
            "Replicas rejoined after a successful half-open probe or "
            "drain cycle, by replica.",
            ("replica",),
        )
        self._m_budget_exhausted = reg.counter(
            "unionml_router_retry_budget_exhausted_total",
            "Retries NOT attempted because the fleet-wide retry budget "
            "was empty (the storm-control activation count).",
        )
        self._g_live = reg.gauge(
            "unionml_router_live_replicas",
            "Replicas currently routable (live or half-open probing).",
        )
        self._h_pick_ms = reg.histogram(
            "unionml_router_pick_ms",
            "Replica-selection latency (health peeks + cache peeks + "
            "scoring).",
        )

    def _live_count(self) -> float:
        with self._lock:
            return float(sum(
                1 for s in self._replicas.values()
                if s.state in (_LIVE, _HALF_OPEN)
            ))

    # -- fleet lifecycle timeline ------------------------------------------

    def trace_event(self, name: str, **args) -> None:
        """Record one fleet-lifecycle instant — the router's
        ``eject``/``probe``/``rejoin`` transitions, the autoscaler's
        ``scale_*`` decisions — onto a rotating ``kind="fleet"``
        recorder timeline, exported over OTLP as span EVENTS on the
        fleet root span: a latency spike is then explainable from the
        trace alone, with the scale/eject marks sitting on the same
        wall-anchored axis as the request spans. Rotates every
        :data:`FLEET_TIMELINE_ROTATE` events (a finished timeline is
        what actually exports); no-op while stitching is off."""
        tracer = self._tracer
        if tracer is None:
            return
        finish_rid = None
        with self._fleet_lock:
            if tracer is not self._tracer:
                return  # swapped between the read and the lock
            if (
                self._fleet_rid is None
                or self._fleet_events >= self.FLEET_TIMELINE_ROTATE
            ):
                finish_rid = self._fleet_rid
                # trace_scope(None) masks any ambient request scope:
                # the fleet timeline is a ROOT trace, not a child of
                # whichever request's thread happened to eject first
                with telemetry.trace_scope(None):
                    self._fleet_rid = tracer.new_request(
                        "fleet", component="router",
                    )
                self._fleet_events = 0
            self._fleet_events += 1
            rid = self._fleet_rid
        if finish_rid is not None:
            tracer.finish_request(finish_rid)
        tracer.record_event(rid, name, **args)

    def _close_fleet_timeline(self) -> None:
        with self._fleet_lock:
            rid, self._fleet_rid = self._fleet_rid, None
            self._fleet_events = 0
            tracer = self._tracer
        if rid is not None and tracer is not None:
            tracer.finish_request(rid)

    # -- model-version routing (docs/robustness.md "Rollouts & rollback") --

    def _replica_version(self, handle: ReplicaHandle) -> Optional[str]:
        """The version ``handle`` serves: its own stamp, else the
        fleet's implicit live version."""
        return getattr(handle, "version", None) or self.live_version

    def set_version_split(
        self, version: str, *, percent: float = 0.0,
        tenants: Optional[Dict[str, str]] = None,
    ) -> None:
        """Steer a slice of UNPINNED traffic to ``version``:
        ``percent`` of requests (deterministic stride — no RNG, so
        chaos tests replay exactly) plus every request from a tenant
        in ``tenants`` (tenant → version). Split assignment is SOFT —
        when no routable replica serves the split version, the pick
        falls back to live capacity (a dying canary sheds its share,
        it never fails a caller). A hard ``X-Model-Version`` pin
        bypasses the split entirely."""
        if not 0.0 <= float(percent) <= 100.0:
            raise ValueError(
                f"split percent must be in [0, 100], got {percent}"
            )
        with self._lock:
            self._version_split = {
                "version": version,
                "percent": float(percent),
                "tenants": dict(tenants or {}),
            }
            self._split_counter = 0

    def clear_version_split(self) -> None:
        with self._lock:
            self._version_split = None

    def version_split(self) -> Optional[dict]:
        """The active split spec (a copy), or ``None``."""
        with self._lock:
            split = self._version_split
            return None if split is None else {
                "version": split["version"],
                "percent": split["percent"],
                "tenants": dict(split["tenants"]),
            }

    def _resolve_route_version(
        self,
    ) -> Tuple[Optional[str], bool, Optional[str]]:
        """``(version, soft, exclude_version)`` for one request: a
        hard ``X-Model-Version`` pin wins (strict — an unknown version
        is a 422, an unroutable one a 503), else the rollout split
        assigns softly (percentage stride / tenant pin, falling back
        to live when the canary is unroutable). Unpinned traffic the
        split did NOT assign carries the split version as a soft
        EXCLUSION — the canary gets exactly its share, never
        load-balancer spillover on top of it."""
        pin = current_model_version()
        if pin != DEFAULT_MODEL_VERSION:
            return pin, False, None
        with self._lock:
            split = self._version_split
            if split is None:
                return None, True, None
            tenant = current_tenant()
            if tenant in split["tenants"]:
                return split["tenants"][tenant], True, None
            percent = split["percent"]
            if percent > 0.0:
                self._split_counter += 1
                # deterministic percentage stride over the unit circle:
                # floor(c*p/100) advances exactly on the canary's share
                c = self._split_counter
                if (c * percent) // 100.0 > ((c - 1) * percent) // 100.0:
                    return split["version"], True, None
            return None, True, split["version"]

    # -- membership / choreography ----------------------------------------

    def members(self) -> Dict[str, ReplicaHandle]:
        """Every registered replica handle by name (any lifecycle
        state) — the fleet observability surfaces iterate membership
        through this instead of reaching into router internals."""
        with self._lock:
            return {n: s.handle for n, s in self._replicas.items()}

    def fleet_report(self) -> dict:
        """The ``GET /debug/fleet`` operator dashboard: per-replica
        router state + health (breaker, drain, queue depth), cache
        blocks, burn scores, retry-budget level — and, when a
        :class:`~unionml_tpu_torch.serving.autoscaler.FleetAutoscaler`
        operates this router, its dashboard (usage headroom, burn
        windows, last scale decision + reason) under
        ``"autoscaler"``."""
        signals = self.replica_signals()  # ONE health sweep, TTL-cached
        health = self.health()            # router-local state, no probes
        with self._lock:
            budget = self._budget_tokens
        replicas = {}
        phases: Dict[str, dict] = {}
        for name, s in signals.items():
            h = s["health"]
            phase = s.get("phase", "colocated")
            replicas[name] = {
                "state": s["state"],
                "phase": phase,
                "version": s.get("version"),
                "status": h.get("status", "unknown"),
                "queue_depth": h.get("queue_depth", 0),
                "breaker_open": bool(h.get("breaker_open", False)),
                "burn": float(h.get("burn", 0.0) or 0.0),
                "cache_blocks": s["cache_blocks"],
                "consecutive_failures": s["consecutive_failures"],
            }
            # per-pool rollup: the operator dashboard's phase-split
            # view (docs/serving.md "Disaggregated serving")
            pool = phases.setdefault(
                phase, {"replicas": 0, "routable": 0, "queue_depth": 0},
            )
            pool["replicas"] += 1
            if s["state"] in (_LIVE, _HALF_OPEN):
                pool["routable"] += 1
            pool["queue_depth"] += int(h.get("queue_depth", 0) or 0)
        report = {
            "status": health["status"],
            "live_replicas": health["live_replicas"],
            "min_live": health["min_live"],
            "live_version": self.live_version,
            "retry_budget_tokens": round(budget, 3),
            "replicas": replicas,
            "phases": phases,
        }
        rollout = self.rollout
        if rollout is not None:
            try:
                report["rollout"] = rollout.dashboard()
            except BaseException as exc:
                # a mid-teardown controller degrades the dashboard,
                # never breaks /debug/fleet
                report["rollout"] = {"error": str(exc)}
        auto = self.autoscaler
        if auto is not None:
            try:
                # hand over the sweep this call already did, so the
                # dashboard costs zero additional health probes
                report["autoscaler"] = auto.dashboard(signals=signals)
            except BaseException as exc:
                # the dashboard is a debug read: a mid-teardown
                # autoscaler degrades it, never breaks /debug/fleet
                report["autoscaler"] = {"error": str(exc)}
        if len(self.autoscalers) > 1:
            # phase-split fleets: every pool's autoscaler view, keyed
            # by the phase it operates
            per_pool = {}
            for key, pool_auto in list(self.autoscalers.items()):
                try:
                    per_pool[key] = pool_auto.dashboard(signals=signals)
                except BaseException as exc:
                    per_pool[key] = {"error": str(exc)}
            report["autoscalers"] = per_pool
        return report

    def replica_handle(self, name: str) -> ReplicaHandle:
        """The handle registered under ``name`` (KeyError when absent)
        — the autoscaler uses this to reach a warm-join donor's
        export hook without holding router internals."""
        with self._lock:
            state = self._replicas.get(name)
            if state is None:
                raise KeyError(f"unknown replica {name!r}")
            return state.handle

    def add_replica(self, handle: ReplicaHandle) -> None:
        """Join a new replica into the live set (scale-out, or a
        rebuilt process re-registering)."""
        with self._lock:
            if handle.name in self._replicas:
                raise ValueError(f"replica {handle.name!r} already present")
            self._replicas[handle.name] = _ReplicaState(handle)
        self._flight.record("join", replica=handle.name)

    def remove_replica(self, name: str, *, drain_timeout: float = 30.0) -> bool:
        """Permanently remove ``name``: drain it first (in-flight
        streams finish), then drop it from the set. True when the
        drain completed within ``drain_timeout``."""
        drained = self.drain_replica(name, timeout=drain_timeout)
        with self._lock:
            self._replicas.pop(name, None)
            self._replica_latency.pop(name, None)
        self._flight.record("leave", replica=name, drained=drained)
        return drained

    def drain_replica(self, name: str, timeout: Optional[float] = None) -> bool:
        """Stop routing new work to ``name`` and delegate to the
        replica's own ``drain()`` so in-flight streams finish. The
        replica stays in the set (``rejoin_replica`` reverses); True
        when its drain reported complete."""
        with self._lock:
            state = self._replicas.get(name)
            if state is None:
                raise KeyError(f"unknown replica {name!r}")
            state.state = _DRAINING
        self._flight.record("drain", replica=name)
        try:
            return bool(state.handle.drain(timeout))
        except BaseException as exc:
            # a dead replica's drain dying with its process must not
            # wedge choreography (the autoscaler reaps through here)
            logger.info(f"router: drain of {name} failed ({exc!r})")
            return False

    def rejoin_replica(self, name: str) -> None:
        """Resume a drained replica and route to it again (the join
        half of rolling-restart choreography). Clears ejection
        bookkeeping: an operator rejoin is a statement the replica is
        believed healthy."""
        with self._lock:
            state = self._replicas.get(name)
            if state is None:
                raise KeyError(f"unknown replica {name!r}")
            state.handle.resume()
            state.state = _LIVE
            state.consecutive_failures = 0
            state.eject_count = 0
            state.probe_inflight = False
            state.health_at = float("-inf")
        self._m_rejoins.labels(name).inc()
        self._flight.record("rejoin", replica=name, cause="operator")
        self.trace_event("rejoin", replica=name, cause="operator")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Drain the WHOLE fleet (router stops admitting; every replica
        drains). Reversible with :meth:`resume`."""
        self._draining = True
        with self._lock:
            states = list(self._replicas.values())
        ok = True
        for state in states:
            with self._lock:
                state.state = _DRAINING
            self._flight.record("drain", replica=state.handle.name)
            ok = bool(state.handle.drain(timeout)) and ok
        return ok

    def resume(self) -> None:
        """Reopen the router and every drained replica."""
        self._draining = False
        with self._lock:
            names = [
                n for n, s in self._replicas.items() if s.state == _DRAINING
            ]
        for name in names:
            self.rejoin_replica(name)

    def close(self) -> None:
        # flush the pending fleet-lifecycle events to any exporter
        self._close_fleet_timeline()
        for state in list(self._replicas.values()):
            state.handle.close()

    # -- health / stats ----------------------------------------------------

    def health(self) -> dict:
        """The router's OWN readiness: ``ok`` while at least
        ``policy.min_live`` replicas are routable, ``degraded`` below
        the floor (shed at the balancer above instead of blackholing
        here), ``draining`` during a fleet drain. Per-replica states
        ride along for operators."""
        with self._lock:
            replicas = {
                name: {
                    "state": s.state,
                    "consecutive_failures": s.consecutive_failures,
                    "eject_count": s.eject_count,
                }
                for name, s in self._replicas.items()
            }
            live = sum(
                1 for s in self._replicas.values()
                if s.state in (_LIVE, _HALF_OPEN)
            )
        if self._draining:
            status = "draining"
        elif live < self.policy.min_live:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "live_replicas": live,
            "min_live": self.policy.min_live,
            "replicas": replicas,
        }

    def stats(self) -> dict:
        with self._lock:
            budget = self._budget_tokens
            replicas = {
                name: {
                    "state": s.state,
                    "consecutive_failures": s.consecutive_failures,
                    "eject_count": s.eject_count,
                }
                for name, s in self._replicas.items()
            }
        return {
            "engine": "router",
            "router": {
                "replicas": replicas,
                "retry_budget_tokens": round(budget, 3),
                "hedge_delay_s": round(self._hedge_delay_s(), 4),
                "latency_samples": len(self._latency),
            },
        }

    def replica_signals(self) -> Dict[str, dict]:
        """Per-replica router lifecycle state + the replica's OWN
        health (through the TTL cache, so polling this costs what a
        pick costs) + resident cache-block count — the autoscaler's
        one-stop signal read: queue depths, breaker states, burn
        scores, and cache warmth in one pass, without reaching into
        router internals."""
        now = self._clock()
        with self._lock:
            states = list(self._replicas.values())
        out: Dict[str, dict] = {}
        for state in states:
            health = self._health_of(state, now)
            try:
                blocks = int(state.handle.cache_blocks())
            except BaseException:
                blocks = 0
            out[state.handle.name] = {
                "state": state.state,
                "phase": getattr(state.handle, "phase", "colocated"),
                "version": self._replica_version(state.handle),
                "health": dict(health),
                "cache_blocks": blocks,
                "consecutive_failures": state.consecutive_failures,
            }
        return out

    def cached_prefix_len(self, prompt: Sequence[int]) -> int:
        """Fleet-wide longest cached prefix: the max over routable
        replicas' peeks. This is the router app's
        ``GET /debug/cache/peek`` source, so a router can front
        another router (or a balancer can probe a whole fleet) with
        cache affinity intact."""
        with self._lock:
            states = [
                s for s in self._replicas.values()
                if s.state in (_LIVE, _HALF_OPEN)
            ]
        best = 0
        for state in states:
            try:
                best = max(best, int(state.handle.cached_prefix_len(prompt)))
            except BaseException:
                continue  # a peek failure must never fail the probe
        return best

    def _notify_rollout(
        self, rid: str, name: str, prompt, max_new_tokens,
        tokens: List[int],
    ) -> None:
        """Offer one completed live dispatch to the rollout controller
        for shadowing. Never raises into the dispatch path, and costs
        one attribute read when no rollout is operating."""
        rollout = self.rollout
        if rollout is None:
            return
        try:
            rollout.observe_live(
                rid=rid, replica=name, prompt=prompt,
                max_new_tokens=max_new_tokens, tokens=tokens,
            )
        except BaseException:
            pass

    def _note_latency(self, name: str, seconds: float) -> None:
        """One successful dispatch's wall time: feeds the fleet-wide
        hedge-delay window AND the replica's least-request window."""
        self._latency.add(seconds)
        with self._lock:
            samples = self._replica_latency.get(name)
            if samples is None:
                samples = telemetry.SlidingSamples(
                    maxlen=self.policy.latency_window
                )
                self._replica_latency[name] = samples
        samples.add(seconds)

    # -- retry budget ------------------------------------------------------

    def _deposit_budget(self) -> None:
        with self._lock:
            self._budget_tokens = min(
                self.policy.retry_budget_burst,
                self._budget_tokens + self.policy.retry_budget_ratio,
            )

    def _spend_budget(self) -> bool:
        with self._lock:
            if self._budget_tokens >= 1.0:
                self._budget_tokens -= 1.0
                return True
        self._m_budget_exhausted.inc()
        return False

    # -- ejection lifecycle ------------------------------------------------

    def _record_failure(self, name: str, exc: BaseException) -> None:
        with self._lock:
            state = self._replicas.get(name)
            if state is None:
                return
            state.consecutive_failures += 1
            if state.state == _HALF_OPEN:
                # failed probe: immediately re-eject, doubled cooldown
                state.probe_inflight = False
                self._eject_locked(state, cause="probe_failed")
                return
            if (
                state.state == _LIVE
                and state.consecutive_failures >= self.policy.eject_consecutive
            ):
                self._eject_locked(state, cause=type(exc).__name__)

    def _eject_locked(self, state: _ReplicaState, *, cause: str) -> None:
        state.eject_count += 1
        cooldown = min(
            self.policy.eject_cooldown_s * (2 ** (state.eject_count - 1)),
            self.policy.eject_cooldown_max_s,
        )
        state.state = _EJECTED
        state.rejoin_at = self._clock() + cooldown
        name = state.handle.name
        self._m_ejections.labels(name).inc()
        self._flight.record(
            "eject", replica=name, cause=cause,
            consecutive=state.consecutive_failures,
            cooldown_s=round(cooldown, 3),
        )
        self.trace_event(
            "eject", replica=name, cause=cause,
            consecutive=state.consecutive_failures,
            cooldown_s=round(cooldown, 3),
        )
        logger.info(
            f"router: ejected {name} ({cause}, "
            f"{state.consecutive_failures} consecutive, "
            f"cooldown {cooldown:.1f}s)"
        )

    def _has_routable(self, exclude: Sequence[str] = ()) -> bool:
        """Cheap existence check: is any un-excluded replica routable
        right now? (Used by hedging to avoid spending a retry-budget
        token on a lane whose pick would fail instantly — e.g. a
        1-replica fleet with a slow request every tail.)"""
        now = self._clock()
        with self._lock:
            for state in self._replicas.values():
                if state.handle.name in exclude:
                    continue
                if state.state == _LIVE:
                    return True
                if state.state == _EJECTED and now >= state.rejoin_at:
                    return True
                if state.state == _HALF_OPEN and not state.probe_inflight:
                    return True
        return False

    def _release_probe(self, name: str) -> None:
        """Free a half-open replica's probe slot without resolving the
        probe either way — for dispatch exits that say nothing about
        the replica's health (caller abandoned the stream, non-
        retryable caller error). No-op unless the replica is still
        half-open (success rejoins, retryable failure re-ejects)."""
        with self._lock:
            state = self._replicas.get(name)
            if state is not None and state.state == _HALF_OPEN:
                state.probe_inflight = False

    def _record_success(self, name: str) -> None:
        with self._lock:
            state = self._replicas.get(name)
            if state is None:
                return
            state.consecutive_failures = 0
            if state.state == _HALF_OPEN:
                state.state = _LIVE
                state.probe_inflight = False
                state.eject_count = 0  # probe succeeded: reset the ladder
                self._m_rejoins.labels(name).inc()
                self._flight.record("rejoin", replica=name, cause="probe_ok")
                self.trace_event("rejoin", replica=name, cause="probe_ok")
                logger.info(f"router: {name} rejoined after probe")

    # -- picking -----------------------------------------------------------

    def _health_of(self, state: _ReplicaState, now: float) -> dict:
        """Cached replica health (TTL ``policy.health_ttl_s``): pick
        runs per request, HTTP health is a network call. Strict ``<``
        so ``health_ttl_s=0`` means "always fresh" (tests with a
        frozen clock rely on this)."""
        if now - state.health_at < self.policy.health_ttl_s:
            return state.health_cache
        try:
            h = state.handle.health()
        except BaseException as exc:
            h = {"status": "unreachable", "error": str(exc)}
        with self._lock:
            state.health_cache = h
            state.health_at = now
        return h

    def _pick(
        self, prompt: Sequence[int], exclude: Sequence[str] = (),
        version: Optional[str] = None, version_soft: bool = True,
        exclude_version: Optional[str] = None,
    ) -> ReplicaHandle:
        """Choose the dispatch target: over routable candidates, score
        ``cache_w * cached_fraction - queue_w * queue_depth -
        burn_w * burn`` and take the max (ties: round-robin). Raises
        :class:`EngineUnavailable` when nothing is routable.

        ``version`` narrows the candidate set to replicas serving that
        model version. A SOFT constraint (rollout split assignment)
        falls back to the full routable set when nothing serves it —
        a dying canary sheds its traffic share, never a caller error.
        A HARD constraint (``X-Model-Version`` pin) raises: the
        retryable :class:`EngineUnavailable` when the version exists
        but nothing serving it is routable right now, ``ValueError``
        (the deterministic 422 class) when the version is unknown to
        the fleet. ``exclude_version`` is the soft inverse: prefer
        candidates NOT serving that version (how unassigned traffic
        stays off the canary while a split is open)."""
        t0 = time.perf_counter()
        now = self._clock()
        with self._lock:
            candidates: List[_ReplicaState] = []
            for state in self._replicas.values():
                if state.handle.name in exclude:
                    continue
                if state.state == _EJECTED and now >= state.rejoin_at:
                    state.state = _HALF_OPEN
                    self._flight.record(
                        "probe", replica=state.handle.name
                    )
                    self.trace_event("probe", replica=state.handle.name)
                if state.state == _LIVE:
                    candidates.append(state)
                elif state.state == _HALF_OPEN and not state.probe_inflight:
                    # exactly one in-flight probe through a half-open
                    # replica; it is picked ONLY when no live replica
                    # remains un-excluded, or as the probe trickle below
                    candidates.append(state)
            rr = self._rr
            self._rr += 1
        if version is not None:
            matched = [
                c for c in candidates
                if self._replica_version(c.handle) == version
            ]
            if matched:
                candidates = matched
            elif not version_soft:
                with self._lock:
                    known = {
                        self._replica_version(s.handle)
                        for s in self._replicas.values()
                    }
                known.discard(None)
                if self.live_version is not None:
                    known.add(self.live_version)
                if version in known:
                    raise EngineUnavailable(
                        f"no routable replica serves model version "
                        f"{version!r}",
                        reason="no_live_replicas", retry_after_s=1.0,
                    )
                raise ValueError(
                    f"unknown model version {version!r} — this fleet "
                    f"serves {sorted(known)}"
                )
            # soft + no match: fall through on the full candidate set
        elif exclude_version is not None:
            # the inverse constraint: unpinned traffic NOT assigned to
            # the split keeps off the split version's replicas (the
            # canary receives exactly its percent/tenant share, never
            # load-balancer spillover). Soft — when ONLY split-version
            # capacity is live (promote endgame, mass ejection) serving
            # beats refusing.
            kept = [
                c for c in candidates
                if self._replica_version(c.handle) != exclude_version
            ]
            if kept:
                candidates = kept
        if not candidates:
            raise EngineUnavailable(
                "no live replicas (all ejected, draining, or excluded)",
                reason="no_live_replicas",
                retry_after_s=self.policy.eject_cooldown_s,
            )
        half_open = [c for c in candidates if c.state == _HALF_OPEN]
        live = [c for c in candidates if c.state == _LIVE]
        # route the probe when a half-open replica is due one: the
        # probe IS how it rejoins — starving it keeps capacity ejected.
        # The claim is check-and-set UNDER the lock: two concurrent
        # picks must not both probe the same replica.
        chosen = None
        if half_open and (not live or rr % 8 == 0):
            with self._lock:
                for c in half_open:
                    if c.state == _HALF_OPEN and not c.probe_inflight:
                        c.probe_inflight = True
                        chosen = c
                        break
            if chosen is None and not live:
                raise EngineUnavailable(
                    "no live replicas (half-open probes already in "
                    "flight)", reason="no_live_replicas",
                    retry_after_s=1.0,
                )
        if chosen is None:
            # reachable only with live candidates: the no-live case
            # either claimed a probe above or raised
            pool = live
            prompt_len = max(1, len(prompt))
            best, best_score = None, None
            for i, state in enumerate(pool):
                h = self._health_of(state, now)
                if h.get("status") in ("draining", "unreachable"):
                    continue
                try:
                    cached = state.handle.cached_prefix_len(prompt)
                except BaseException:
                    cached = 0
                score = (
                    self.policy.cache_weight * (cached / prompt_len)
                    - self.policy.queue_weight * float(h.get("queue_depth", 0))
                    - self.policy.burn_weight * float(h.get("burn", 0.0))
                )
                if self.policy.latency_weight > 0.0:
                    # weighted least-request: a replica's rolling mean
                    # dispatch latency (seconds) sheds its share
                    samples = self._replica_latency.get(state.handle.name)
                    if samples is not None and len(samples):
                        score -= self.policy.latency_weight * samples.mean()
                if h.get("breaker_open"):
                    score -= 100.0
                if h.get("status") == "degraded":
                    score -= 10.0
                # deterministic round-robin tie-break
                if best_score is None or score > best_score + 1e-12:
                    best, best_score = state, score
                elif abs(score - best_score) <= 1e-12 and best is not None:
                    if (i + rr) % len(pool) < (pool.index(best) + rr) % len(pool):
                        best = state
            if best is None:
                # every candidate's own health said draining/unreachable
                raise EngineUnavailable(
                    "no routable replicas (all draining or unreachable)",
                    reason="no_live_replicas",
                    retry_after_s=1.0,
                )
            chosen = best
        self._h_pick_ms.observe((time.perf_counter() - t0) * 1e3)
        return chosen.handle

    # -- dispatch envelope -------------------------------------------------

    def _backoff_s(self, attempt: int, retry_after_s: float) -> float:
        base = min(
            self.policy.backoff_base_s * (2 ** (attempt - 1)),
            self.policy.backoff_max_s,
        )
        jitter = (
            self._rng.random() * self.policy.jitter_s
            if self.policy.jitter_s > 0 else 0.0
        )
        return max(base + jitter, retry_after_s)

    def _hedge_delay_s(self) -> float:
        if len(self._latency) < self.policy.hedge_warmup:
            return max(self.policy.hedge_min_s, 1.0)
        return max(
            self.policy.hedge_min_s,
            self._latency.percentile(self.policy.hedge_quantile),
        )

    # -- stitched routing timeline ----------------------------------------

    def _open_timeline(self, prompt_tokens: int):
        """``(rid, ctx, tracer)`` for one routed request: when
        stitching is on, a ``kind="route"`` recorder timeline keyed by
        the routing rid, parented into the caller's ambient trace
        scope (the transport's server span on a router app) — ``ctx``
        is its root context, the parent every pick/attempt span hangs
        from. The OPENING recorder is returned and threaded through to
        the close: a mid-request ``tracer`` swap must finish the
        timeline in the recorder it was opened in, never leak it live
        in the old one. ``(rid, None, None)`` when the plane is off."""
        tracer = self._tracer
        rid = telemetry.new_request_id()
        if tracer is None:
            return rid, None, None
        rid = tracer.new_request(
            "route", rid=rid, prompt_tokens=int(prompt_tokens),
        )
        return rid, tracer.trace_context(rid), tracer

    @staticmethod
    def _finish_timeline(tracer, rid: str) -> None:
        if tracer is not None:
            tracer.finish_request(rid)

    def _attempt_scope(self, t_ctx, span_id):
        """The child context one dispatch attempt propagates: the
        replica's server-side timeline (in-process engine, or a remote
        transport via the ``traceparent`` header) parents to the
        ATTEMPT span, so retried/hedged dispatches nest under the
        attempt that caused them, not interleaved under one parent."""
        if t_ctx is None:
            return nullcontext()
        return telemetry.trace_scope(telemetry.TraceContext(
            t_ctx.trace_id, span_id, t_ctx.sampled,
        ))

    def generate_stream(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> Iterator[List[int]]:
        """Stream token chunks with transparent mid-stream failover: a
        replica dying after K emitted tokens re-dispatches on a
        survivor and replays past the first K (engines decode
        deterministically for a fixed prompt, so the survivor's tokens
        are the same stream — chaos-tested for token parity). The
        caller sees one uninterrupted stream or, only once every
        attempt is exhausted, the last error."""
        if self._draining:
            raise EngineUnavailable(
                "router is draining", reason="draining",
            )
        self._deposit_budget()
        # resolved ONCE, on the caller's thread (the pin is thread-
        # local), so every retry of this request stays on one version
        version, version_soft, excl_version = self._resolve_route_version()
        rid, t_ctx, tracer = self._open_timeline(len(prompt))
        inner = self._stream_with_failover(
            rid, prompt, max_new_tokens=max_new_tokens, t_ctx=t_ctx,
            tracer=tracer, version=version, version_soft=version_soft,
            exclude_version=excl_version,
        )
        if t_ctx is None:
            return inner
        # _TracedStream (not a plain generator): the timeline must
        # close on EVERY exit, including the caller dropping the
        # iterator without ever pulling it (a generator's finally
        # never runs for a never-started body — a leaked live
        # timeline forever)
        return _TracedStream(tracer, rid, inner)

    def _stream_with_failover(self, rid, prompt, *, max_new_tokens,
                              dispatch=None, initial_exclude=(),
                              t_ctx=None, tracer=None,
                              version=None, version_soft=True,
                              exclude_version=None,
                              notify_rollout=True):
        """The retry envelope. ``dispatch(replica) -> chunk iterator``
        defaults to the replica's streaming primitive; the blocking
        path passes a single-yield wrapper over ``replica.generate``
        so both surfaces share one pick/retry/budget/ejection
        implementation. ``initial_exclude`` seeds the exclusion list
        with replicas a caller already saw fail (the hedge fallback) —
        the soft exclusion: if nothing else is routable, the pick
        fallback below relaxes it. ``t_ctx`` (the routing timeline's
        root context, when stitching is on) turns every decision into
        a recorded span: ``pick``, per-dispatch ``attempt`` (whose
        pre-minted span id is the child context the replica's own
        spans nest under), ``backoff`` — recorded into ``tracer``, the
        recorder captured at open (a mid-request swap must not split a
        timeline across recorders)."""
        emitted = 0          # tokens already yielded to the caller
        collected: List[int] = []   # the full live answer (shadow diff)
        attempt = 1
        tried: List[str] = list(initial_exclude)
        last_exc: Optional[BaseException] = None
        while attempt <= self.policy.max_attempts:
            t_pick0 = time.perf_counter()
            try:
                replica = self._pick(
                    prompt, exclude=tried,
                    version=version, version_soft=version_soft,
                    exclude_version=exclude_version,
                )
            except EngineUnavailable:
                # every distinct replica tried: allow a repeat pick
                # (the survivor set may have recovered) only if some
                # replica exists at all
                if not tried:
                    raise
                tried = tried[-1:]
                try:
                    replica = self._pick(
                        prompt, exclude=tried,
                        version=version, version_soft=version_soft,
                        exclude_version=exclude_version,
                    )
                except EngineUnavailable:
                    if last_exc is not None:
                        raise last_exc
                    raise
            name = replica.name
            if tracer is not None:
                tracer.record_span(
                    rid, "pick", t_pick0, time.perf_counter(),
                    replica=name, attempt=attempt,
                )
            if attempt == 1:
                rver = self._replica_version(replica)
                if rver is not None:
                    self._flight.record(
                        "route", rid=rid, replica=name, version=rver,
                    )
                else:
                    self._flight.record("route", rid=rid, replica=name)
            else:
                self._m_retries.labels(name).inc()
            attempt_span = (
                telemetry.new_span_id() if tracer is not None else None
            )
            t0 = time.perf_counter()
            skip = emitted
            replayed = emitted   # tokens this attempt must regenerate
            try:
                with _rid_scope(rid), self._attempt_scope(
                    t_ctx, attempt_span
                ):
                    # dispatch AND the first chunk pull run inside the
                    # scopes: HttpReplica builds its X-Request-ID /
                    # traceparent headers here (eager), and an
                    # in-process engine's lazy generator creates its
                    # request timeline on the first next() — both must
                    # see the attempt's child context so cross-hop
                    # spans nest under THIS attempt
                    source = iter(
                        dispatch(replica) if dispatch is not None
                        else replica.generate_stream(
                            prompt, max_new_tokens=max_new_tokens
                        )
                    )
                    head = list(itertools.islice(source, 1))
                for chunk in itertools.chain(head, source):
                    # replay-skip: a retry regenerates from the start;
                    # tokens the caller already holds are dropped here
                    if skip >= len(chunk):
                        skip -= len(chunk)
                        continue
                    out = chunk[skip:] if skip else chunk
                    skip = 0
                    emitted += len(out)
                    collected.extend(out)
                    yield out
                self._note_latency(name, time.perf_counter() - t0)
                self._record_success(name)
                self._m_routed.labels(name, "ok").inc()
                # the shadow hook: the complete live answer (replay-
                # skip makes `collected` whole across retries) is
                # offered to an operating RolloutController for
                # duplicate dispatch onto the canary. Strictly
                # free-rider — enqueue-only, exception-proof, after
                # the caller already has every token. A partial-answer
                # leg (disagg prefill) opts out: a 1-token leg result
                # must not diff against a full canary answer.
                if notify_rollout:
                    self._notify_rollout(
                        rid, name, prompt, max_new_tokens, collected,
                    )
                if tracer is not None:
                    tracer.record_span(
                        rid, "attempt", t0, time.perf_counter(),
                        span_id=attempt_span, replica=name,
                        attempt=attempt, outcome="ok", replayed=replayed,
                    )
                return
            except BaseException as exc:
                if tracer is not None:
                    outcome = (
                        "abandoned" if isinstance(exc, GeneratorExit)
                        else "error"
                    )
                    tracer.record_span(
                        rid, "attempt", t0, time.perf_counter(),
                        span_id=attempt_span, replica=name,
                        attempt=attempt, outcome=outcome,
                        error=type(exc).__name__, replayed=replayed,
                    )
                if not _retryable(exc):
                    # includes GeneratorExit (caller abandoned the
                    # stream): if this dispatch was a half-open probe,
                    # free the probe slot — a vanished consumer must
                    # not pin the replica half-open forever
                    self._release_probe(name)
                    self._m_routed.labels(name, "error").inc()
                    raise
                last_exc = exc
                self._record_failure(name, exc)
                tried.append(name)
                if (
                    attempt >= self.policy.max_attempts
                    or not self._spend_budget()
                ):
                    # the FINAL failure was not hidden from the caller:
                    # it counts as error, never also as retried_away
                    # (sum over outcomes == dispatches)
                    self._m_routed.labels(name, "error").inc()
                    raise last_exc
                self._m_routed.labels(name, "retried_away").inc()
                delay = self._backoff_s(
                    attempt, getattr(exc, "retry_after_s", 0.0)
                )
                self._flight.record(
                    "retry", rid=rid, replica=name, attempt=attempt,
                    reason=type(exc).__name__, backoff_s=round(delay, 4),
                    emitted=emitted,
                )
                t_back0 = time.perf_counter()
                self._sleep(delay)
                if tracer is not None:
                    tracer.record_span(
                        rid, "backoff", t_back0, time.perf_counter(),
                        attempt=attempt, delay_s=round(delay, 4),
                    )
                attempt += 1
        raise last_exc if last_exc is not None else EngineUnavailable(
            "retry attempts exhausted", reason="no_live_replicas",
        )

    def generate(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> List[int]:
        """Blocking single-prompt generate through the full robustness
        envelope: routed, retried, and (when ``policy.hedge``) hedged
        against tail latency — the second dispatch goes to a different
        replica after the observed ``hedge_quantile`` delay; first
        finished answer wins and the loser is cancelled.

        Dispatches via the replica's BLOCKING primitive (one event
        wait, not per-chunk queue hops): the 1-replica passthrough
        must cost ~a pick, not a streaming detour — the bench holds
        it under 2% p99 vs the direct engine."""
        if self.policy.hedge:
            return self._hedged_generate(prompt, max_new_tokens=max_new_tokens)
        if self._draining:
            raise EngineUnavailable(
                "router is draining", reason="draining",
            )
        self._deposit_budget()
        version, version_soft, excl_version = self._resolve_route_version()
        rid, t_ctx, tracer = self._open_timeline(len(prompt))
        try:
            return self._collect(self._stream_with_failover(
                rid, prompt, max_new_tokens=max_new_tokens,
                dispatch=lambda rep: iter(
                    [rep.generate(prompt, max_new_tokens=max_new_tokens)]
                ),
                t_ctx=t_ctx, tracer=tracer,
                version=version, version_soft=version_soft,
                exclude_version=excl_version,
            ))
        finally:
            self._finish_timeline(tracer, rid)

    @staticmethod
    def _collect(stream: Iterator[List[int]]) -> List[int]:
        out: List[int] = []
        for chunk in stream:
            out.extend(chunk)
        return out

    def _hedged_generate(self, prompt, *, max_new_tokens) -> List[int]:
        if self._draining:
            raise EngineUnavailable("router is draining", reason="draining")
        self._deposit_budget()
        rid, t_ctx, tracer = self._open_timeline(len(prompt))
        try:
            return self._hedged_inner(
                rid, t_ctx, tracer, prompt, max_new_tokens,
            )
        finally:
            # success, fallback, or error alike: the routing timeline
            # closes exactly once, exporting lanes + win/lose events —
            # in the recorder it was OPENED in, swap-proof
            self._finish_timeline(tracer, rid)

    def _hedged_inner(
        self, rid, t_ctx, tracer, prompt, max_new_tokens,
    ) -> List[int]:
        delay_s = self._hedge_delay_s()
        # resolved on the caller's thread (pin/split are thread-local /
        # counter-ordered): both hedge lanes dispatch the SAME version,
        # or deterministic decode could not guarantee identical tokens
        version, version_soft, excl_version = self._resolve_route_version()
        done = threading.Event()
        results: List = [None, None]   # per-lane (tokens | exception)
        lanes: List[Optional[str]] = [None, None]
        lane_spans: List[Optional[str]] = [None, None]
        lane_t0: List[Optional[float]] = [None, None]
        lane_recorded = [False, False]  # under winner_lock: span written
        winner_lock = threading.Lock()
        winner: List[Optional[int]] = [None]

        def record_lane(idx: int, outcome: str, end_s: float) -> None:
            """Write lane ``idx``'s span exactly once — from the lane's
            own finally, OR from the coordinator when the LOSER is
            still mid-decode at win time (the routing timeline closes
            with the response; a span recorded after that would be
            dropped, and the loser would vanish from the stitch)."""
            if tracer is None or lane_t0[idx] is None:
                return
            with winner_lock:
                if lane_recorded[idx]:
                    return
                lane_recorded[idx] = True
            tracer.record_span(
                rid, "hedge-lane", lane_t0[idx], end_s,
                span_id=lane_spans[idx], lane=idx,
                replica=lanes[idx] or "none", outcome=outcome,
            )

        # scopes are thread-local: capture the caller's and re-open
        # them inside each lane so deadlines/tenants/traces — and the
        # ambient per-request token cap, which decides OUTPUT LENGTH
        # and therefore token parity across dispatch paths — survive
        # the hop onto worker threads
        deadline = current_deadline_ms()
        tenant = current_tenant()
        priority = current_priority()
        token_cap = current_token_cap()
        trace_ctx = telemetry.current_trace_context()

        def start_lane(idx: int, exclude: List[str]) -> threading.Thread:
            """Pre-mint the lane's span id and start time BEFORE the
            thread spawns: the coordinator's loser-span write must
            never lose the race against a lane thread the scheduler
            hasn't run yet (lane_t0 unset → record_lane would no-op,
            the lane's own finally would then record into a finished
            timeline, and the loser would vanish from the stitch)."""
            if tracer is not None:
                lane_spans[idx] = telemetry.new_span_id()
            lane_t0[idx] = time.perf_counter()
            thread = threading.Thread(
                target=lane, args=(idx, exclude), daemon=True,
            )
            thread.start()
            return thread

        def lane(idx: int, exclude: List[str]) -> None:
            # each lane is its own recorded span; the lane's child
            # context (trace id + lane span id) is what the replica's
            # spans nest under, so win AND lose lanes stay separable
            # in the stitched timeline
            if tracer is not None:
                lane_ctx = telemetry.TraceContext(
                    t_ctx.trace_id, lane_spans[idx], t_ctx.sampled,
                )
            else:
                lane_ctx = trace_ctx
            try:
                with deadline_scope(deadline), tenant_scope(tenant), \
                        priority_scope(priority), \
                        token_cap_scope(token_cap), \
                        telemetry.trace_scope(lane_ctx), _rid_scope(rid):
                    replica = self._pick(
                        prompt, exclude=exclude,
                        version=version, version_soft=version_soft,
                        exclude_version=excl_version,
                    )
                    lanes[idx] = replica.name
                    t0 = time.perf_counter()
                    out: List[int] = []
                    for chunk in replica.generate_stream(
                        prompt, max_new_tokens=max_new_tokens
                    ):
                        # abandon on the WINNER flag alone: `done` is
                        # cleared by the coordinator's wait loop, so a
                        # done.is_set() condition here would race it
                        # and let the loser decode to completion —
                        # doubling device work on exactly the degraded
                        # fleet hedging protects. winner[0] is set
                        # once, never cleared. A failed sibling leaves
                        # it None, so a healthy lane never aborts for
                        # a sibling's error.
                        with winner_lock:
                            lost = (
                                winner[0] is not None and winner[0] != idx
                            )
                        if lost:
                            return  # lost: stop consuming (abandon)
                        out.extend(chunk)
                    self._note_latency(replica.name, time.perf_counter() - t0)
                    self._record_success(replica.name)
                    results[idx] = out
            except BaseException as exc:  # noqa: BLE001 — relayed below
                results[idx] = exc
                if lanes[idx] is not None and _retryable(exc):
                    self._record_failure(lanes[idx], exc)
            finally:
                record_lane(
                    idx,
                    (
                        "error"
                        if isinstance(results[idx], BaseException)
                        else "ok" if results[idx] is not None
                        else "abandoned"
                    ),
                    time.perf_counter(),
                )
                if lanes[idx] is not None:
                    # lost-and-abandoned or non-retryable exits say
                    # nothing about health: free the probe slot if this
                    # lane was a half-open probe (no-op otherwise)
                    self._release_probe(lanes[idx])
                with winner_lock:
                    if winner[0] is None and not isinstance(
                        results[idx], BaseException
                    ) and results[idx] is not None:
                        winner[0] = idx
                done.set()

        self._flight.record("route", rid=rid, replica="<hedged>")
        t_first = start_lane(0, [])
        t_first.join(timeout=delay_s)
        hedged = False
        exclude = [lanes[0]] if lanes[0] else []
        # a second routable replica must EXIST before a budget token is
        # spent: on a 1-replica fleet every slow request would otherwise
        # drain the shared bucket on lanes whose pick fails instantly,
        # starving genuine retries exactly when the fleet is thin
        if (
            t_first.is_alive()
            and self._has_routable(exclude=exclude)
            and self._spend_budget()
        ):
            hedged = True
            self._flight.record(
                "hedge", rid=rid, after_s=round(delay_s, 4),
                exclude=exclude,
            )
            t_second = start_lane(1, exclude)
        while True:
            # short-timeout wait: a lane's done.set() landing between
            # our clear() and wait() must not strand this loop
            done.wait(timeout=0.05)
            done.clear()
            with winner_lock:
                w = winner[0]
            if w is not None:
                break
            # a lane finished with an error; if the other lane is
            # still running, keep waiting for it
            alive = t_first.is_alive() or (
                hedged and t_second.is_alive()
            )
            if not alive:
                break
        with winner_lock:
            w = winner[0]
        if w is None:
            # every lane failed. A retryable failure falls back to the
            # sequential retry envelope (the hedge must not WEAKEN the
            # robustness contract — without this, one transient
            # Overloaded before the hedge delay would surface to the
            # caller that the non-hedged path retries transparently);
            # the fallback's extra dispatch draws a budget token like
            # any other retry. Ejection was already recorded per lane.
            errs = [r for r in results if isinstance(r, BaseException)]
            last = errs[-1] if errs else None
            retrying = (
                last is not None and _retryable(last) and self._spend_budget()
            )
            # account both lanes' dispatches (outcome disjointness:
            # every dispatch lands in exactly one bucket, hedged or
            # not): hidden by the fallback retry -> retried_away,
            # surfaced to the caller -> error
            for name in lanes:
                if name:
                    self._m_routed.labels(
                        name, "retried_away" if retrying else "error"
                    ).inc()
            if retrying:
                failed = [n for n in lanes if n]
                self._flight.record(
                    "retry", rid=rid, replica=",".join(failed) or "none",
                    attempt=1, reason=type(last).__name__,
                    backoff_s=0.0, emitted=0,
                )
                # the fallback must not immediately re-pick the lanes
                # that JUST failed (cache affinity still scores an
                # un-ejected primary highest) — seed the envelope's
                # exclusion with them
                return self._collect(self._stream_with_failover(
                    rid, prompt, max_new_tokens=max_new_tokens,
                    dispatch=lambda rep: iter(
                        [rep.generate(prompt, max_new_tokens=max_new_tokens)]
                    ),
                    initial_exclude=failed,
                    t_ctx=t_ctx, tracer=tracer,
                    version=version, version_soft=version_soft,
                    exclude_version=excl_version,
                ))
            if last is not None:
                raise last
            raise EngineUnavailable(
                "hedged dispatch produced no result", reason="hedge_failed",
            )
        win_name = lanes[w] or "none"
        self._m_routed.labels(win_name, "ok").inc()
        if hedged:
            self._m_hedges.labels(win_name, "win").inc()
            if tracer is not None:
                tracer.record_event(rid, "hedge_win", replica=win_name)
                # the loser may still be mid-decode (it abandons at its
                # next chunk): write its span NOW, before the timeline
                # closes with the response
                record_lane(1 - w, "abandoned", time.perf_counter())
            lose = lanes[1 - w]
            if lose:
                self._m_hedges.labels(lose, "lose").inc()
                # the loser's dispatch gets its own disjoint outcome
                # (it was neither ok nor an error — it was sacrificed)
                self._m_routed.labels(lose, "hedge_lose").inc()
                if tracer is not None:
                    tracer.record_event(rid, "hedge_lose", replica=lose)
        self._notify_rollout(
            rid, win_name, prompt, max_new_tokens, results[w],
        )
        return results[w]


class _TracedStream:
    """A streaming-response iterator that finishes its routing
    timeline exactly once, on EVERY exit: exhaustion, error,
    ``close()`` (client disconnect → the transport closes the SSE
    source), or garbage collection of a never-started iterator. Holds
    the recorder the timeline was OPENED in, so a mid-stream tracer
    swap on the router cannot leak the timeline live."""

    __slots__ = ("_tracer", "_rid", "_inner", "_finished")

    def __init__(self, tracer, rid, inner):
        self._tracer = tracer
        self._rid = rid
        self._inner = inner
        self._finished = False

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self._tracer.finish_request(self._rid)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            # StopIteration included: the stream is over either way
            self._finish()
            raise

    def close(self) -> None:
        try:
            self._inner.close()
        finally:
            self._finish()

    def __del__(self):
        try:
            # close (not just finish): the inner envelope's finally
            # must record its abandoned-attempt span BEFORE the
            # timeline closes, or a GC'd stream loses its last span
            self.close()
        except BaseException:
            pass  # interpreter teardown: never raise from __del__


class _RouterModel:
    """The minimal model-shaped object :class:`RouterApp` mounts on the
    transports (a router has no artifact of its own — its replicas
    do)."""

    def __init__(self, name: str):
        self.name = name
        self.artifact = object()  # "loaded": the fleet is the artifact


def make_router_app(router: FleetRouter, *, name: str = "fleet-router",
                    federate: bool = True, **kwargs):
    """The fleet router behind the standard serving surface.

    Returns a :class:`~unionml_tpu_torch.serving.http.ServingApp` subclass
    instance whose predict paths dispatch through ``router`` — so BOTH
    transports (stdlib ``serve()``, :func:`~unionml_tpu_torch.serving
    .fastapi.create_fastapi_app`) mount the front door unchanged: it
    speaks the same HTTP dialect as the replicas behind it — 429/503/
    504 fault mapping, ``traceparent``/``X-Tenant-ID``/``X-Request-ID``
    echo, ``X-Deadline-Ms`` scope, ``/metrics``, ``/debug/flight``,
    ``/debug/trace`` included. ``health``/``stats``/``drain`` default
    to the router's own (override via kwargs like any ServingApp).

    The router app is also the fleet's ONE observability plane
    (docs/observability.md "Fleet observability"):

    - ``GET /metrics`` federates every replica's exposition under a
      ``replica`` label next to the router's own series (one scrape
      target for the fleet; ``federate=False`` restores the local-only
      body). A failed replica scrape degrades to its last-seen-or-
      absent series — never an error.
    - ``GET /debug/trace?rid=<X-Request-ID>`` answers with ONE
      stitched end-to-end timeline: the router's pick/attempt/backoff/
      hedge spans plus the involved replicas' server-side spans,
      correctly parented across the hop (in-process replicas merge
      through the shared recorder; HTTP replicas are fetched).
    - ``GET /debug/flight`` merges replica flight rings time-ordered
      under a ``replica`` tag; ``GET /debug/fleet`` is the operator
      dashboard (per-replica health/breaker/drain, queue depth, cache
      blocks, burn, usage headroom, last scale decision).
    - ``GET /debug/slo`` / ``GET /debug/usage`` answer with
      fleet-aggregated views (router-side watchdog/ledger + merged
      per-replica reports).

    Subclassing (not transport changes) keeps the transports' single
    dispatch seam: everything the handlers know about routing an app
    applies verbatim to the router app.
    """
    # imported here, not at module top: http.py must stay importable
    # without router.py and vice versa (no cycle)
    from unionml_tpu_torch.serving.http import ServingApp

    class _RouterServingApp(ServingApp):
        def __init__(self, router: FleetRouter, **kw):
            kw.setdefault("stats", router.stats)
            kw.setdefault("health", router.health)
            kw.setdefault("drain", router.drain)
            # the fleet-wide peek: a router app answers /debug/cache/
            # peek with the max over its replicas, so routers compose
            kw.setdefault("cache_peek", router.cached_prefix_len)
            # the app's telemetry sinks FOLLOW the router's: a router
            # built with an isolated tracer/flight/registry must not
            # silently serve /debug/trace?rid=, the fleet flight
            # merge, or /metrics from the process-global sinks its
            # routing timelines never land in
            kw.setdefault("registry", router._registry)
            kw.setdefault("flight", router._flight)
            if router.tracer is not None:
                kw.setdefault("tracer", router.tracer)
            super().__init__(_RouterModel(name), **kw)
            self.router = router
            self.federate = bool(federate)
            self._m_federation_failures = self.registry.counter(
                "unionml_router_federation_failures_total",
                "Replica observability fetches (metrics scrape, "
                "flight/trace pulls) that yielded NO data and degraded "
                "to absent series, by replica and surface (an "
                "HttpReplica serving its last-seen metrics body does "
                "not count — stale beats absent beats error; slo/usage "
                "pulls are uncounted, None legitimately means 'not "
                "wired' there).",
                ("replica", "surface"),
            )

        def setup_model(self):  # the fleet needs no artifact load
            return None

        # -- fleet observability plane --------------------------------

        # overall fan-out budget per fleet surface: slightly above one
        # HttpReplica obs_timeout_s, because fetches run CONCURRENTLY —
        # N wedged replicas must cost max(one timeout), never the sum
        # (a Prometheus scrape_timeout is ~10 s; a sequential walk of
        # three dead replicas would blow it and blind the operator to
        # the healthy fleet)
        FANOUT_TIMEOUT_S = 6.0

        def _fanout(self, items, fn) -> Dict[str, object]:
            """Fetch ``fn(handle)`` for every ``(name, handle)``: only
            ``remote`` handles (network fetches) go onto threads,
            concurrently under ONE overall deadline — in-process
            handles are lock-free local reads that must not pay a
            thread spawn per scrape. A replica that raises, or fails
            to answer inside the budget, maps to ``None`` (its daemon
            thread is abandoned, never joined past the deadline)."""
            if not items:
                return {}
            results: Dict[str, object] = {}
            threads = []
            for name, handle in items:
                if not getattr(handle, "remote", False):
                    try:
                        results[name] = fn(handle)
                    except BaseException:
                        results[name] = None
                    continue

                def run(name=name, handle=handle):
                    try:
                        results[name] = fn(handle)
                    except BaseException:
                        results[name] = None

                t = threading.Thread(target=run, daemon=True)
                t.start()
                threads.append(t)
            deadline = time.monotonic() + self.FANOUT_TIMEOUT_S
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            return {name: results.get(name) for name, _ in items}

        def metrics_text(self) -> str:
            """The federated ``GET /metrics`` body: the router's own
            registry plus every replica's exposition under a
            ``replica`` label (bounded by fleet membership). Replicas
            sharing THIS app's registry are skipped — their series are
            already in the local body under their own instance
            labels."""
            local = super().metrics_text()
            if not self.federate:
                return local
            items = []
            for rep_name, handle in self.router.members().items():
                if (
                    type(handle).metrics_text
                    is ReplicaHandle.metrics_text
                ):
                    # the handle never wired a metrics source ("None =
                    # nothing to federate"): absent by design, not a
                    # failure — counting it would climb the failure
                    # counter forever with nothing failing
                    continue
                try:
                    reg = handle.metrics_registry()
                except BaseException:
                    reg = None
                if reg is not None and reg is self.registry:
                    continue  # already in the local exposition
                items.append((rep_name, handle))
            texts: Dict[str, str] = {}
            for rep_name, body in self._fanout(
                items, lambda h: h.metrics_text(),
            ).items():
                if body is None:
                    self._m_federation_failures.labels(
                        rep_name, "metrics",
                    ).inc()
                elif body:
                    texts[rep_name] = body
            if not texts:
                return local
            return telemetry.merge_expositions(local, texts)

        def debug_flight(self, n=None, kind=None, rid=None, tenant=None,
                         phase=None):
            """The fleet ``GET /debug/flight``: the router's own ring
            (route/retry/eject/scale_* events) merged with every
            replica's ring under a ``replica`` tag, time-ordered on
            WALL-ANCHORED ``t_ms`` (epoch milliseconds): each host's
            raw monotonic readings are rebased by its own
            ``wall_offset_ms`` anchor, because monotonic epochs are
            per-boot and a long-lived replica host would otherwise
            sort after everything the router recorded — and a
            ``?n=`` cut would then drop exactly the router's own
            events. Cross-host order is NTP-accurate; within one host
            it stays monotonic-exact. Replicas sharing this app's
            recorder are skipped (already merged). The merged
            response reports ``wall_offset_ms: 0`` — its events are
            pre-anchored."""
            local = super().debug_flight(n=None, kind=kind, rid=rid,
                                         tenant=tenant, phase=phase)
            # local + in-process rings share THIS host's clock: one
            # anchor rebases them all (copies — the ring's own dicts
            # must never be mutated)
            local_off = telemetry.wall_clock_offset_ms()
            events = [
                {**e, "t_ms": round(e.get("t_ms", 0.0) + local_off, 3)}
                for e in local["events"]
            ]
            replicas_merged = []
            items = []
            for rep_name, handle in self.router.members().items():
                try:
                    ring = handle.flight_recorder()
                except BaseException:
                    ring = None
                if ring is not None and ring is self._flight:
                    continue  # same ring: already in the local dump
                items.append((rep_name, handle))
            # ?n= may thin the FETCH only when no filter is active:
            # with a kind/rid/tenant filter, a per-replica newest-n cut
            # would run BEFORE the filter and silently drop matching
            # events that n newer non-matching ones displaced — filter
            # first, truncate the merged stream last, exactly like
            # FlightRecorder.dump
            fetch_n = n if (kind is None and rid is None
                            and tenant is None and phase is None) else None
            handles = dict(items)
            for rep_name, fetched in self._fanout(
                items, lambda h: h.flight_events(n=fetch_n),
            ).items():
                if fetched is None:
                    self._m_federation_failures.labels(
                        rep_name, "flight",
                    ).inc()
                    continue
                if not fetched:
                    continue
                replicas_merged.append(rep_name)
                anchored = getattr(handles[rep_name], "remote", False)
                for event in fetched:
                    if not isinstance(event, dict):
                        continue
                    tagged = dict(event)
                    if not anchored:
                        # in-process ring: same host, local anchor
                        # (remote events arrive pre-anchored by
                        # HttpReplica.flight_events)
                        tagged["t_ms"] = round(
                            tagged.get("t_ms", 0.0) + local_off, 3,
                        )
                    tagged.setdefault("replica", rep_name)
                    if kind is not None and tagged.get("kind") != kind:
                        continue
                    if rid is not None and not (
                        tagged.get("rid") == rid
                        or rid in tagged.get("rids", ())
                    ):
                        continue
                    if tenant is not None and (
                        tagged.get("tenant") != tenant
                    ):
                        continue
                    if phase is not None and not (
                        tagged.get("phase") == phase
                        or phase in tagged.get("phases", ())
                    ):
                        continue
                    events.append(tagged)
            events.sort(key=lambda e: e.get("t_ms", 0.0))
            if n is not None:
                n_int = int(n)
                events = events[-n_int:] if n_int > 0 else []
            return {**local, "wall_offset_ms": 0.0, "events": events,
                    "merged_replicas": sorted(replicas_merged)}

        def debug_trace(self, format: str = "chrome", rid=None,
                        trace=None):
            """``GET /debug/trace`` on the front door. Without
            ``rid``/``trace``: the local recorder export, unchanged.
            With them: ONE stitched end-to-end timeline for that
            request — the base stitching over this app's recorder
            (transport + router + any shared-recorder engine spans)
            plus the involved replicas' spans fetched through their
            handles (HTTP replicas answer their own
            ``/debug/trace?trace=``), deduplicated by span id and
            sorted on the wall-anchored axis."""
            if rid is None and trace is None:
                return super().debug_trace(format)
            doc, content_type = super().debug_trace(
                format, rid=rid, trace=trace,
            )
            trace_id = doc.get("trace_id")
            if not trace_id:
                return doc, content_type
            seen = {s.get("span_id") for s in doc["spans"]}
            items = []
            for rep_name, handle in self.router.members().items():
                try:
                    recorder = handle.trace_recorder()
                except BaseException:
                    recorder = None
                if recorder is not None and recorder is self._tracer:
                    continue  # shared recorder: already stitched
                items.append((rep_name, handle))
            for rep_name, fetched in self._fanout(
                items, lambda h: h.stitched_spans(trace_id),
            ).items():
                if fetched is None:
                    self._m_federation_failures.labels(
                        rep_name, "trace",
                    ).inc()
                    continue
                spans, events = fetched
                for span in spans:
                    if not isinstance(span, dict):
                        continue
                    if span.get("span_id") in seen:
                        continue
                    seen.add(span.get("span_id"))
                    tagged = dict(span)
                    tagged.setdefault("replica", rep_name)
                    doc["spans"].append(tagged)
                for event in events:
                    if isinstance(event, dict):
                        tagged = dict(event)
                        tagged.setdefault("replica", rep_name)
                        doc["events"].append(tagged)
            doc["spans"].sort(key=lambda s: s.get("start_unix_ms", 0.0))
            doc["events"].sort(key=lambda e: e.get("t_unix_ms", 0.0))
            return doc, content_type

        def debug_slo(self) -> dict:
            """The fleet ``GET /debug/slo``: the router-side
            watchdog's report (when the app was built with ``slo=``)
            plus every replica's own evaluation, with the fleet-level
            max fast/slow burn and the union of breached objectives on
            top. 422 only when NOTHING anywhere runs a watchdog."""
            router_report = (
                self._slo.evaluate() if self._slo is not None else None
            )
            replicas: Dict[str, Optional[dict]] = dict(self._fanout(
                list(self.router.members().items()),
                lambda h: h.slo_report(),
            ))
            reports = [r for r in replicas.values() if r]
            if router_report is not None:
                reports.append(router_report)
            if not reports:
                raise ValueError(
                    "no SLO watchdog anywhere in the fleet — build the "
                    "router app with slo=SloWatchdog([...]) or the "
                    "replicas with per-replica watchdogs"
                )
            burn = {"fast": 0.0, "slow": 0.0}
            breached: List[str] = []
            for report in reports:
                for obj in report.get("objectives", ()):
                    for window in ("fast", "slow"):
                        rate = (
                            obj.get("windows", {})
                            .get(window, {})
                            .get("burn_rate", 0.0)
                        )
                        burn[window] = max(burn[window], float(rate))
                breached.extend(report.get("breached", ()))
            return {
                "fleet": {
                    "burn": burn,
                    "breached": sorted(set(breached)),
                },
                "router": router_report,
                "replicas": replicas,
            }

        def debug_goodput(self) -> dict:
            """The fleet ``GET /debug/goodput``: every replica's
            serving goodput report plus fleet-merged ratios recomputed
            on the SUMMED slot-step ledgers (a big engine's padding
            must outweigh a small one's — averaging per-replica ratios
            would weight them equally). 422 only when no replica runs
            the perf plane."""
            replicas: Dict[str, Optional[dict]] = dict(self._fanout(
                list(self.router.members().items()),
                lambda h: h.goodput_report(),
            ))
            reports = [r for r in replicas.values() if r]
            if not reports:
                raise ValueError(
                    "no serving goodput plane anywhere in the fleet — "
                    "build the replica engines with DecodeEngine("
                    "perf=True) (the default while introspect=True)"
                )
            passes: Dict[str, int] = {}
            slot_steps: Dict[str, float] = {}
            occupied = tokens = tokens_per_s = 0.0
            reasons: List[str] = []
            for report in reports:
                for kind, count in report.get("passes", {}).items():
                    passes[kind] = passes.get(kind, 0) + int(count)
                for kind, steps in report.get("slot_steps", {}).items():
                    slot_steps[kind] = (
                        slot_steps.get(kind, 0.0) + float(steps)
                    )
                occupied += float(report.get("occupied_slot_steps", 0))
                tokens += float(report.get("tokens", 0))
                tokens_per_s += float(report.get("tokens_per_s", 0.0))
                reasons.extend(
                    (report.get("watchdog") or {}).get("reasons", ())
                )
            idle = slot_steps.get("idle", 0.0)
            dispatched = sum(slot_steps.values()) - idle
            total = dispatched + idle
            return {
                "fleet": {
                    "replicas": len(reports),
                    "passes": passes,
                    "slot_steps": {
                        k: round(v, 3) for k, v in slot_steps.items()
                    },
                    "occupied_slot_steps": round(occupied, 3),
                    "goodput_ratio": (
                        round(occupied / total, 6) if total else 0.0
                    ),
                    "occupancy_ratio": (
                        round(occupied / dispatched, 6)
                        if dispatched else 0.0
                    ),
                    "tokens": int(tokens),
                    "tokens_per_s": round(tokens_per_s, 3),
                    "regressed": sorted(set(reasons)),
                },
                "replicas": replicas,
            }

        def debug_usage(self) -> dict:
            """The fleet ``GET /debug/usage``: per-replica ledger
            reports plus merged per-tenant vectors summed across the
            fleet (numeric fields add; distinct ledgers only — N
            replicas sharing ONE ledger merge once). 422 only when no
            ledger exists anywhere."""
            router_report = (
                self._usage.report() if self._usage is not None else None
            )
            replicas: Dict[str, Optional[dict]] = {}
            seen_ledgers = {id(self._usage)} if (
                self._usage is not None
            ) else set()
            merge_from: List[dict] = []
            if router_report is not None:
                merge_from.append(router_report)
            # in-process ledger-identity dedup happens BEFORE the
            # fan-out: N replicas sharing one ledger fetch it once
            items = []
            for rep_name, handle in self.router.members().items():
                try:
                    ledger = handle.usage_ledger()
                except BaseException:
                    ledger = None
                if ledger is not None:
                    if id(ledger) in seen_ledgers:
                        replicas[rep_name] = {"shared_ledger": True}
                        continue
                    seen_ledgers.add(id(ledger))
                items.append((rep_name, handle))
            fetched = self._fanout(items, lambda h: h.usage_report())
            for rep_name, _ in items:
                report = fetched.get(rep_name)
                replicas[rep_name] = report
                if report:
                    merge_from.append(report)
            if not merge_from:
                raise ValueError(
                    "no usage ledger anywhere in the fleet — build the "
                    "replicas with DecodeEngine(usage=True) or the "
                    "router app with usage=UsageLedger()"
                )
            tenants: Dict[str, dict] = {}
            totals = {"device_seconds": 0.0, "flops": 0.0, "tokens": 0}
            cap_steps = used_weighted = 0.0
            savings = 0
            for report in merge_from:
                for tenant_name, vector in report.get(
                    "tenants", {}
                ).items():
                    acc = tenants.setdefault(tenant_name, {})
                    for field, value in vector.items():
                        if isinstance(value, (int, float)):
                            acc[field] = acc.get(field, 0) + value
                for field in totals:
                    totals[field] += report.get("totals", {}).get(
                        field, 0
                    )
                savings += report.get("cache_savings_tokens", 0)
                capacity = report.get("capacity", {})
                steps = float(capacity.get("slot_steps", 0.0))
                cap_steps += steps
                used_weighted += steps * sum(
                    capacity.get("per_tenant", {}).values()
                )
            headroom = (
                max(0.0, 1.0 - used_weighted / cap_steps)
                if cap_steps > 0 else 1.0
            )
            return {
                "fleet": {
                    "tenants": tenants,
                    "totals": totals,
                    "cache_savings_tokens": savings,
                    "capacity": {
                        "slot_steps": cap_steps,
                        "headroom": round(headroom, 4),
                    },
                    "merged_reports": len(merge_from),
                },
                "router": router_report,
                "replicas": replicas,
            }

        def debug_fleet(self) -> dict:
            """``GET /debug/fleet``: the operator dashboard —
            :meth:`FleetRouter.fleet_report` (per-replica health/
            breaker/drain state, queue depth, cache blocks, burn,
            retry budget) plus the operating autoscaler's view (usage
            headroom, burn windows, last scale decision + reason) when
            one is attached."""
            return self.router.fleet_report()

        def debug_rollout(self) -> dict:
            """``GET /debug/rollout``: the rollout operator surface —
            stage, canary pool, split spec, shadow diff stats, streaks
            and decision history (docs/robustness.md "Rollouts &
            rollback"). 422 when no controller operates this router."""
            rollout = self.router.rollout
            if rollout is None:
                raise ValueError(
                    "no rollout controller operates this router — "
                    "construct a RolloutController(router, ...) first"
                )
            return rollout.dashboard()

        def predict(self, payload: dict):
            if self._draining:
                raise EngineUnavailable(
                    "router app is draining", reason="draining",
                )
            rows = _prompt_rows(payload)
            # the payload-contract token cap (422 on garbage), passed
            # explicitly so HttpReplica forwards it across a further hop
            cap = validate_token_cap(payload.get("max_new_tokens"))
            if len(rows) == 1:
                return [self.router.generate(rows[0], max_new_tokens=cap)]
            # multi-prompt: dispatch rows CONCURRENTLY so the replica
            # engines continuous-batch them, instead of serializing N
            # full generations behind one another (each worker re-opens
            # the caller's thread-local scopes, hedge-lane style)
            deadline = current_deadline_ms()
            tenant = current_tenant()
            priority = current_priority()
            # the version pin is thread-local like the rest: a pinned
            # multi-row predict must pin EVERY row's dispatch
            version_pin = current_model_version()
            trace_ctx = telemetry.current_trace_context()
            results: List = [None] * len(rows)

            def run(i: int) -> None:
                try:
                    with deadline_scope(deadline), tenant_scope(tenant), \
                            priority_scope(priority), \
                            model_version_scope(version_pin), \
                            telemetry.trace_scope(trace_ctx):
                        results[i] = self.router.generate(
                            rows[i], max_new_tokens=cap,
                        )
                except BaseException as exc:  # relayed in submit order
                    results[i] = exc

            threads = [
                threading.Thread(target=run, args=(i,), daemon=True)
                for i in range(len(rows))
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            return results

        def predict_stream(self, payload: dict):
            if self._draining:
                raise EngineUnavailable(
                    "router app is draining", reason="draining",
                )
            rows = _prompt_rows(payload)
            if len(rows) != 1:
                raise ValueError(
                    f"streaming serves one prompt per request, "
                    f"got {len(rows)}"
                )
            return self.router.generate_stream(
                rows[0],
                max_new_tokens=validate_token_cap(
                    payload.get("max_new_tokens")
                ),
            )

        def resume(self):
            super().resume()
            self.router.resume()

    return _RouterServingApp(router, **kwargs)


def _prompt_rows(payload: dict) -> List[List[int]]:
    """Token-prompt rows from a ``{"features": ...}`` payload (one
    prompt, or a list of prompts). The router tier speaks token ids —
    feature readers live on the replicas."""
    features = payload.get("features")
    if not features:
        raise ValueError(
            "router predict requires non-empty 'features' (a token-id "
            "prompt or a list of prompts)"
        )
    rows = (
        features
        if isinstance(features[0], (list, tuple)) else [features]
    )
    out = []
    for row in rows:
        if not row:
            raise ValueError("empty prompt")
        out.append([int(t) for t in row])
    return out
