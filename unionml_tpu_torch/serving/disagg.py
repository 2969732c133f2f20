"""Disaggregated prefill/decode serving: phase-split engine pools with
cross-engine KV block handoff.

The PyTorch port of :mod:`unionml_tpu.serving.disagg`, unchanged: the
handoff moves the port's host block trees (device → host store → device)
with the prefix cache's wire codecs across hosts.

Colocated serving makes prefill and decode fight for the same engine:
a long prompt's chunked prefill occupies the single admission lane and
steals dispatcher passes, so every resident decode stream — and every
short prompt queued behind it — stalls for the duration. The standard
production fix (DistServe, Zhong et al. 2024; Splitwise, Patel et al.
2024) splits the two phases onto SEPARATE engine pools: prefill
engines absorb the long, bursty prompt work; decode engines keep a
steady token-streaming cadence; the prompt's KV crosses between them.

This module is that architecture built from seams the stack already
has — the KV handoff IS the prefix-cache machinery:

- the **prefill leg** is a 1-token admission
  (:meth:`~unionml_tpu_torch.serving.engine.DecodeEngine.prefill_export`):
  the engine runs the prompt's (chunked) prefill through its normal
  admission path, the harvest finalizes the prompt's full KV blocks
  into the host prefix-cache block store (the same extract/insert
  every admission performs — pointer handoff, no extra copies), a
  :class:`~unionml_tpu_torch.serving.prefix_cache.PrefixLease` pins the
  exported path, and the sampled first token comes back as the
  caller's TTFT emission;
- the **decode leg** is a normal streaming admission on a decode
  engine: its prefix-cache match finds the handed-off blocks and
  SPLICES them (the warm-hit path), prefilling only the uncovered
  tail — then decodes with tokens bit-identical to the colocated run
  (the same determinism the router's mid-stream failover rides). The
  first token, regenerated deterministically, is replay-skipped.
- **same-host pools share one host block store** (construct both
  engines with the same :class:`~unionml_tpu_torch.serving.prefix_cache
  .RadixPrefixCache`): the handoff costs zero bytes. **Cross-host**,
  the router pulls the prefill replica's entries over
  ``POST /debug/kv/export`` and pushes them into the decode replica
  over ``POST /debug/kv/import`` (wire-encoded blocks; see
  :func:`~unionml_tpu_torch.serving.prefix_cache.encode_entries`).

Because the handoff is a CACHE transaction, the robustness story is
structural, not bolted on: a prefill replica dying between export and
splice — or a failed transfer, or a store that evicted the blocks —
just means the decode leg's match comes up short and it re-prefills
the difference. **Degrade, never error**: the caller sees identical
tokens either way. Both legs ride the full
:class:`~unionml_tpu_torch.serving.router.FleetRouter` envelope (retries,
budgets, ejection, mid-stream failover); the handle's lease releases
exactly once (idempotent) in a ``finally``, so retries and hedges can
neither double-bill nor leak pins; and short prompts — for which
colocated serving still wins (docs/serving.md) — bypass the prefill
pool entirely below ``handoff_min_tokens``.

Observability: both legs' pick/attempt spans land under ONE routing
rid, joined by ``prefill-leg`` → ``handoff`` → ``decode-leg`` spans
(``GET /debug/trace?rid=`` stitches them, replica server spans
included); flight ``handoff`` events carry both pools' phase tags;
``unionml_disagg_*`` series count legs, handoff outcomes, transferred
blocks, and per-pool membership.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional, Sequence

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.faults import DeadlineExceeded, EngineUnavailable
from unionml_tpu_torch.serving.router import (
    _EJECTED,
    _HALF_OPEN,
    _LIVE,
    FleetRouter,
    ReplicaHandle,
    _TracedStream,
)
from unionml_tpu_torch.serving.scheduler import PHASES

__all__ = ["DisaggRouter", "HANDOFF_RESULTS", "PHASES"]

# CLOSED handoff-outcome set (the unionml_disagg_handoffs_total{result}
# label): shared = same host store, pointer handoff; transfer = blocks
# crossed stores; cold = nothing usable arrived (the decode leg
# re-prefills — the degrade arm); skipped = transfer disabled.
HANDOFF_RESULTS = ("shared", "transfer", "cold", "skipped")

# CLOSED request-path set (unionml_disagg_requests_total{path}):
# two_leg = prefill pool + decode pool; single_leg = decode pool only
# (short prompt, or no prefill pool routable); degraded = a two-leg
# attempt whose prefill leg failed and fell back to a cold decode-side
# prefill (zero caller-visible failures by construction).
REQUEST_PATHS = ("two_leg", "single_leg", "degraded")


_phase_tls = threading.local()


@contextmanager
def _dispatch_phase(phase: Optional[str]) -> Iterator[None]:
    """Constrain picks on this thread to ``phase``-capable replicas
    (colocated replicas serve either phase). Thread-local like the
    router's rid scope: each leg's whole retry envelope — repeat
    picks included — stays inside its pool."""
    prev = getattr(_phase_tls, "phase", None)
    _phase_tls.phase = phase
    try:
        yield
    finally:
        _phase_tls.phase = prev


def _current_dispatch_phase() -> Optional[str]:
    return getattr(_phase_tls, "phase", None)


class DisaggRouter(FleetRouter):
    """A :class:`~unionml_tpu_torch.serving.router.FleetRouter` whose
    generative dispatch is phase-split (module docstring has the full
    story): replicas tagged ``phase="prefill"`` form the prefill pool,
    ``phase="decode"`` the decode pool, and ``colocated`` replicas
    serve either leg. Everything else — membership, health, ejection,
    drain/join, hedge policy knobs, ``make_router_app`` — is inherited
    unchanged, so the disaggregated front door mounts on both HTTP
    transports exactly like the plain router.

    Args:
        replicas: the fleet. At least one decode-capable replica
            (``decode`` or ``colocated``) is required — the decode
            pool is where streams live; a fleet with no DEDICATED
            prefill replica degrades to plain colocated routing.
        handoff_min_tokens: prompts SHORTER than this dispatch as one
            leg on the decode pool (colocated still wins for short
            prompts: the handoff round trip costs more than the
            prefill it saves — docs/serving.md derives the
            crossover). ``None`` sends every prompt two-leg.
        transfer: move KV entries between DISTINCT host stores (the
            cross-host ``/debug/kv/export``→``/debug/kv/import`` hop,
            or pointer imports between in-process stores). ``False``
            limits warm handoff to pools sharing one store; distinct
            stores then decode from a cold prefill (correct, slower).
        **kwargs: forwarded to :class:`FleetRouter` (policy, telemetry
            sinks, clock).
    """

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        *,
        handoff_min_tokens: Optional[int] = None,
        transfer: bool = True,
        **kwargs,
    ):
        if handoff_min_tokens is not None and handoff_min_tokens < 1:
            raise ValueError(
                f"handoff_min_tokens must be >= 1 when set, got "
                f"{handoff_min_tokens}"
            )
        if not any(
            getattr(r, "phase", "colocated") in ("decode", "colocated")
            for r in replicas
        ):
            raise ValueError(
                "DisaggRouter needs at least one decode-capable replica "
                "(phase='decode' or 'colocated') — streams live on the "
                "decode pool; a prefill-only fleet cannot serve"
            )
        self.handoff_min_tokens = handoff_min_tokens
        self.transfer = bool(transfer)
        super().__init__(replicas, **kwargs)
        self._sync_pool_gauges()

    # -- instruments -------------------------------------------------------

    def _build_instruments(self) -> None:
        super()._build_instruments()
        reg = self._registry
        self._m_disagg_requests = reg.counter(
            "unionml_disagg_requests_total",
            "Generative requests through the disaggregated router, by "
            "dispatch path (two_leg / single_leg / degraded — degraded "
            "= the prefill leg failed and the decode pool prefilled "
            "cold; never a caller-visible error).",
            ("path",),
        )
        self._m_handoffs = reg.counter(
            "unionml_disagg_handoffs_total",
            "KV handoffs between the prefill and decode legs, by "
            "outcome (shared = one host store, pointer handoff; "
            "transfer = entries crossed stores; cold = decode "
            "re-prefilled; skipped = transfer disabled).",
            ("result",),
        )
        self._m_kv_blocks = reg.counter(
            "unionml_disagg_kv_blocks_transferred_total",
            "Prefix-cache blocks moved between distinct host stores by "
            "the KV handoff (shared-store handoffs move pointers, not "
            "blocks, and count zero here).",
        )
        self._h_handoff_ms = reg.histogram(
            "unionml_disagg_handoff_ms",
            "KV handoff wall time (store-identity check + any "
            "cross-store export/import) between the legs.",
        )
        self._g_pool = reg.gauge(
            "unionml_disagg_pool_replicas",
            "Registered replicas per serving phase (membership, not "
            "routability — the per-pool fleet-size view).",
            ("phase",),
        )

    def _sync_pool_gauges(self) -> None:
        with self._lock:
            counts = {p: 0 for p in PHASES}
            for s in self._replicas.values():
                counts[getattr(s.handle, "phase", "colocated")] += 1
        for p, c in counts.items():
            self._g_pool.labels(p).set(float(c))

    def add_replica(self, handle: ReplicaHandle) -> None:
        super().add_replica(handle)
        self._sync_pool_gauges()

    def remove_replica(self, name: str, *, drain_timeout: float = 30.0) -> bool:
        out = super().remove_replica(name, drain_timeout=drain_timeout)
        self._sync_pool_gauges()
        return out

    # -- phase-aware picking ----------------------------------------------

    def _pick(
        self, prompt: Sequence[int], exclude: Sequence[str] = (),
        **kw,
    ) -> ReplicaHandle:
        """The inherited scored pick, constrained to the ambient leg's
        pool: replicas of the OTHER dedicated phase are excluded
        (colocated replicas serve either leg). The exclusion is
        re-derived on every call, so the envelope's repeat-pick
        fallback can never leak a decode stream onto the prefill
        pool. Version constraints (``version=``/``version_soft=``,
        docs/robustness.md "Rollouts & rollback") pass through to the
        base pick and compose with the phase filter."""
        phase = _current_dispatch_phase()
        if phase is not None:
            with self._lock:
                wrong = [
                    n for n, s in self._replicas.items()
                    if getattr(s.handle, "phase", "colocated")
                    not in (phase, "colocated")
                ]
            if wrong:
                exclude = list(exclude) + wrong
        return super()._pick(prompt, exclude=exclude, **kw)

    def _has_routable_phase(self, phase: str) -> bool:
        """Does a DEDICATED ``phase`` replica look routable right now?
        (Membership-level peek, same states a pick would consider —
        decides whether a two-leg dispatch is worth attempting.)"""
        now = self._clock()
        with self._lock:
            for s in self._replicas.values():
                if getattr(s.handle, "phase", "colocated") != phase:
                    continue
                if s.state == _LIVE:
                    return True
                if s.state == _EJECTED and now >= s.rejoin_at:
                    return True
                if s.state == _HALF_OPEN and not s.probe_inflight:
                    return True
        return False

    # -- the two-leg dispatch ---------------------------------------------

    def generate_stream(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> Iterator[List[int]]:
        """Stream token chunks through the phase-split pipeline: the
        prefill leg's first token arrives as soon as the prefill pool
        finishes the prompt (the TTFT the architecture exists for),
        then the decode leg streams the rest from spliced KV. Short
        prompts (< ``handoff_min_tokens``) and fleets without a
        prefill pool dispatch as a single decode-pool leg. Every exit
        releases the handle's lease exactly once."""
        if self._draining:
            raise EngineUnavailable(
                "router is draining", reason="draining",
            )
        self._deposit_budget()
        # resolved once on the caller's thread: BOTH legs of a pinned/
        # split request must land on the same model version, or the
        # decode leg would splice KV produced under different weights
        version, version_soft, excl_version = self._resolve_route_version()
        rid, t_ctx, tracer = self._open_timeline(len(prompt))
        inner = self._two_leg_stream(
            rid, [int(t) for t in prompt], max_new_tokens, t_ctx, tracer,
            version, version_soft, excl_version,
        )
        if t_ctx is None:
            return inner
        return _TracedStream(tracer, rid, inner)

    def generate(
        self, prompt: Sequence[int], *, max_new_tokens: Optional[int] = None,
    ) -> List[int]:
        """Blocking collect over :meth:`generate_stream` — the two-leg
        pipeline is streaming-first (the first token IS the handoff
        boundary), so the blocking surface rides it. Hedging, a
        blocking-only optimization on the base router, does not apply
        to phase-split dispatch; each leg still gets the full retry
        envelope."""
        return self._collect(
            self.generate_stream(prompt, max_new_tokens=max_new_tokens)
        )

    def _two_leg_stream(self, rid, prompt, max_new_tokens, t_ctx, tracer,
                        version=None, version_soft=True,
                        exclude_version=None):
        handle: Optional[dict] = None
        prefill_replica: Optional[ReplicaHandle] = None
        emitted = 0
        path = "single_leg"
        # the handle's ONE home for lease accounting: prefill_dispatch
        # stores it here the moment the export succeeds, BEFORE the
        # TTFT token is yielded — so a caller closing the stream right
        # after its first chunk (GeneratorExit at the yield) still
        # reaches the finally with the live lease in hand. The local
        # `handle` below is only the transfer-decision view.
        box: dict = {}
        want_two_leg = self._has_routable_phase("prefill") and (
            self.handoff_min_tokens is None
            or len(prompt) >= self.handoff_min_tokens
        )
        try:
            if want_two_leg:
                path = "two_leg"

                def prefill_dispatch(replica):
                    h = replica.prefill_export(
                        prompt, max_new_tokens=max_new_tokens,
                    )
                    box["handle"] = h
                    box["replica"] = replica
                    return iter([[int(t) for t in h["tokens"]]])

                t_leg0 = time.perf_counter()
                try:
                    with _dispatch_phase("prefill"):
                        for chunk in self._stream_with_failover(
                            rid, prompt, max_new_tokens=max_new_tokens,
                            dispatch=prefill_dispatch, t_ctx=t_ctx,
                            tracer=tracer, version=version,
                            version_soft=version_soft,
                            exclude_version=exclude_version,
                            # a prefill leg's 1-token result is not a
                            # full answer: never offer it for shadowing
                            notify_rollout=False,
                        ):
                            emitted += len(chunk)
                            yield chunk  # the TTFT emission
                    handle = box.get("handle")
                    prefill_replica = box.get("replica")
                    if tracer is not None:
                        tracer.record_span(
                            rid, "prefill-leg", t_leg0,
                            time.perf_counter(),
                            replica=getattr(
                                prefill_replica, "name", None
                            ),
                            tokens=emitted,
                        )
                except GeneratorExit:
                    raise  # caller abandoned: never mask it
                except Exception as exc:
                    if isinstance(exc, (ValueError, DeadlineExceeded)):
                        # the caller's own fault, deterministically:
                        # a bad request fails identically on every
                        # replica and an expired deadline arrives just
                        # as expired — a second dispatch is doomed
                        # work wearing a "degraded" label. Surface it.
                        raise
                    # the prefill POOL failed this request's leg after
                    # its whole retry envelope (infra-class errors
                    # only): DEGRADE — the decode pool prefills cold
                    # and the caller never sees an error. Tokens
                    # already emitted (a leg that died after its
                    # single yield) are replay-skipped below exactly
                    # like mid-stream failover.
                    path = "degraded"
                    handle = None
                    if tracer is not None:
                        tracer.record_span(
                            rid, "prefill-leg", t_leg0,
                            time.perf_counter(),
                            outcome="degraded",
                            error=type(exc).__name__,
                        )
                    self._flight.record(
                        "handoff", rid=rid, result="cold",
                        degraded=True, error=type(exc).__name__,
                        phases=["prefill", "decode"],
                    )
                    logger.info(
                        f"disagg: prefill leg failed ({exc!r}); "
                        "decode pool prefills cold"
                    )
                if (
                    handle is not None
                    and max_new_tokens is not None
                    and emitted >= int(max_new_tokens)
                ):
                    return  # 1-token request: the prefill leg IS the answer

            def decode_dispatch(replica):
                if handle is not None:
                    self._handoff(
                        rid, tracer, prefill_replica, replica, handle,
                        prompt,
                    )
                return replica.generate_stream(
                    prompt, max_new_tokens=max_new_tokens,
                )

            t_leg1 = time.perf_counter()
            skip = emitted
            with _dispatch_phase("decode"):
                for chunk in self._stream_with_failover(
                    rid, prompt, max_new_tokens=max_new_tokens,
                    dispatch=decode_dispatch, t_ctx=t_ctx, tracer=tracer,
                    version=version, version_soft=version_soft,
                    exclude_version=exclude_version,
                ):
                    # the decode engine deterministically regenerates
                    # the first token(s) the prefill leg already
                    # emitted — drop them, the failover replay-skip
                    # discipline applied across legs
                    if skip >= len(chunk):
                        skip -= len(chunk)
                        continue
                    out = chunk[skip:] if skip else chunk
                    skip = 0
                    yield out
            if tracer is not None and (want_two_leg or path == "single_leg"):
                tracer.record_span(
                    rid, "decode-leg", t_leg1, time.perf_counter(),
                )
        finally:
            self._m_disagg_requests.labels(path).inc()
            exported = box.get("handle")
            if exported is not None:
                lease = exported.get("lease")
                if lease is not None:
                    # exactly-once by idempotence: retries, degrades,
                    # error exits, AND a caller abandoning the stream
                    # mid-leg all funnel here — the exported path
                    # unpins once the stream is over, however it ended
                    lease.release()

    def _handoff(
        self, rid, tracer, src: Optional[ReplicaHandle],
        dst: ReplicaHandle, handle: dict, prompt: Sequence[int],
    ) -> None:
        """Make the prefill leg's KV reachable from ``dst`` before its
        dispatch: same-store pools need nothing (pointer handoff);
        distinct stores move entries (in-process: pointer imports;
        cross-host: the ``/debug/kv/export``→``/debug/kv/import``
        wire hop). Runs per decode ATTEMPT, so a failover survivor is
        warmed too. Every failure degrades to a cold decode-side
        prefill — this method never raises."""
        t0 = time.perf_counter()
        result, blocks = "cold", 0
        try:
            src_store = src.kv_store() if src is not None else None
            if src_store is not None and src_store is dst.kv_store():
                result = "shared"
            elif not self.transfer:
                result = "skipped"
            elif src is not None:
                if (
                    hasattr(src, "_kv_export_wire")
                    and hasattr(dst, "_kv_import_wire")
                ):
                    # remote→remote: relay the wire form untouched —
                    # decoding megabytes of KV into numpy only to
                    # re-encode the identical bytes is pure churn on
                    # the handoff critical path (and it re-runs per
                    # decode failover attempt)
                    blocks = int(dst._kv_import_wire(
                        src._kv_export_wire(prompt)
                    ))
                else:
                    entries = src.export_request_blocks(prompt)
                    if entries:
                        blocks = int(dst.import_cache_blocks(entries))
                # "transfer" means blocks actually LANDED: a donor
                # with entries whose importer attached nothing (byte
                # budget) is a cold decode in practice, and the label
                # exists to surface exactly that
                if blocks > 0:
                    result = "transfer"
        except Exception as exc:
            result = "cold"
            logger.info(
                f"disagg: KV transfer to {dst.name} failed ({exc!r}); "
                "decode leg prefills cold"
            )
        self._m_handoffs.labels(result).inc()
        if blocks:
            self._m_kv_blocks.inc(blocks)
        now = time.perf_counter()
        # exemplar-tagged: /debug/tail?metric=unionml_disagg_handoff_ms
        # resolves a slow handoff straight to its stitched timeline
        self._h_handoff_ms.observe((now - t0) * 1e3, exemplar=rid)
        self._flight.record(
            "handoff", rid=rid, result=result, blocks=blocks,
            handoff_ms=round((now - t0) * 1e3, 3),
            prefill_replica=getattr(src, "name", None),
            decode_replica=dst.name,
            cached_tokens=int(handle.get("cached_tokens", 0) or 0),
            phases=["prefill", "decode"],
        )
        if tracer is not None:
            tracer.record_span(
                rid, "handoff", t0, now, result=result, blocks=blocks,
                replica=dst.name,
            )
