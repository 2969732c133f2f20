"""Continuous-batching decode engine: step-boundary request joins.

The port of :mod:`unionml_tpu.serving.engine`'s ``DecodeEngine`` in its
two layouts, contiguous and block-paged. The host machinery carries over
in logic: the waiting room, chunked admission (``prefill_chunk``), the
dispatcher thread that never waits for the device and the harvester
thread that does, per-slot generation counters, the epoch-tagged
``_recover``, the circuit breaker, ``drain``/``resume``, deadlines, the
``FaultInjector`` points, the paged allocator with fence-deferred frees
and reservation at submit, usage metering and the serving perf plane.

The device programs are plain functions on tensors that update the
resident state IN PLACE (the reference donates it to a jitted program):

- the decode chunk is a Python loop of ``chunk_steps`` single-token
  steps (the reference's ``lax.scan``), with ``live``, ``done``,
  ``fill`` and ``last_tok`` kept on the device — nothing in the loop
  reads a device value on the host;
- a monolithic admission prefills a fresh ``[1, bucket]`` cache and
  writes it into the slot's rows (contiguous) or scatters it into the
  slot's pool blocks with one indexed write per buffer (paged);
- each chunk's ``[chunk_steps, slots]`` tokens are copied into pinned
  host memory without blocking and a CUDA event is recorded after the
  copy; the harvester waits on that event (never on the whole device),
  so "harvested" means the chunk finished on the card — what the
  fence-deferred frees of the paged pool need.

With ``draft_module`` the engine is SPECULATIVE (contiguous layout
only, as in the reference): each decode chunk is ``chunk_steps`` rounds
of per-slot draft proposals and ONE shared ``[slots, k+1]`` verify
forward of the target, with greedy acceptance, eos truncation and fill
advance kept on the device; the host reads each round's emissions through
the same pinned copy and event.

On the CPU (the tests) the same code runs synchronously.

Not ported yet, and refused at construction (ROADMAP.md): the prefix
cache and ``system_prefix`` with
``prefill_export`` / ``kv_export`` / ``kv_import``, and preemption
(``SchedulerConfig(preempt=True)``, which needs the prefix cache). An
injected fault (``FaultInjector``) is recovered as in the reference; a
real CUDA error is sticky for the process and cannot be recovered by
rebuilding state — the engine then fails every later request.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    current_deadline_ms,
)
from unionml_tpu_torch.serving.kv_pool import KVBlockPool, PoolExhausted
from unionml_tpu_torch.serving.scheduler import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    PreemptiveScheduler,
    SchedulerConfig,
    current_priority,
    current_token_cap,
    priority_rank,
    validate_phase,
    validate_priority,
)
from unionml_tpu_torch.serving.usage import (
    DEFAULT_TENANT,
    current_tenant,
    validate_tenant,
)

__all__ = ["DecodeEngine"]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: a FRESH
    pinned copy per call, sent with ``non_blocking`` (PyTorch's pinned
    allocator keeps the block from reuse until the copy has run, so an
    upload still in flight can never see its source overwritten)."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.clone().to(device)
    return host.pin_memory().to(device, non_blocking=True)


class _Readback:
    """A device tensor on its way to the host: on CUDA a non-blocking
    copy into pinned memory followed by an event; :meth:`wait` blocks on
    that event alone (the dispatcher keeps launching meanwhile)."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach().clone()
            self._event = None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclass
class _Admission:
    """A chunked prefill in progress: host cursor over the lead chunks.

    The fresh cache lives here, not in the engine state, so lead chunks
    and decode chunks never touch the same buffers and interleave freely
    in dispatch order."""

    req: "_Request"
    slot: int
    bucket: int
    chunk: int                      # tokens per program (prefill_chunk)
    n_chunks: int                   # total programs incl. the final
    padded: np.ndarray              # [bucket] right-padded prompt
    fresh: Any                      # [1, bucket] cache being filled
    # paged mode: the slot's pool block ids for the final scatter
    # ([bucket/block] int32; uncovered tail entries = trash block)
    pool_ids: Optional[np.ndarray] = None
    next_chunk: int = 0


@dataclass(eq=False)  # identity semantics: the waiting room's parked
# lane membership tests (`req in parked`) must never field-compare two
# requests — the numpy prompt would make `==` ambiguous
class _Request:
    prompt: np.ndarray                  # int32 [P], truncated to max bucket
    max_new_tokens: int
    submitted: float = field(default_factory=time.perf_counter)
    tokens: List[int] = field(default_factory=list)
    event: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    # streaming consumers: harvested token chunks are mirrored here as
    # they land (lists of ints; None terminates)
    stream: Optional["queue.Queue"] = None
    # observability (ms), measured at token HARVEST: each includes one
    # in-flight readback lag. ttft_ms is submit→first-harvested-token.
    queue_wait_ms: float = 0.0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    ttft_ms: float = 0.0
    abandoned: bool = False             # waiter gave up (timeout): retire asap
    rid: str = ""                       # telemetry trace-span request id
    tenant: str = DEFAULT_TENANT        # usage metering
    priority: str = DEFAULT_PRIORITY    # waiting-room class
    # absolute perf_counter deadline (None = none): checked at DEQUEUE
    deadline: Optional[float] = None
    _prefill_end: float = 0.0
    _dispatch_t: float = 0.0
    _expected: int = 0                  # tokens covered by dispatched work
    _chunk_i: int = 0                   # harvested decode chunks (trace names)
    _prefilled_tokens: int = 0          # prompt tokens actually prefilled
    # paged mode: device pool bookkeeping (engine lock guards all three)
    _block_ids: List[int] = field(default_factory=list)  # taken pool blocks
    _resv_blocks: int = 0               # reserved, not yet taken
    _rows_cap: int = 0                  # prompt + max_new (block budget)
    _park_logged: bool = False          # one pool_pressure event per park
    _pool_gen: int = 0                  # pool generation at reservation
    # usage metering: pool-block take timestamps and dispatched-prefill
    # FLOPs (0 until programs carry analytic costs)
    _block_t0: List[float] = field(default_factory=list)
    _attr_flops: float = 0.0
    # serving goodput plane: host-side admission span and ITL anchors
    admission_ms: float = 0.0
    _itl_anchor: float = 0.0
    _itl_sum_ms: float = 0.0
    _itl_n: int = 0

    def emit(self, chunk: List[int]) -> None:
        if self.stream is not None and chunk:
            self.stream.put(chunk)

    def finish_stream(self) -> None:
        if self.stream is not None:
            self.stream.put(None)


class DecodeEngine:
    """Continuous-batching generation over a fixed slot batch.

    ``generate(params, prompts)`` is thread-safe and blocking — concurrent
    callers' requests join the resident decode at chunk boundaries. Use as
    an ``@model.predictor`` body with ``ServingApp(batch=False)`` (each
    HTTP thread submits directly; batching happens *here*).

    Args (as in the reference unless noted):
        module: a cache-capable decoder (``unionml_tpu_torch.models.Llama``).
        slots: resident batch size — the max concurrent decodes.
        max_new_tokens: per-request generation cap.
        prompt_buckets: prompt lengths; prompts are left-truncated to the
            largest. The contiguous cache is sized ``max(buckets) +
            max_new_tokens + (pipeline_depth + 1) * chunk_steps`` rows.
        prefill_chunk: buckets LARGER than this admit in
            ``prefill_chunk``-token programs interleaved with decode
            chunks (buckets must be multiples of it).
        chunk_steps: decode steps per dispatched chunk.
        pipeline_depth: max decode chunks in flight before harvest.
        temperature/top_k/top_p/eos_id/pad_id: sampling, as
            :func:`~unionml_tpu_torch.models.generate.make_generator`.
        seed: seeds the engine's one :class:`torch.Generator` on its
            device (the reference's PRNG key).
        registry/tracer/flight: telemetry sinks (process-global default).
        max_queue_depth/breaker_*/fault_injector: admission control, the
            circuit breaker and the chaos points ``engine.prefill`` /
            ``engine.dispatch`` / ``engine.harvest`` / ``engine.dequeue``.
        introspect: program tracking (calls and host time per device
            program, :class:`~unionml_tpu_torch.introspection
            .ProgramTracker`) and flight recording.
        usage: a :class:`~unionml_tpu_torch.serving.usage.UsageLedger` (or
            ``True``) for per-tenant metering.
        perf: the serving goodput plane (defaults on with ``introspect``).
        paged/kv_pool_bytes/kv_pool_blocks/kv_block_size: block-paged
            device KV — one global pool of ``kv_block_size``-token blocks
            (default 16) with a per-slot int32 block table grown as
            decode proceeds; admission reserves a request's worst case,
            a transiently full pool parks the admission, a request that
            can never fit is rejected ``Overloaded`` at submit. Decode
            attention runs through :mod:`~unionml_tpu_torch.ops
            .paged_attention` (``paged_impl`` of the module's config).
        scheduler: a :class:`~unionml_tpu_torch.serving.scheduler
            .SchedulerConfig` for the waiting room (preemption is not
            ported).
        device: where the resident state lives; ``None`` = CUDA, raising
            without a card. The params passed to :meth:`generate` must
            live there.
        draft_module: a smaller same-vocabulary decoder enabling
            speculative decoding: each decode chunk becomes
            ``chunk_steps`` rounds of per-slot draft proposals plus ONE
            shared ``[slots, k+1]`` verify forward, with greedy
            acceptance advancing per-slot fills — token-identical to
            plain greedy decoding of the target for any draft.
            ``bind``/``generate`` then take the ``{"target": ...,
            "draft": ...}`` params mapping. Greedy only; not with
            ``paged`` or ``prefix_cache``.
        speculate_k: draft tokens proposed per round (k+1 emitted at
            most; a round costs k+1 draft steps and one (k+1)-token
            verify).
        system_prefix/prefix_cache: not ported; anything but the
            defaults raises ``NotImplementedError``.
    """

    def __init__(
        self,
        module,
        *,
        slots: int = 8,
        max_new_tokens: int = 32,
        prompt_buckets: Sequence[int] = (64,),
        prefill_chunk: Optional[int] = None,
        chunk_steps: int = 8,
        pipeline_depth: int = 8,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        seed: int = 0,
        submit_timeout: float = 300.0,
        system_prefix: Optional[Sequence[int]] = None,
        draft_module=None,
        speculate_k: int = 4,
        prefix_cache=None,
        registry: Optional[telemetry.MetricsRegistry] = None,
        tracer: Optional[telemetry.TraceRecorder] = None,
        max_queue_depth: Optional[int] = None,
        breaker_threshold: int = 3,
        breaker_window_s: float = 30.0,
        breaker_cooldown_s: float = 5.0,
        fault_injector=None,
        introspect: bool = True,
        flight=None,
        usage=None,
        perf=None,
        paged: bool = False,
        kv_pool_bytes: Optional[int] = None,
        kv_pool_blocks: Optional[int] = None,
        kv_block_size: Optional[int] = None,
        scheduler: Optional[SchedulerConfig] = None,
        phase: Optional[str] = None,
        device: DeviceLike = None,
    ):
        from unionml_tpu_torch.models.generate import make_sampler

        self.draft = draft_module
        self.speculate_k = int(speculate_k)
        if self.draft is not None:
            if temperature != 0.0:
                raise ValueError(
                    "the speculative engine is greedy-only (sampled speculation "
                    "needs the rejection-sampling correction; match "
                    "make_speculative_generator)"
                )
            if prefix_cache not in (None, False):
                raise ValueError(
                    "the speculative engine does not compose with the prefix "
                    "KV-cache — the draft model would need a mirrored block "
                    "store; drop prefix_cache"
                )
            if self.draft.config.vocab_size != module.config.vocab_size:
                raise ValueError(
                    f"target/draft vocabularies differ: {module.config.vocab_size} "
                    f"vs {self.draft.config.vocab_size}"
                )
            if self.speculate_k < 1:
                raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
            if prompt_buckets and self.speculate_k + 1 > min(int(b) for b in prompt_buckets):
                # idle slots write k+1 garbage rows from their parked fill;
                # an admission's full-bucket write must cover them
                raise ValueError(
                    f"speculate_k + 1 = {self.speculate_k + 1} exceeds the "
                    f"smallest prompt bucket {min(prompt_buckets)}"
                )
            if paged or kv_pool_bytes is not None or kv_pool_blocks is not None:
                raise ValueError(
                    "the speculative engine does not compose with the paged KV "
                    "pool — the draft model would need a mirrored pool; drop "
                    "paged/kv_pool_* or draft_module"
                )
        # rows a dispatched chunk can advance a slot: 1 per decode step,
        # or k+1 per speculative round
        self._round_stride = 1 if self.draft is None else self.speculate_k + 1
        if system_prefix is not None or prefix_cache not in (None, False):
            raise NotImplementedError(
                "the prefix KV cache (prefix_cache / system_prefix) is not "
                "ported to unionml_tpu_torch (see ROADMAP.md)"
            )
        if slots < 1:
            raise ValueError("need at least one slot")
        if not prompt_buckets:
            raise ValueError("need at least one prompt bucket")
        self.device = resolve_device(device)
        self.phase = validate_phase(phase)
        self.model_version: Optional[str] = None
        self.module = module
        self.cfg = module.config
        self.slots = slots
        self.max_new_tokens = max_new_tokens
        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.chunk_steps = chunk_steps
        self.pipeline_depth = max(1, pipeline_depth)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.submit_timeout = submit_timeout
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 when set")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self.max_queue_depth = max_queue_depth
        self.breaker_threshold = breaker_threshold
        self.breaker_window_s = breaker_window_s
        self.breaker_cooldown_s = breaker_cooldown_s
        self._faults = fault_injector
        self._draining = False
        self._breaker_open_until = 0.0
        # recovery timestamps within the breaker window (lock-guarded);
        # cleared on any successful completion
        self._recovery_times: "deque[float]" = deque()
        # bumped by _recover: readbacks dispatched under an older epoch
        # belong to the poisoned era and are never materialized
        self._epoch = 0
        self._registry = registry if registry is not None else telemetry.get_registry()
        self._tracer = tracer if tracer is not None else telemetry.get_tracer()
        self.instance = telemetry.instance_label("engine")
        self.introspect = bool(introspect)
        self._flight = (
            (flight if flight is not None else telemetry.get_flight_recorder())
            if self.introspect else None
        )
        if usage is True:
            from unionml_tpu_torch.serving.usage import UsageLedger

            usage = UsageLedger(registry=self._registry)
        self._usage = usage or None
        if perf is None:
            perf = self.introspect
        if perf is True:
            from unionml_tpu_torch.serving.perf import ServingPerfPlane

            perf = ServingPerfPlane(
                registry=self._registry, flight=self._flight,
                engine=self.instance, phase=self.phase,
                slots=self.slots, chunk_steps=self.chunk_steps,
            )
        self._perf = perf or None
        # harvester-thread clock: end of the previous readback
        self._last_harvest_end = 0.0
        self._programs = None
        self.paged = bool(
            paged or kv_pool_bytes is not None or kv_pool_blocks is not None
        )
        self._kv_block_size_arg = (
            None if kv_block_size is None else int(kv_block_size)
        )
        if self._kv_block_size_arg is not None and self._kv_block_size_arg < 1:
            raise ValueError("kv_block_size must be >= 1")
        # a shared block unit rounds buckets up to lcm(block,
        # prefill_chunk) so paged block scatters and chunked prefill keep
        # evenly-covered shapes
        self._kv_block_size, align = self._block_geometry()
        raw = sorted(set(int(b) for b in prompt_buckets))
        if self.paged:
            raw = sorted(set(-(-b // align) * align for b in raw))
        self.buckets = tuple(raw)
        self._user_max = self.buckets[-1]
        if self.prefill_chunk is not None:
            bad = [
                b for b in self.buckets
                if b > self.prefill_chunk and b % self.prefill_chunk
            ]
            if bad:
                raise ValueError(
                    f"buckets {bad} are not multiples of prefill_chunk "
                    f"{self.prefill_chunk} — chunked prefill needs even "
                    "chunk coverage (pad the bucket or change the chunk)"
                )
        # spare rows: a slot may overshoot its token budget by the whole
        # in-flight window before the host retires it
        self.cache_len = (
            self.buckets[-1]
            + max_new_tokens
            + (self.pipeline_depth + 1) * chunk_steps * self._round_stride
            # a speculative round writes k rows past its counted advance
            + (self._round_stride - 1)
        )
        if self.paged:
            # the logical row space maps onto whole pool blocks; overshoot
            # rows past a request's reserved blocks write the trash block
            self.cache_len = (
                -(-self.cache_len // self._kv_block_size) * self._kv_block_size
            )
        max_len = min(
            [self.cfg.max_len] + ([self.draft.config.max_len] if self.draft is not None else [])
        )
        if self.cache_len > max_len:
            raise ValueError(
                f"cache length {self.cache_len} (= max bucket "
                f"{self.buckets[-1]} + max_new_tokens {max_new_tokens} + "
                f"(pipeline_depth {self.pipeline_depth} + 1) * chunk_steps "
                f"{chunk_steps} * round stride {self._round_stride} spare rows) "
                f"exceeds model max_len {max_len}; lower pipeline_depth/"
                "chunk_steps or raise max_len"
            )
        # device block pool (paged mode): host-side free-list allocator +
        # per-slot block tables; the device arrays live in _state
        self.kv_pool: Optional[KVBlockPool] = None
        self._table: Optional[np.ndarray] = None
        self._dispatch_seq = 0      # decode chunks dispatched (fence clock)
        self._harvest_seq = 0       # decode chunks harvested (event done)
        # (fence, block ids): freed only once every chunk dispatched
        # before the retirement has been harvested
        self._deferred_free: List = []
        if self.paged:
            blk = self._kv_block_size
            self._table_width = self.cache_len // blk
            block_nbytes = self._kv_block_nbytes(blk)
            if kv_pool_blocks is not None:
                num_blocks = int(kv_pool_blocks)
            elif kv_pool_bytes is not None:
                num_blocks = max(2, int(kv_pool_bytes) // block_nbytes)
            else:
                # default: the contiguous layout's worst case
                num_blocks = 1 + slots * self._table_width
            self.kv_pool = KVBlockPool(
                num_blocks=num_blocks, block_size=blk,
                block_nbytes=block_nbytes, registry=self._registry,
            )
            self._table = np.zeros((slots, self._table_width), np.int32)
            self._slot_covered = [0] * slots   # taken blocks per slot row
            self._slot_rows = [0] * slots      # dispatched-rows upper bound
        self._sample = make_sampler(
            temperature=temperature, top_k=top_k, top_p=top_p
        )
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._params: Any = None
        self._state: Any = None
        self._occupant: List[Optional[_Request]] = [None] * slots
        # bumped on every (re)admission: an in-flight chunk snapshot with a
        # stale generation must not credit its tokens to the new occupant
        self._slot_gen: List[int] = [0] * slots
        # requests popped from the queue but not yet visible in _occupant
        self._admitting = 0
        # chunked admission in progress (dispatcher thread only)
        self._admission: Optional[_Admission] = None
        sched_cfg = scheduler if scheduler is not None else SchedulerConfig()
        if sched_cfg.preempt:
            raise ValueError(
                "SchedulerConfig(preempt=True) needs a paged engine with a "
                "prefix cache — eviction stores the victim's pool blocks in "
                "the host prefix-cache store and resume splices them back; "
                "the prefix cache is not ported to unionml_tpu_torch yet "
                "(see ROADMAP.md)"
            )
        self._mix_budget = sched_cfg.mix_prefill_tokens
        self._sched = PreemptiveScheduler(
            sched_cfg, registry=self._registry,
            engine_label=self.instance, usage=self._usage,
            phase=self.phase,
        )
        self._room = self._sched.room
        self._lock = threading.Lock()
        # dispatch→harvest pipeline: FIFO of in-flight readbacks; the
        # semaphore caps chunk entries at pipeline_depth
        self._inflight: "queue.Queue" = queue.Queue()
        self._chunk_credits = threading.Semaphore(self.pipeline_depth)
        self._build_instruments()
        self._harvest_t0 = 0.0
        self._build_programs()
        if self.introspect:
            self._instrument_programs()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="unionml-torch-decode-engine"
        )
        self._harvester = threading.Thread(
            target=self._harvest_loop, daemon=True,
            name="unionml-torch-decode-harvest",
        )
        self._worker.start()
        self._harvester.start()

    def _build_instruments(self):
        """Register this instance's metric series (get-or-create: the
        family schemas are shared, the ``engine`` label isolates us)."""
        R, lbl = self._registry, {"engine": self.instance}

        def counter(name, help):
            return R.counter(name, help, ("engine",)).labels(**lbl)

        def hist(name, help):
            return R.histogram(name, help, ("engine",)).labels(**lbl)

        self._m_requests = counter(
            "unionml_engine_requests_total",
            "Requests completed and delivered to their waiter.",
        )
        self._m_errors = counter(
            "unionml_engine_errors_total",
            "Requests failed by an engine/admission error.",
        )
        self._m_abandoned = counter(
            "unionml_engine_abandoned_total",
            "Requests whose waiter gave up before completion.",
        )
        self._m_timeouts = counter(
            "unionml_engine_timeouts_total",
            "generate()/generate_stream() waits that hit submit_timeout.",
        )
        self._m_steps = counter(
            "unionml_engine_decode_steps_total",
            "Decode steps dispatched (all slots advance together).",
        )
        self._m_chunks = counter(
            "unionml_engine_chunks_total", "Decode chunks dispatched.",
        )
        self._m_occupied = counter(
            "unionml_engine_occupied_slot_steps_total",
            "Slot-steps dispatched with a live occupant (occupancy "
            "numerator; denominator is decode_steps * slots).",
        )
        self._m_slots_busy = R.gauge(
            "unionml_engine_slots_in_use",
            "Slots currently holding a live request.", ("engine",),
        ).labels(**lbl)
        R.gauge(
            "unionml_engine_slots", "Resident decode slots.", ("engine",)
        ).labels(**lbl).set(self.slots)
        self._h_queue = hist(
            "unionml_engine_queue_wait_ms",
            "Submit-to-admission wait per completed request.",
        )
        self._h_prefill = hist(
            "unionml_engine_prefill_ms",
            "Prefill dispatch-to-first-token-harvest per completed request.",
        )
        self._h_decode = hist(
            "unionml_engine_decode_ms",
            "First-token-to-retirement decode time per completed request.",
        )
        self._h_ttft = hist(
            "unionml_engine_ttft_ms",
            "Submit-to-first-harvested-token per completed request.",
        )
        self._h_dispatch = hist(
            "unionml_engine_chunk_dispatch_ms",
            "Host time to enqueue one decode chunk (the eager step "
            "loop's launches; the dispatcher's per-chunk cost).",
        )
        self._h_harvest = hist(
            "unionml_engine_chunk_harvest_ms",
            "Blocking readback + accounting per harvested decode chunk "
            "(includes in-flight pipeline lag).",
        )
        self._m_spec_rounds = counter(
            "unionml_engine_spec_rounds_total",
            "Speculative rounds whose tokens were served.",
        )
        self._m_spec_accepted = counter(
            "unionml_engine_spec_accepted_tokens_total",
            "Draft tokens accepted by the target verify forward.",
        )
        # fault tolerance: admission control / supervision series
        rejected = R.counter(
            "unionml_engine_rejected_total",
            "Submissions rejected at admission control, by reason "
            "(queue_full -> 429, breaker_open/draining -> 503).",
            ("engine", "reason"),
        )
        self._m_rejected = {
            reason: rejected.labels(engine=self.instance, reason=reason)
            for reason in (
                "queue_full", "breaker_open", "draining", "pool_full",
            )
        }
        self._m_deadline_shed = counter(
            "unionml_engine_deadline_shed_total",
            "Requests shed at dequeue because their deadline expired "
            "before prefill (no device work burned).",
        )
        self._m_recoveries = counter(
            "unionml_engine_recoveries_total",
            "Supervised recoveries: a failed device program failed only "
            "its poisoned batch and the decode state was rebuilt.",
        )
        self._g_breaker = R.gauge(
            "unionml_engine_breaker_open",
            "1 while the circuit breaker rejects submissions.",
            ("engine",),
        ).labels(**lbl)
        self._g_queue_depth = R.gauge(
            "unionml_engine_queue_depth",
            "Requests queued awaiting admission.", ("engine",),
        ).labels(**lbl)
        self._h_drain = hist(
            "unionml_engine_drain_ms",
            "drain() wall time: stop-admissions to queue+slots idle.",
        )
        # per-token attribution (the serving goodput plane): chunk
        # harvest spacing over the chunk's harvested tokens, split by
        # priority class — observed only while the perf plane is on,
        # so a plane-off engine records nothing here. Children are
        # pre-resolved: the harvester must not pay the family-lock
        # labels() lookup per chunk.
        itl = R.histogram(
            "unionml_engine_itl_ms",
            "Inter-token latency per harvested decode chunk (harvest "
            "spacing / tokens in the chunk), by priority class.",
            ("engine", "phase", "priority"),
        )
        self._h_itl = {
            p: itl.labels(
                engine=self.instance, phase=self.phase, priority=p
            )
            for p in PRIORITIES
        }


    def _instrument_programs(self):
        """Wrap the device programs in a :class:`~unionml_tpu_torch
        .introspection.ProgramTracker`: calls and host time per program
        land in ``/metrics`` and ``stats()["programs"]``. The sig lambdas
        are ONE shape attribute each (they run per dispatch)."""
        from unionml_tpu_torch.introspection import ProgramTracker

        tr = ProgramTracker(registry=self._registry, component=self.instance)
        self._programs = tr
        self._init_state = tr.wrap("engine.init_state", self._init_state)
        if self.paged:
            # paged programs carry the block-id vector before the tokens
            self._prefill = tr.wrap(
                "engine.prefill", self._prefill,
                sig_fn=lambda p, st, slot, ids, toks, *a, **k: tuple(toks.shape),
            )
            self._prefill_final = tr.wrap(
                "engine.prefill_final", self._prefill_final,
                sig_fn=lambda p, st, fresh, slot, ids, toks, *a, **k:
                    tuple(toks.shape),
            )
        else:
            self._prefill = tr.wrap(
                "engine.prefill", self._prefill,
                sig_fn=lambda p, st, slot, toks, *a, **k: tuple(toks.shape),
            )
            self._prefill_final = tr.wrap(
                "engine.prefill_final", self._prefill_final,
                sig_fn=lambda p, st, fresh, slot, toks, *a, **k: tuple(toks.shape),
            )
        self._prefill_step = tr.wrap(
            "engine.prefill_chunk", self._prefill_step,
            sig_fn=lambda p, fresh, toks, start: tuple(toks.shape),
        )
        self._decode_chunk = tr.wrap("engine.decode", self._decode_chunk)
        self._init_fresh = tr.wrap(
            "engine.init_fresh", self._init_fresh,
            sig_fn=lambda **k: k.get("bucket"),
        )

    def _flight_rec(self, kind: str, **fields) -> None:
        """O(1) flight-recorder append (no-op when introspect=False).
        numpy scalars (slot indices from mask walks) become plain ints
        so a dumped event is always JSON-safe."""
        if self._flight is not None:
            # phase-split fleets tag every lifecycle event with the
            # pool that recorded it (colocated engines stay untagged —
            # the historical event shape is unchanged for them)
            tag = {} if self.phase == "colocated" else {"phase": self.phase}
            self._flight.record(kind, engine=self.instance, **tag, **{
                k: (v.item() if isinstance(v, np.generic) else v)
                for k, v in fields.items()
            })

    def _slots_in_use_locked(self) -> int:
        """Occupied-slot count; call with the lock held."""
        return sum(1 for r in self._occupant if r is not None)

    def _fire(self, point: str) -> None:
        """Chaos-injection site (zero-cost without an injector)."""
        if self._faults is not None:
            self._faults.fire(point)

    @property
    def usage(self):
        """The engine's :class:`~unionml_tpu_torch.serving.usage.UsageLedger`
        (``None`` when metering is off) — share it with the
        ``ServingApp`` so ``GET /debug/usage`` serves this engine's
        per-tenant resource vectors."""
        return self._usage

    @usage.setter
    def usage(self, ledger) -> None:
        """Swap the metering seam on a live engine — ONLY while idle
        (no request in flight), or a request's vector straddles two
        ledgers. The ``serve_usage`` bench toggles this between its
        overhead legs so both run on the SAME engine instance (two
        separately-constructed engines differ by several percent from
        thread/allocator placement alone, swamping a 2% bar); the
        attribution window is clamped at each chunk's dispatch time,
        so the off-leg's idle gap never inflates the first on-leg
        window."""
        self._usage = ledger or None

    @property
    def perf(self):
        """The engine's :class:`~unionml_tpu_torch.serving.perf
        .ServingPerfPlane` (``None`` when the goodput plane is off) —
        ``GET /debug/goodput`` reads it via :meth:`goodput_report`."""
        return self._perf

    @perf.setter
    def perf(self, plane) -> None:
        """Swap the goodput plane on a live engine — ONLY while idle,
        like the ``usage`` seam above. The ``serve_perf`` bench
        toggles this between its paired overhead legs so both run on
        the SAME engine instance (two separately-constructed engines
        differ by several percent from thread/allocator placement
        alone, swamping a 1% bar)."""
        self._perf = plane or None
        # the waiting room's fair-share weighting follows the swap
        self._room._usage = self._usage

    @property
    def registry(self):
        """The engine's :class:`~unionml_tpu_torch.telemetry.MetricsRegistry`
        — the fleet router's metrics federation reads it to expose this
        replica's series under the router's ``replica`` label (or to
        skip the merge when the replica already shares the router
        app's registry)."""
        return self._registry

    @property
    def tracer(self):
        """The engine's :class:`~unionml_tpu_torch.telemetry.TraceRecorder`
        — the stitched ``/debug/trace`` fetches this replica's request
        timelines through it (identity with the router app's recorder
        means the local merge already covers them)."""
        return self._tracer

    @property
    def flight(self):
        """The engine's :class:`~unionml_tpu_torch.telemetry.FlightRecorder`
        (``None`` when disabled) — the fleet ``/debug/flight`` merge
        reads replica rings through it."""
        return self._flight

    @property
    def breaker_open(self) -> bool:
        """True while the circuit breaker rejects submissions (the
        cooldown after ``breaker_threshold`` recoveries in the window).
        Reading it keeps the ``unionml_engine_breaker_open`` gauge
        honest — the breaker closes by TIME passing, not by an event."""
        is_open = time.monotonic() < self._breaker_open_until
        self._g_breaker.set(1.0 if is_open else 0.0)
        return is_open

    def _gated_submit(self, reqs: List[_Request]) -> None:
        """Admission control + enqueue, atomically under the engine
        lock (shared by ``generate`` and ``generate_stream``): reject
        BEFORE any request is enqueued, so a multi-prompt call never
        partially admits — and so N concurrent submitters cannot each
        pass a depth check and push the queue past ``max_queue_depth``
        (the exact overload the bound exists for)."""
        with self._lock:
            self._admission_gate_locked(reqs)
            for req in reqs:
                # recorded BEFORE the put, inside the lock: a request's
                # 'submit' flight event can never land after its
                # 'prefill' in the trail. queue_depth = requests ahead.
                self._flight_rec(
                    "submit", rid=req.rid, tenant=req.tenant,
                    priority=req.priority,
                    prompt_tokens=len(req.prompt),
                    queue_depth=self._room.qsize(),
                )
                self._room.put(req)
        self._g_queue_depth.set(self._room.qsize())

    def _usage_rejected(self, reqs: List[_Request], reason: str) -> None:
        """Tenant dimension on admission-control rejections (all reqs
        in one submit share a tenant — one gated call per generate)."""
        if self._usage is not None and reqs:
            self._usage.record_rejected(reqs[0].tenant, reason, len(reqs))

    def _admission_gate_locked(self, reqs: List[_Request]) -> None:
        n_new = len(reqs)
        tenant = reqs[0].tenant if reqs else DEFAULT_TENANT
        if self.paged:
            # a request whose worst case exceeds the WHOLE pool can
            # never be admitted — reject now (transient fullness parks
            # at admission instead; the queue bound sheds the backlog)
            for req in reqs:
                needed = self.kv_pool.blocks_for_rows(
                    min(len(req.prompt) + req.max_new_tokens,
                        self.cache_len)
                )
                if needed > self.kv_pool.capacity:
                    self._m_rejected["pool_full"].inc(n_new)
                    self._usage_rejected(reqs, "pool_full")
                    self._flight_rec(
                        "reject", reason="pool_full", n=n_new,
                        tenant=tenant, needed_blocks=needed,
                        capacity_blocks=self.kv_pool.capacity,
                    )
                    raise Overloaded(
                        f"kv pool can never fit this request: "
                        f"{needed} blocks needed "
                        f"({len(req.prompt)} prompt + "
                        f"{req.max_new_tokens} new tokens), pool "
                        f"capacity {self.kv_pool.capacity} blocks",
                        retry_after_s=60.0,
                    )
        if self._draining:
            self._m_rejected["draining"].inc(n_new)
            self._usage_rejected(reqs, "draining")
            self._flight_rec(
                "reject", reason="draining", n=n_new, tenant=tenant,
            )
            raise EngineUnavailable(
                "decode engine is draining and not accepting requests",
                reason="draining", retry_after_s=1.0,
            )
        remaining = self._breaker_open_until - time.monotonic()
        if remaining > 0:
            self._m_rejected["breaker_open"].inc(n_new)
            self._usage_rejected(reqs, "breaker_open")
            self._flight_rec(
                "reject", reason="breaker_open", n=n_new, tenant=tenant,
            )
            raise EngineUnavailable(
                "decode engine circuit breaker is open "
                f"({len(self._recovery_times)} recent recovery failures); "
                f"retry in {remaining:.1f}s",
                reason="breaker_open", retry_after_s=max(0.1, remaining),
            )
        if self.max_queue_depth is not None:
            depth = self._room.qsize()
            if depth + n_new > self.max_queue_depth:
                self._m_rejected["queue_full"].inc(n_new)
                self._usage_rejected(reqs, "queue_full")
                self._flight_rec(
                    "reject", reason="queue_full", n=n_new,
                    tenant=tenant, queue_depth=depth,
                )
                raise Overloaded(
                    f"decode engine queue is full ({depth} queued + "
                    f"{n_new} new > max_queue_depth "
                    f"{self.max_queue_depth})",
                    retry_after_s=1.0,
                )

    def health(self) -> dict:
        """Readiness surface for ``GET /health``: ``status`` is ``ok``,
        ``degraded`` (circuit breaker open), or ``draining``; plus the
        queue depth and breaker state the transports report."""
        breaker = self.breaker_open
        if self._draining:
            status = "draining"
        elif breaker:
            status = "degraded"
        else:
            status = "ok"
        out = {
            "status": status,
            "queue_depth": self._room.qsize(),
            "breaker_open": breaker,
        }
        if self.phase != "colocated":
            out["phase"] = self.phase
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop admitting (new submissions raise
        :class:`~unionml_tpu_torch.serving.faults.EngineUnavailable` and
        ``health()`` flips to ``draining``), then block until every
        queued and in-flight request — streams included — has finished
        and all readbacks are harvested. Returns True when fully
        drained, False on ``timeout`` (work may still be in flight;
        admissions stay stopped either way). Reversible with
        :meth:`resume`; observability lands in the
        ``unionml_engine_drain_ms`` histogram."""
        t0 = time.perf_counter()
        self._draining = True
        drained = False
        while True:
            with self._lock:
                drained = (
                    self._room.empty()
                    and self._admitting == 0
                    and self._admission is None
                    and all(r is None for r in self._occupant)
                    and self._inflight.empty()
                )
            if drained:
                break
            if (
                timeout is not None
                and time.perf_counter() - t0 > timeout
            ):
                break
            time.sleep(0.005)
        self._h_drain.observe((time.perf_counter() - t0) * 1e3)
        return drained

    def resume(self) -> None:
        """Reopen admissions after :meth:`drain` (rolling-restart flows
        that drain, swap weights via :meth:`bind`, and serve again)."""
        self._draining = False


    def _block_geometry(self):
        """``(block, align)``: the paged pool's block unit (``kv_block_size``,
        default 16) and the bucket rounding unit ``lcm(block,
        prefill_chunk)`` (the reference's single home for block geometry,
        without the prefix cache it shares the unit with)."""
        block = (self._kv_block_size_arg or 16) if self.paged else None
        align = block or 1
        if self.prefill_chunk is not None:
            align = math.lcm(align, self.prefill_chunk)
        return block, align

    def _kv_block_nbytes(self, blk: int) -> int:
        """Device bytes of one pool block across every layer and buffer
        (``init_cache``'s layout: bf16 k/v, or int8 k/v + fp32
        per-(row, head) scales under ``kv_quant``)."""
        cfg = self.cfg
        rows = blk * cfg.num_kv_heads
        if getattr(cfg, "kv_quant", False):
            per_layer = 2 * (rows * cfg.head_dim * 1 + rows * 4)
        else:
            per_layer = 2 * rows * cfg.head_dim * 2
        return cfg.num_layers * per_layer

    # ------------------------------------------------------------------ #
    # device programs (eager; they update the resident state in place)
    # ------------------------------------------------------------------ #

    def _run_prefill(self, params, fresh, toks, start: int, true_len: int,
                     *, full: bool = False):
        """The prefill tail shared by every admission: run ``toks`` (the
        whole right-padded bucket at ``start=0``, or the final chunk at
        its offset) against ``fresh`` and sample the first token at the
        last REAL position. Returns ``(first [] device tensor, fresh)``."""
        dev = self.device
        bucket = fresh[0][0].shape[1]
        c = toks.shape[1]
        kv_mask = (torch.arange(bucket, device=dev) < true_len)[None, :]
        logits, filled = self.module(
            params, toks,
            positions=start + torch.arange(c, device=dev)[None, :],
            cache=fresh, cache_index=start, kv_mask=kv_mask,
            # head on the last REAL position only
            logit_index=torch.full((1,), true_len - 1 - start, dtype=torch.long, device=dev),
            full_prefill=full,
        )
        first = self._sample(logits[:, 0], self._gen)[0]
        return first, filled

    def _build_programs(self):
        from unionml_tpu_torch.models.llama import init_cache

        if self.draft is not None:
            self._build_spec_programs()
            return
        if self.paged:
            self._build_paged_programs()
            return
        cfg, L, B, dev = self.cfg, self.cache_len, self.slots, self.device
        module, sample = self.module, self._sample
        eos_id, pad_id = self.eos_id, self.pad_id
        rows_l = torch.arange(L, device=dev)

        def init_state():
            return {
                "cache": init_cache(cfg, B, L, device=dev),
                "kv_mask": torch.zeros((B, L), dtype=torch.bool, device=dev),
                # empty slots idle at row 0: dead slots still run the
                # decode step and write garbage k/v at their fill row —
                # row 0 stays masked False and is overwritten by the next
                # admission's full-bucket write
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
            }

        self._init_state = init_state

        def finish_prefill(params, state, fresh, slot, toks, start, true_len,
                           full=False):
            """Prefill tail + write of the whole fresh cache into the
            slot's rows [0, bucket); rows above ``true_len`` stay masked
            False in the resident kv_mask."""
            first, filled = self._run_prefill(
                params, fresh, toks, start, true_len, full=full
            )
            bucket = filled[0][0].shape[1]
            for dst_layer, src_layer in zip(state["cache"], filled):
                for dst, src in zip(dst_layer, src_layer):
                    dst[slot, :bucket] = src[0].to(dst.dtype)
            state["kv_mask"][slot] = rows_l < true_len
            # fill_ on a one-element view: assigning a Python scalar through
            # indexing would copy it from pageable host memory and wait for
            # the card
            state["fill"][slot].fill_(true_len)
            state["last_tok"][slot] = first
            state["done"][slot].fill_(False)
            return first

        # a monolithic admission covers the whole visible history, so
        # cfg.prefill_impl == "flash" runs it through the flash kernel
        # (right-padded buckets need no pad mask: causal alone hides the
        # trailing garbage). Chunked admissions keep the cached path.
        full_ok = cfg.prefill_impl == "flash"

        def prefill(params, state, slot, tokens, true_len):
            fresh = init_cache(cfg, 1, tokens.shape[0], device=dev)
            return finish_prefill(
                params, state, fresh, slot, tokens[None], 0, true_len, full=full_ok,
            )

        self._prefill = prefill
        self._prefill_final = finish_prefill
        self._init_fresh = lambda *, bucket: init_cache(cfg, 1, bucket, device=dev)
        self._prefill_step = self._make_prefill_step()

        def decode_chunk(params, state, active):
            """``chunk_steps`` decode steps for every slot; returns the
            tokens [chunk_steps, slots]."""
            out = []
            for _ in range(self.chunk_steps):
                live = active & ~state["done"]
                fill = state["fill"]
                # this step writes its k/v at row `fill`; the new token
                # must see ITSELF, so expose the row before the step — for
                # live slots only
                kv_mask = state["kv_mask"] | (
                    (rows_l[None, :] == fill[:, None]) & live[:, None]
                )
                logits, _ = module(
                    params, state["last_tok"][:, None], cache=state["cache"],
                    cache_index=fill, kv_mask=kv_mask,
                )
                nxt = torch.where(live, sample(logits[:, -1], self._gen), pad_id)
                done = state["done"]
                if eos_id is not None:
                    done = done | (live & (nxt == eos_id))
                advance = live & (fill + 1 < L)
                # a live slot at the cache end freezes its fill on a
                # masked-True row — mark done so it stops writing there
                state["done"] = done | (live & ~advance)
                state["kv_mask"] = kv_mask
                state["fill"] = fill + advance.int()
                state["last_tok"] = torch.where(live, nxt, state["last_tok"])
                out.append(nxt)
            return torch.stack(out)

        self._decode_chunk = decode_chunk

    def _lead_chunk(self, module, params, fresh, toks, start) -> None:
        """One lead prefill chunk of ``module`` into its fresh cache, in
        place: tokens are fully real (only chunks covering the true length
        run; the final one goes through ``finish_prefill``)."""
        dev = self.device
        lf = fresh[0][0].shape[1]
        c = toks.shape[1]
        module(
            params, toks,
            positions=start + torch.arange(c, device=dev)[None, :],
            cache=fresh, cache_index=start,
            kv_mask=(torch.arange(lf, device=dev) < start + c)[None, :],
            logit_index=torch.zeros((1,), dtype=torch.long, device=dev),
        )

    def _make_prefill_step(self):
        def prefill_step(params, fresh, toks, start):
            self._lead_chunk(self.module, params, fresh, toks, start)
            return fresh

        return prefill_step

    def _build_paged_programs(self):
        """Paged-mode device programs: same attribute names and dispatcher
        contract as the contiguous ones, but the resident KV is a global
        block pool (per layer ``[num_blocks, block, kv_heads, head_dim]``)
        plus the host-owned block table uploaded with every decode chunk.
        Prefill still computes against a contiguous ``[1, bucket]`` fresh
        cache, then scatters it into the slot's pool blocks (padding
        blocks land on the trash block); the decode step reads and writes
        through the table, with dead slots' rows masked to the trash block
        every step. There is no resident kv_mask: visibility is
        ``fill + 1``."""
        from unionml_tpu_torch.models.llama import init_cache

        cfg, L, B, dev = self.cfg, self.cache_len, self.slots, self.device
        blk = self._kv_block_size
        n_pool = self.kv_pool.num_blocks
        module, sample = self.module, self._sample
        eos_id, pad_id = self.eos_id, self.pad_id

        def init_state():
            return {
                "pool": init_cache(cfg, n_pool, blk, device=dev),
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
            }

        self._init_state = init_state

        def finish_prefill(params, state, fresh, slot, ids, toks, start,
                           true_len, full=False):
            """Prefill tail, then the table-directed block scatter: fresh
            rows into pool blocks ``ids`` ([bucket/block]; duplicate trash
            entries write garbage over garbage)."""
            first, filled = self._run_prefill(
                params, fresh, toks, start, true_len, full=full
            )
            idx = ids.long()
            nb = idx.shape[0]
            for p_layer, f_layer in zip(state["pool"], filled):
                for pbuf, fbuf in zip(p_layer, f_layer):
                    pbuf[idx] = fbuf.reshape((nb, blk) + tuple(fbuf.shape[2:])).to(pbuf.dtype)
            state["fill"][slot].fill_(true_len)   # no host copy (see above)
            state["last_tok"][slot] = first
            state["done"][slot].fill_(False)
            return first

        full_ok = cfg.prefill_impl == "flash"

        def prefill(params, state, slot, ids, tokens, true_len):
            fresh = init_cache(cfg, 1, tokens.shape[0], device=dev)
            return finish_prefill(
                params, state, fresh, slot, ids, tokens[None], 0, true_len,
                full=full_ok,
            )

        self._prefill = prefill
        self._prefill_final = finish_prefill
        self._init_fresh = lambda *, bucket: init_cache(cfg, 1, bucket, device=dev)
        self._prefill_step = self._make_prefill_step()

        def decode_chunk(params, state, active, table):
            """``chunk_steps`` paged decode steps. The block table is a
            per-chunk input (the host grows it between chunks); retired
            and dead slots' rows go to the trash block every step, so
            their writes never land in a block the allocator recycled."""
            out = []
            for _ in range(self.chunk_steps):
                live = active & ~state["done"]
                fill = state["fill"]
                step_table = torch.where(live[:, None], table, 0)
                logits, _ = module(
                    params, state["last_tok"][:, None], cache=state["pool"],
                    cache_index=fill, block_table=step_table,
                )
                nxt = torch.where(live, sample(logits[:, -1], self._gen), pad_id)
                done = state["done"]
                if eos_id is not None:
                    done = done | (live & (nxt == eos_id))
                advance = live & (fill + 1 < L)
                state["done"] = done | (live & ~advance)
                state["fill"] = fill + advance.int()
                state["last_tok"] = torch.where(live, nxt, state["last_tok"])
                out.append(nxt)
            return torch.stack(out)

        self._decode_chunk = decode_chunk

    def _build_spec_programs(self):
        """Speculative-mode device programs (``draft_module`` set): the
        contiguous programs' attribute names and signatures, so the
        dispatcher and admission machinery are shared; ``params`` is the
        bound ``{"target", "draft"}`` mapping and fresh caches are
        ``(target, draft)`` pairs. The decode chunk runs ``chunk_steps``
        speculative rounds: per-slot draft proposals (vector
        ``cache_index``), ONE shared [slots, k+1] verify forward, greedy
        acceptance advancing per-slot fills — the round of
        ``make_speculative_generator``, restructured for the resident slot
        batch. Nothing in a round reads a device value on the host."""
        from unionml_tpu_torch.models.llama import init_cache
        from unionml_tpu_torch.models.speculative import greedy_acceptance

        cfg, dcfg = self.cfg, self.draft.config
        L, B, k, dev = self.cache_len, self.slots, self.speculate_k, self.device
        module, draft = self.module, self.draft
        eos_id, pad_id = self.eos_id, self.pad_id
        rows_l = torch.arange(L, device=dev)[None, :]
        steps = torch.arange(k + 1, device=dev)[None, :]

        def init_state():
            return {
                "cache": init_cache(cfg, B, L, device=dev),
                "d_cache": init_cache(dcfg, B, L, device=dev),
                "kv_mask": torch.zeros((B, L), dtype=torch.bool, device=dev),
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
            }

        self._init_state = init_state

        def finish_prefill(params, state, fresh, slot, toks, start, true_len, full=False):
            """Prefill tail for BOTH caches (each model honours its own
            ``prefill_impl`` on a monolithic admission), the first token
            from the target's last real position, and both filled caches
            written into the slot's rows [0, bucket)."""
            fresh_t, fresh_d = fresh
            first, filled_t = self._run_prefill(
                params["target"], fresh_t, toks, start, true_len,
                full=full and cfg.prefill_impl == "flash",
            )
            bucket = fresh_d[0][0].shape[1]
            c = toks.shape[1]
            # the draft's prefill logits are never read
            _, filled_d = draft(
                params["draft"], toks,
                positions=start + torch.arange(c, device=dev)[None, :],
                cache=fresh_d, cache_index=start,
                kv_mask=(torch.arange(bucket, device=dev) < true_len)[None, :],
                logit_index=torch.zeros((1,), dtype=torch.long, device=dev),
                full_prefill=full and dcfg.prefill_impl == "flash",
            )
            for key, filled in (("cache", filled_t), ("d_cache", filled_d)):
                for dst_layer, src_layer in zip(state[key], filled):
                    for dst, src in zip(dst_layer, src_layer):
                        dst[slot, :bucket] = src[0].to(dst.dtype)
            state["kv_mask"][slot] = rows_l[0] < true_len
            state["fill"][slot].fill_(true_len)   # no host copy (see _build_programs)
            state["last_tok"][slot] = first
            state["done"][slot].fill_(False)
            return first

        def init_fresh(*, bucket):
            return (init_cache(cfg, 1, bucket, device=dev), init_cache(dcfg, 1, bucket, device=dev))

        def prefill(params, state, slot, tokens, true_len):
            return finish_prefill(
                params, state, init_fresh(bucket=tokens.shape[0]), slot, tokens[None], 0,
                true_len, full=True,
            )

        def prefill_step(params, fresh, toks, start):
            self._lead_chunk(module, params["target"], fresh[0], toks, start)
            self._lead_chunk(draft, params["draft"], fresh[1], toks, start)
            return fresh

        self._prefill = prefill
        self._prefill_final = finish_prefill
        self._init_fresh = init_fresh
        self._prefill_step = prefill_step

        def spec_chunk(params, state, active):
            """``chunk_steps`` speculative rounds. Returns one int64
            tensor [R, B, k+3]: per round and slot the emission row (k+1
            tokens), the emitted count (eos-truncated on the device) and
            the accepted draft count; the host truncates at the budget."""
            outs = []
            for _ in range(self.chunk_steps):
                live = active & ~state["done"]
                fill0 = state["fill"]
                kv_mask = state["kv_mask"]
                # the draft proposes k tokens over k+1 steps (the extra step
                # writes proposal k's KV, so a fully accepted round leaves no
                # draft-cache hole)
                tok, f, props = state["last_tok"], fill0, []
                for _ in range(k + 1):
                    vis = kv_mask | (
                        (rows_l >= fill0[:, None]) & (rows_l <= f[:, None]) & live[:, None]
                    )
                    logits, _ = draft(
                        params["draft"], tok[:, None], cache=state["d_cache"],
                        cache_index=f, kv_mask=vis,
                    )
                    tok = torch.argmax(logits[:, -1], -1)
                    props.append(tok)
                    f = f + 1
                props = torch.stack(props[:k], dim=1)                     # [B, k]

                # ONE shared multi-token verify forward for every slot
                verify_in = torch.cat([state["last_tok"][:, None], props], dim=1)
                vis_v = kv_mask | (
                    (rows_l >= fill0[:, None]) & (rows_l <= (fill0 + k)[:, None])
                    & live[:, None]
                )
                v_logits, _ = module(
                    params["target"], verify_in, cache=state["cache"], cache_index=fill0,
                    kv_mask=vis_v,
                )
                greedy = torch.argmax(v_logits, -1)
                accepted, correction, emit = greedy_acceptance(props, greedy)
                n_emit = torch.where(live, accepted + 1, 0)
                done = state["done"]
                if eos_id is not None:
                    eos_hit = (emit == eos_id) & (steps < n_emit[:, None])
                    any_eos = eos_hit.any(dim=1)
                    first_eos = torch.argmax(eos_hit.int(), dim=1)
                    n_emit = torch.where(any_eos, torch.minimum(n_emit, first_eos + 1), n_emit)
                    done = done | (live & any_eos)
                # rows consumed = accepted + 1 (eos shrinks the emission, not
                # the rows written; done stops later rounds)
                new_fill = fill0 + torch.where(live, accepted + 1, 0).int()
                # freeze before the end: the next round writes k+1 rows
                state["done"] = done | (live & (new_fill + k + 1 >= L))
                state["kv_mask"] = kv_mask | (
                    (rows_l >= fill0[:, None]) & (rows_l < new_fill[:, None])
                )
                state["fill"] = new_fill
                state["last_tok"] = torch.where(live, correction, state["last_tok"])
                outs.append(torch.cat([
                    torch.where(live[:, None], emit, pad_id),
                    n_emit[:, None],
                    torch.where(live, accepted, 0)[:, None],
                ], dim=1))
            return torch.stack(outs)

        self._decode_chunk = spec_chunk

    def generate(
        self,
        params,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> list:
        """Generate for a list of token-id prompts; blocks until all done.

        Compatible with the ``make_lm_predictor`` row-lists contract:
        returns one token list per prompt. ``params`` binds on first call
        (pass serving-ready weights — cast/quantized).

        ``deadline_ms`` (or an ambient :func:`~unionml_tpu_torch.serving
        .faults.deadline_scope` — how ``X-Deadline-Ms`` reaches here
        through the transports) bounds each request's total latency:
        still-queued requests whose deadline expires are shed at
        dequeue with :class:`~unionml_tpu_torch.serving.faults
        .DeadlineExceeded`, before they consume prefill.

        ``tenant`` (or the ambient :func:`~unionml_tpu_torch.serving.usage
        .tenant_scope` the transports open from ``X-Tenant-ID``) names
        who this call's resource vector is billed to when the engine
        runs a usage ledger; defaults to ``anonymous``.

        ``priority`` (or the ambient :func:`~unionml_tpu_torch.serving
        .scheduler.priority_scope` the transports open from
        ``X-Priority``) sets the scheduling class — ``high`` /
        ``normal`` / ``low`` — the waiting room orders admissions by
        (the scheduler's waiting room).
        """
        self.bind(params)
        tenant = (
            validate_tenant(tenant) if tenant is not None
            else current_tenant()
        )
        priority = (
            validate_priority(priority) if priority is not None
            else current_priority()
        )
        if max_new_tokens is None:
            # the ambient per-request cap the transports open from the
            # /predict payload's max_new_tokens field (the deadline-
            # scope pattern) — how a caller's cap survives the router
            # hop without threading a kwarg through every predictor
            max_new_tokens = current_token_cap()
        n = max_new_tokens if max_new_tokens is not None else self.max_new_tokens
        if not 1 <= n <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {n} outside [1, {self.max_new_tokens}] "
                "(raise the engine's max_new_tokens)"
            )
        if deadline_ms is None:
            deadline_ms = current_deadline_ms()
        # validate EVERY prompt before creating any request or trace
        # rid, so a bad later prompt cannot leak earlier ones' state
        rows = [self._canonical_row(p) for p in prompts]
        reqs = []
        for row in rows:
            req = _Request(
                prompt=row, max_new_tokens=n, tenant=tenant,
                priority=priority,
            )
            if deadline_ms is not None:
                req.deadline = req.submitted + deadline_ms / 1e3
            req.rid = self._tracer.new_request("generate")
            reqs.append(req)
        try:
            self._gated_submit(reqs)
        except BaseException:
            # rejected before enqueue: close the trace timelines or the
            # recorder leaks one live request per shed submission —
            # precisely under the sustained overload shedding exists for
            for req in reqs:
                self._tracer.finish_request(req.rid)
            raise
        out = []
        for req in reqs:
            if not req.event.wait(self.submit_timeout):
                # abandon the whole call: queued siblings are dropped at
                # admission and in-slot ones retired at the next harvest,
                # so orphans stop burning device time and slots
                self._m_timeouts.inc()
                for r in reqs:
                    r.abandoned = True
                raise TimeoutError("decode engine did not finish in time")
            if req.error is not None:
                raise req.error
            out.append(list(req.tokens))
        return out

    def generate_stream(
        self,
        params,
        prompt: Sequence[int],
        *,
        max_new_tokens: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
    ):
        """Yield token chunks for ONE prompt as the engine harvests them.

        The streaming surface behind ``POST /predict/stream``: the first
        chunk arrives after prefill (one token — the TTFT event), then
        one chunk per harvested decode chunk (``chunk_steps`` tokens at
        the engine's natural emission granularity). Concatenating the
        chunks yields exactly ``generate(params, [prompt])[0]`` (tested
        in the engine tests). Raises the engine's error, or
        ``TimeoutError`` when no chunk lands within ``submit_timeout``.
        """
        self.bind(params)
        tenant = (
            validate_tenant(tenant) if tenant is not None
            else current_tenant()
        )
        priority = (
            validate_priority(priority) if priority is not None
            else current_priority()
        )
        if max_new_tokens is None:
            max_new_tokens = current_token_cap()  # payload-field cap
        n = max_new_tokens if max_new_tokens is not None else self.max_new_tokens
        if not 1 <= n <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {n} outside [1, {self.max_new_tokens}] "
                "(raise the engine's max_new_tokens)"
            )
        if deadline_ms is None:
            deadline_ms = current_deadline_ms()
        row = self._canonical_row(prompt)
        req = _Request(
            prompt=row, max_new_tokens=n, stream=queue.Queue(),
            tenant=tenant, priority=priority,
        )
        if deadline_ms is not None:
            req.deadline = req.submitted + deadline_ms / 1e3
        req.rid = self._tracer.new_request("stream")
        try:
            self._gated_submit([req])
        except BaseException:
            self._tracer.finish_request(req.rid)  # no leak on rejection
            raise
        try:
            while True:
                try:
                    chunk = req.stream.get(timeout=self.submit_timeout)
                except queue.Empty:
                    self._m_timeouts.inc()
                    raise TimeoutError(
                        "decode engine produced no chunk in time"
                    ) from None
                if chunk is None:
                    if req.error is not None:
                        raise req.error
                    return
                yield chunk
        finally:
            # consumer stopped early (client disconnect → GeneratorExit,
            # timeout, error): mark abandoned so the slot is retired at
            # the next harvest instead of decoding to max_new_tokens for
            # a dead request
            if not req.event.is_set():
                req.abandoned = True


    def _canonical_row(self, prompt) -> np.ndarray:
        """The engine's canonical prompt row: int32, left-truncated to
        the largest bucket."""
        row = np.asarray(prompt, dtype=np.int32).ravel()
        if row.size == 0:
            raise ValueError("empty prompt")
        return row[-self._user_max:]

    def prefill_export(self, *args, **kwargs):
        raise NotImplementedError(
            "prefill_export needs the prefix cache, which is not ported to "
            "unionml_tpu_torch (see ROADMAP.md)"
        )

    def kv_export(self, *args, **kwargs):
        raise NotImplementedError(
            "kv_export needs the prefix cache, which is not ported to "
            "unionml_tpu_torch (see ROADMAP.md)"
        )

    def kv_import(self, *args, **kwargs):
        raise NotImplementedError(
            "kv_import needs the prefix cache, which is not ported to "
            "unionml_tpu_torch (see ROADMAP.md)"
        )

    def bind(self, params):
        """Set (or swap) the served weights (on the engine's device);
        state allocates lazily. Swapping while requests are in flight
        would mix weights within a decode — refused instead."""
        if params is self._params:
            return
        if self.draft is not None:
            if not (isinstance(params, Mapping) and "target" in params and "draft" in params):
                raise ValueError(
                    'a speculative engine binds a mapping {"target": params, '
                    '"draft": params} (the make_speculative_predictor artifact '
                    "contract)"
                )
        with self._lock:
            busy = (
                any(r is not None for r in self._occupant)
                or self._admitting > 0
                or not self._room.empty()
                or not self._inflight.empty()
            )
            if self._params is not None and busy:
                raise RuntimeError(
                    "cannot swap engine params while requests are in "
                    "flight — drain the engine (or create a new one) first"
                )
            self._params = params

    def warmup(self, params) -> int:
        """Run one request per bucket (2 tokens: a 1-token request would
        finish at prefill and never run a decode chunk), so a live
        request never pays first-use costs (kernel builds, allocator
        growth). Returns the number of programs exercised."""
        self.bind(params)
        n = min(2, self.max_new_tokens)
        for b in self.buckets:
            self.generate(params, [np.ones(b, np.int32)], max_new_tokens=n)
        return len(self.buckets) + 1

    def stats(self) -> dict:
        """Serving observability: request timing splits + slot occupancy.

        A thin view over this instance's telemetry-registry series (the
        same numbers ``GET /metrics`` exposes) keeping the historical
        key shape; percentiles come from the histograms' exact sample
        windows, not bucket interpolation."""
        steps = int(self._m_steps.value)
        occupied = int(self._m_occupied.value)
        out = {
            "engine": "continuous",
            "phase": self.phase,
            "slots": self.slots,
            "chunk_steps": self.chunk_steps,
            "pipeline_depth": self.pipeline_depth,
            "completed_requests": int(self._m_requests.value),
            "decode_steps": steps,
            "slot_occupancy": round(occupied / max(1, steps * self.slots), 3),
        }
        if self.draft is not None:
            spec_rounds = int(self._m_spec_rounds.value)
            spec_accepted = int(self._m_spec_accepted.value)
            out["speculative"] = {
                "k": self.speculate_k,
                "rounds": spec_rounds,
                "accepted_draft_tokens": spec_accepted,
                # fraction of proposed draft tokens the target accepted
                "acceptance_rate": round(
                    spec_accepted / max(1, spec_rounds * self.speculate_k), 3
                ),
            }
        if self.kv_pool is not None:
            out["kv_pool"] = self.kv_pool.stats()
        if self._usage is not None:
            # the compact per-tenant view (GET /debug/usage has the
            # full per-tenant resource vectors)
            out["usage"] = self._usage.stats()
        if self._programs is not None:
            # per device program: calls and host time
            out["programs"] = self._programs.stats()
        out["robustness"] = {
            "queue_depth": self._room.qsize(),
            "rejected": {
                reason: int(c.value)
                for reason, c in self._m_rejected.items()
            },
            "deadline_shed": int(self._m_deadline_shed.value),
            "recoveries": int(self._m_recoveries.value),
            "breaker_open": self.breaker_open,
            "draining": self._draining,
        }
        # the scheduler's view: per-class waiting depths and parked
        # pool-exhausted admissions
        out["scheduler"] = self._sched.stats()
        for name, h in (
            ("queue_wait_ms", self._h_queue),
            ("prefill_ms", self._h_prefill),
            ("decode_ms", self._h_decode),
            ("ttft_ms", self._h_ttft),
        ):
            summary = h.summary()
            if summary:
                out[name] = summary
        # decode-lane-pure inter-token latency (the perf plane's
        # chunk-spacing histograms merged across priority classes):
        # unlike decode_ms, no harvest/admission gaps are lumped in
        itl = self._itl_summary()
        if itl:
            out["itl_ms"] = itl
            out["itl_mean_ms"] = itl["mean"]
            out["itl_p99_ms"] = itl["p99"]
        if self._perf is not None:
            out["goodput"] = self._perf.report()
        return out

    def _itl_summary(self) -> dict:
        """Exact percentile summary of the ITL histograms' retained
        windows merged across this engine's priority children
        (``{}`` when the plane is off or nothing decoded yet)."""
        samples: List[float] = []
        for child in self._h_itl.values():
            samples.extend(child.samples())
        if not samples:
            return {}
        return telemetry.percentile_summary(samples)

    def goodput_report(self) -> dict:
        """The ``GET /debug/goodput`` body for this engine: the perf
        plane's ring classification + ratios + watchdog advisory,
        with the ITL/TTFT summaries and — when introspection is on —
        the per-program MFU/roofline view, so achieved tokens/s and
        hardware utilization read off one dashboard. Raises
        ``ValueError`` when the plane is off (transports map it to
        422)."""
        if self._perf is None:
            raise ValueError(
                "serving perf plane is off — construct the engine "
                "with perf=True (the default while introspect=True)"
            )
        out = self._perf.report()
        itl = self._itl_summary()
        if itl:
            out["itl_ms"] = itl
        ttft = self._h_ttft.summary()
        if ttft:
            out["ttft_ms"] = ttft
        if self._programs is not None:
            progs = self._programs.stats()
            out["programs"] = {
                name: {
                    "mfu": p["mfu"],
                    "hbm_utilization": p.get("hbm_utilization"),
                    "achieved_flops_per_s": p.get("achieved_flops_per_s"),
                }
                for name, p in progs.items()
                if isinstance(p, dict) and "mfu" in p
            }
        return out

    def reset_stats(self) -> None:
        """Zero this instance's observability series (benchmarks call
        this between scenarios so each phase's /stats describes only
        that phase); scrapers see the resets as counter restarts."""
        for m in (
            self._m_requests, self._m_errors, self._m_abandoned,
            self._m_timeouts, self._m_steps, self._m_chunks,
            self._m_occupied, self._m_spec_rounds, self._m_spec_accepted,
            self._m_deadline_shed, self._m_recoveries,
            *self._m_rejected.values(),
            self._h_queue, self._h_prefill, self._h_decode, self._h_ttft,
            self._h_dispatch, self._h_harvest, self._h_drain,
            *self._h_itl.values(),
        ):
            m.reset()
        if self._perf is not None:
            self._perf.reset()
        if self.kv_pool is not None:
            self.kv_pool.reset_stats()
        if self._usage is not None:
            self._usage.reset_stats()
        if self._programs is not None:
            self._programs.reset()
        self._sched.reset_stats()

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5.0)
        self._harvester.join(timeout=5.0)
        with self._lock:
            adm, self._admission = self._admission, None
        if adm is not None:
            self._drop_admission(adm.req, RuntimeError("decode engine closed"))
        while True:
            parked = self._room.take_parked()
            if parked is None:
                break
            self._drop_admission(parked, RuntimeError("decode engine closed"))
        # the in-flight pipeline the harvester no longer owns holds
        # readbacks of requests failed below
        while True:
            try:
                self._inflight.get_nowait()
            except queue.Empty:
                break
        for req in self._room.pop_all():
            req.error = RuntimeError("decode engine closed")
            self._tracer.finish_request(req.rid)
            req.event.set()
            req.finish_stream()
        for req in self._occupant:
            if req is not None:
                req.error = RuntimeError("decode engine closed")
                self._tracer.finish_request(req.rid)
                req.event.set()
                req.finish_stream()
        self._occupant = [None] * self.slots
        self._m_slots_busy.set(0)


    # ------------------------------------------------------------------ #
    # engine loop
    # ------------------------------------------------------------------ #

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def _admission_preamble(self, req: _Request):
        """The shared start of every admission (monolithic and chunked):
        pick the free slot, stamp queue-wait, right-pad the prompt to its
        bucket."""
        with self._lock:
            slot = self._occupant.index(None)
        t0 = time.perf_counter()
        req.queue_wait_ms = (t0 - req.submitted) * 1e3
        self._tracer.record_span(req.rid, "queue", req.submitted, t0)
        req._dispatch_t = t0
        bucket = self._bucket_for(len(req.prompt))
        padded = np.full(bucket, self.pad_id, np.int32)
        padded[: len(req.prompt)] = req.prompt
        return slot, bucket, padded

    def _admit(self, req: _Request):
        """Dispatch ``req``'s prefill into a free slot WITHOUT waiting for
        the first token (its readback is harvested later, in dispatch
        order). Dispatcher thread only; occupancy mutates under the lock."""
        slot, bucket, padded = self._admission_preamble(req)
        with self._lock:
            ep0 = self._epoch
            st = self._state
            ids = (
                self._take_covered_locked(req, slot, bucket)
                if self.paged else None
            )
        if st is None:
            st = self._init_state()
        toks = _upload(padded, self.device).long()
        if self.paged:
            first = self._prefill(
                self._params, st, slot, _upload(ids, self.device), toks,
                len(req.prompt),
            )
        else:
            first = self._prefill(self._params, st, slot, toks, len(req.prompt))
        readback = _Readback(first)
        if self._usage is not None:
            req._attr_flops += self._program_cost("engine.prefill", (bucket,))
        with self._lock:
            if self._epoch != ep0:
                # _recover ran (harvester thread) while this prefill was
                # being dispatched: fail this request with the poisoned
                # batch (self._state stays the recovery's None)
                raise RuntimeError(
                    "engine recovered while this admission's prefill "
                    "was in flight; the request failed with the "
                    "poisoned batch"
                )
            self._state = st
            self._occupant[slot] = req
            self._slot_gen[slot] += 1
            req._expected = len(req.tokens) + 1
            self._m_slots_busy.set(self._slots_in_use_locked())
        req.admission_ms = (time.perf_counter() - req._dispatch_t) * 1e3
        self._flight_rec(
            "prefill", rid=req.rid, tenant=req.tenant, slot=slot,
            bucket=bucket, tokens=req._prefilled_tokens, cached_tokens=0,
        )
        self._inflight.put(("prefill", ep0, slot, req, readback))

    # ------------------------------------------------------------------ #
    # usage metering helpers (no-ops when usage=None)
    # ------------------------------------------------------------------ #

    def _program_cost(self, key: str, sig=None) -> float:
        """FLOPs of one dispatch of a tracked program (0: the port's
        programs carry no costs yet)."""
        if self._programs is None:
            return 0.0
        return self._programs.cost(key, sig)[0]

    def _usage_kv_release(self, req: _Request) -> None:
        """Integrate the request's pool-block hold times into its
        tenant's KV block-seconds (idempotent: the stamp list drains).
        Called on every path that gives the blocks back — retirement,
        mid-admission drop, and recovery — so no hold window is left
        open for an abandoned or poisoned request."""
        if self._usage is None or not req._block_t0:
            req._block_t0 = []
            return
        now = time.monotonic()
        held = sum(now - t0 for t0 in req._block_t0)
        req._block_t0 = []
        self._usage.record_kv_block_seconds(req.tenant, held)

    # ------------------------------------------------------------------ #
    # paged-mode pool bookkeeping (engine lock held for all of these)
    # ------------------------------------------------------------------ #

    def _sweep_deferred_locked(self) -> None:
        """Free deferred block batches whose fence has passed: every
        decode chunk dispatched before the owning slot retired has been
        harvested, so no in-flight program can still write the rows."""
        if not self._deferred_free:
            return
        keep = []
        for fence, ids in self._deferred_free:
            if fence <= self._harvest_seq:
                self.kv_pool.give(ids)
            else:
                keep.append((fence, ids))
        self._deferred_free = keep

    def _take_covered_locked(self, req: _Request, slot: int,
                             bucket: int) -> np.ndarray:
        """Convert the leading ``ceil(true_len / block)`` of the
        request's reservation into concrete pool blocks, install them
        in the slot's table row, and return the scatter id vector
        ([bucket/block] int32, trash-padded) the prefill program
        consumes. The rest of the reservation converts lazily as
        decode fills rows (_grow_tables_locked)."""
        blk = self._kv_block_size
        nbb = bucket // blk
        covered = self.kv_pool.blocks_for_rows(len(req.prompt))
        ids = np.zeros(nbb, np.int32)
        self._table[slot, :] = 0
        t_take = time.monotonic() if self._usage is not None else 0.0
        for j in range(covered):
            bid = self.kv_pool.take()
            req._resv_blocks -= 1
            req._block_ids.append(bid)
            if self._usage is not None:
                req._block_t0.append(t_take)
            ids[j] = bid
            self._table[slot, j] = bid
        self._slot_covered[slot] = covered
        self._slot_rows[slot] = len(req.prompt)
        return ids

    def _grow_tables_locked(self) -> np.ndarray:
        """Grow every live slot's block table to cover the NEXT decode
        chunk's worst-case advance (``chunk_steps`` rows), drawing from
        each request's admission-time reservation — which is why growth
        can never fail — and return the table snapshot the chunk
        dispatch uploads. Rows past a request's reserved budget stay on
        the trash block: only overshoot (post-eos / post-budget device
        writes whose tokens the host discards) ever lands there."""
        used_rows = 0
        for slot, req in enumerate(self._occupant):
            if req is None:
                continue
            target_rows = min(
                self._slot_rows[slot] + self.chunk_steps, req._rows_cap
            )
            want = min(
                self.kv_pool.blocks_for_rows(target_rows),
                self._table_width,
            )
            while self._slot_covered[slot] < want and req._resv_blocks > 0:
                bid = self.kv_pool.take()
                req._resv_blocks -= 1
                req._block_ids.append(bid)
                if self._usage is not None:
                    req._block_t0.append(time.monotonic())
                self._table[slot, self._slot_covered[slot]] = bid
                self._slot_covered[slot] += 1
            used_rows += min(self._slot_rows[slot], req._rows_cap)
        self.kv_pool.note_used_rows(used_rows)
        return self._table.copy()

    def _release_blocks_locked(self, req: _Request,
                               slot: Optional[int] = None) -> None:
        """Retirement-path release: taken blocks go on the DEFERRED
        list fenced at the current dispatch seq (an in-flight chunk
        dispatched before this retirement may still write them — the
        free lands only after its harvest); the untaken reservation
        releases immediately (never in any table)."""
        self._usage_kv_release(req)
        ids, req._block_ids = list(req._block_ids), []
        unreserve, req._resv_blocks = req._resv_blocks, 0
        if slot is not None:
            self._table[slot, :] = 0
            self._slot_covered[slot] = 0
            self._slot_rows[slot] = 0
        if req._pool_gen != self.kv_pool.generation:
            return  # a recovery reset the pool under us: ids are stale
        if ids:
            self._deferred_free.append((self._dispatch_seq, ids))
        if unreserve:
            self.kv_pool.give([], unreserve=unreserve)
        self._sweep_deferred_locked()

    def _drop_blocks_now_locked(self, req: _Request) -> None:
        """Mid-admission release (the slot never became occupied, so
        every chunk dispatched so far carried ``active=False`` for it —
        its writes are trash-routed on device): immediate free."""
        self._usage_kv_release(req)
        ids, req._block_ids = list(req._block_ids), []
        unreserve, req._resv_blocks = req._resv_blocks, 0
        if req._pool_gen != self.kv_pool.generation:
            return  # a recovery reset the pool under us: ids are stale
        if ids or unreserve:
            self.kv_pool.give(ids, unreserve=unreserve)

    def _req_done(self, req: _Request, tok: int) -> bool:
        """The single stop predicate (shared by retirement and the
        harvest loop's chunk-splitting — one home so a future stop
        criterion cannot desync them)."""
        return (
            req.abandoned
            or (self.eos_id is not None and tok == self.eos_id)
            or len(req.tokens) >= req.max_new_tokens
        )

    def _observe_itl(self, req: _Request, now: float, n_tokens: int) -> None:
        """Harvester, lock held, perf plane on: one decode chunk's
        inter-token latency — harvest spacing since the previous
        harvested token batch, divided over this chunk's tokens. An
        unanchored request (anchor 0.0: first batch of a segment, or
        just resumed after preemption) only re-anchors, so neither the
        prefill gap nor the evict→resume gap ever counts as ITL and
        resume segments never double-count."""
        self._perf.note_tokens(n_tokens)
        anchor = req._itl_anchor
        req._itl_anchor = now
        if anchor <= 0.0:
            return
        gap_ms = (now - anchor) * 1e3
        self._h_itl[req.priority].observe(gap_ms / n_tokens)
        req._itl_sum_ms += gap_ms
        req._itl_n += n_tokens

    def _finish_if_done(self, slot: int, tok: int) -> bool:
        """Harvester thread, called with the lock held."""
        req = self._occupant[slot]
        if req is None:
            return True
        done = self._req_done(req, tok)
        if done:
            now = time.perf_counter()
            req.decode_ms = (now - req._prefill_end) * 1e3
            # decode_ms is wall time first-token→retirement, so it
            # includes harvest/queue gaps between chunks; the ITL
            # accumulators (chunk-spacing only, reset across
            # preemption) are the decode-lane-pure view
            itl_mean = req._itl_sum_ms / req._itl_n if req._itl_n else 0.0
            if not req.abandoned:
                # exemplar tagging (perf plane only): a top-bucket
                # observation keeps its rid, so GET /debug/tail can
                # hand the slowest recent requests to /debug/trace
                ex = req.rid if self._perf is not None else None
                self._h_queue.observe(req.queue_wait_ms, exemplar=ex)
                self._h_prefill.observe(req.prefill_ms, exemplar=ex)
                self._h_decode.observe(req.decode_ms, exemplar=ex)
                self._h_ttft.observe(req.ttft_ms, exemplar=ex)
                self._m_requests.inc()
                if self._perf is not None:
                    self._perf.observe_request(req.ttft_ms, itl_mean)
                # a successful completion proves the rebuilt state
                # serves: only CONSECUTIVE rebuild failures accumulate
                # toward the circuit breaker
                self._recovery_times.clear()
            else:
                self._m_abandoned.inc()
            self._occupant[slot] = None
            if self.paged:
                # taken blocks free behind the dispatch fence (chunks
                # already in flight may still write them); the untaken
                # reservation frees now
                self._release_blocks_locked(req, slot)
            self._m_slots_busy.set(self._slots_in_use_locked())
            self._tracer.record_span(req.rid, "harvest", self._harvest_t0, now)
            self._tracer.finish_request(req.rid)
            if self._usage is not None:
                if req.abandoned:
                    self._usage.record_drop(req.tenant, "abandoned")
                else:
                    self._usage.finish_request(
                        req.tenant, queue_ms=req.queue_wait_ms,
                        prefill_tokens=req._prefilled_tokens,
                        cached_tokens=0,
                        priority=req.priority,
                        phase=self.phase,
                        version=self.model_version,
                    )
            self._flight_rec(
                "finish", rid=req.rid, tenant=req.tenant, slot=slot,
                tokens=len(req.tokens), abandoned=req.abandoned,
                # the per-request ledger split (docs/observability.md
                # "Serving goodput & tail attribution"): queue →
                # admission → prefill → decode segments + the
                # decode-lane-pure ITL rollup
                queue_ms=round(req.queue_wait_ms, 3),
                admission_ms=round(req.admission_ms, 3),
                prefill_ms=round(req.prefill_ms, 3),
                ttft_ms=round(req.ttft_ms, 3),
                decode_ms=round(req.decode_ms, 3),
                itl_mean_ms=round(itl_mean, 3),
                itl_tokens=req._itl_n,
            )
            req.event.set()
            req.finish_stream()
        return done

    def _process_entry(self, entry) -> None:
        """Account one readback's tokens (harvester thread). The blocking
        wait happens outside the lock; entries arrive in dispatch order,
        so a slot's prefill token always lands before its decode tokens
        and before any reuse of the slot."""
        self._harvest_t0 = time.perf_counter()
        with self._lock:
            cur_epoch = self._epoch
        if entry[1] != cur_epoch:
            # poisoned-era readback: _recover already failed its requests
            return
        self._fire("engine.harvest")
        if entry[0] == "prefill":
            _, _, slot, req, readback = entry
            tok = int(readback.wait()[()])
            now = time.perf_counter()  # after the readback: prefill_ms
            with self._lock:           # includes its in-flight lag
                req.prefill_ms = (now - req._dispatch_t) * 1e3
                req.ttft_ms = (now - req.submitted) * 1e3
                req._prefill_end = now
                # ITL anchor: the next decode chunk's harvest spacing
                # measures from this first token
                req._itl_anchor = now
                self._tracer.record_span(
                    req.rid, "prefill", req._dispatch_t, now,
                    tokens=req._prefilled_tokens,
                )
                req.tokens.append(tok)
                req.emit([tok])
                if self._perf is not None:
                    self._perf.note_tokens(1)
                self._finish_if_done(slot, tok)
            if self._usage is not None:
                # the prefill's exclusive pipeline window, billed wholly
                # to the admitting tenant
                device_s = max(
                    0.0,
                    now - max(req._dispatch_t, self._last_harvest_end),
                )
                self._last_harvest_end = now
                self._usage.attribute(
                    {req.tenant: 1}, device_s=device_s,
                    flops=req._attr_flops,
                )
                req._attr_flops = 0.0
            return
        _, _, mask, gens, readback, dispatched, seq = entry
        toks = readback.wait()
        now = time.perf_counter()  # readback complete: the chunk landed
        self._h_harvest.observe((now - self._harvest_t0) * 1e3)
        tenant_tokens: dict = {}
        with self._lock:
            # slot-major: each request's harvested tokens form ONE
            # streamed chunk, emitted before retirement so the stream's
            # terminal sentinel follows its final tokens
            for slot in np.flatnonzero(mask):
                req = self._occupant[slot]
                if req is None or gens[slot] != self._slot_gen[slot]:
                    continue  # stale: dispatched for a previous occupant
                chunk = self._take_tokens(req, slot, toks)
                self._tracer.record_span(
                    req.rid, f"decode-chunk[{req._chunk_i}]", dispatched, now,
                    tokens=len(chunk),
                )
                self._flight_rec(
                    "decode", rid=req.rid, tenant=req.tenant, slot=slot,
                    chunk=req._chunk_i, tokens=len(chunk),
                )
                req._chunk_i += 1
                req.emit(chunk)
                if self._perf is not None and chunk:
                    self._observe_itl(req, now, len(chunk))
                if self._usage is not None and chunk:
                    tenant_tokens[req.tenant] = (
                        tenant_tokens.get(req.tenant, 0) + len(chunk)
                    )
                if chunk:
                    self._finish_if_done(slot, chunk[-1])
                elif req.abandoned:
                    # a speculative slot frozen on the device emits nothing;
                    # the idle readback still retires an abandoned waiter
                    self._finish_if_done(slot, req.tokens[-1] if req.tokens else self.pad_id)
            if self.paged:
                # this chunk (and by FIFO order every earlier one) has
                # finished on the device: deferred frees fenced at or
                # before it are now safe
                self._harvest_seq = max(self._harvest_seq, seq)
                self._sweep_deferred_locked()
        if self._usage is not None:
            device_s = max(
                0.0, now - max(dispatched, self._last_harvest_end)
            )
            self._last_harvest_end = now
            self._usage.attribute(
                tenant_tokens, device_s=device_s,
                flops=self._program_cost("engine.decode"),
                slot_steps=self.chunk_steps * self.slots,
            )

    def _take_tokens(self, req, slot: int, toks: np.ndarray) -> List[int]:
        """Append one slot's harvested tokens to ``req`` up to its budget
        (the per-token ``_req_done`` walk) and return them. Plain readback
        ``[steps, B]``: one token a step. Speculative readback ``[R, B,
        k+3]``: per round the emission row (k+1), the emitted count and
        the accepted draft count; a round's ``n_emit`` tokens, counting
        the rounds and accepted tokens served (stale and post-retirement
        rounds would skew the /stats acceptance rate)."""
        if self.draft is None:
            stream = (int(step_toks[slot]) for step_toks in toks)
        else:
            k = self.speculate_k

            def rounds():
                for row in toks[:, slot]:
                    n_emit = int(row[k + 1])
                    if n_emit:
                        self._m_spec_rounds.inc()
                        self._m_spec_accepted.inc(int(row[k + 2]))
                    yield from (int(t) for t in row[:n_emit])

            stream = rounds()
        chunk: List[int] = []
        for tok in stream:
            req.tokens.append(tok)
            chunk.append(tok)
            if self._req_done(req, tok):
                break
        return chunk

    def _dispatch_chunk(self) -> bool:
        """Dispatch one decode chunk if the pipeline has a credit and any
        occupant still needs tokens beyond already-dispatched work."""
        if not self._chunk_credits.acquire(blocking=False):
            return False  # pipeline_depth chunks already awaiting harvest
        seq = 0
        table_np = None
        with self._lock:
            mask = np.array([r is not None for r in self._occupant])
            needed = any(
                r is not None and r._expected < r.max_new_tokens
                for r in self._occupant
            )
            ep0 = self._epoch
            st = self._state
            proceed = bool(mask.any()) and needed and st is not None
            if proceed and self.paged:
                # grow tables + snapshot + assign this chunk's fence seq
                # under ONE lock hold: a retirement racing this dispatch
                # fences its deferred frees at _dispatch_seq, which now
                # covers the snapshot about to launch
                table_np = self._grow_tables_locked()
                self._dispatch_seq += 1
                seq = self._dispatch_seq
        if not proceed:
            self._chunk_credits.release()
            return False
        t_dispatch = time.perf_counter()
        try:
            self._fire("engine.dispatch")
            active = _upload(mask, self.device)
            if self.paged:
                toks = self._decode_chunk(
                    self._params, st, active, _upload(table_np, self.device)
                )
            else:
                toks = self._decode_chunk(self._params, st, active)
            readback = _Readback(toks)
            self._h_dispatch.observe((time.perf_counter() - t_dispatch) * 1e3)
        except BaseException:
            # the credit is only released by the harvester for entries that
            # were actually enqueued — give it back or the pipeline wedges
            self._chunk_credits.release()
            raise
        with self._lock:
            if self._epoch != ep0:
                # _recover ran mid-dispatch: drop the readback; the
                # requests it covered are already failed
                self._chunk_credits.release()
                return True
            for slot in np.flatnonzero(mask):
                if self._occupant[slot] is not None:
                    # the GUARANTEED emission per chunk (1 token a round in
                    # speculative mode; acceptance only adds more): an upper
                    # bound here would stop dispatching before enough tokens
                    # land at partial acceptance
                    self._occupant[slot]._expected += self.chunk_steps
                    if self.paged:
                        # host upper bound of the slot's device fill
                        self._slot_rows[slot] = min(
                            self._slot_rows[slot] + self.chunk_steps,
                            self.cache_len,
                        )
            gens = tuple(self._slot_gen)
            self._m_chunks.inc()
            self._m_steps.inc(self.chunk_steps)
            occupied_now = int(mask.sum())
            self._m_occupied.inc(occupied_now * self.chunk_steps)
            if self._perf is not None:
                self._perf.note_pass(
                    occupied_now,
                    prefill_mix=self._admission is not None,
                    kv_in_use=(
                        self.kv_pool.in_use
                        if self.kv_pool is not None else 0
                    ),
                    kv_capacity=(
                        self.kv_pool.capacity
                        if self.kv_pool is not None else 0
                    ),
                )
        self._inflight.put(("chunk", ep0, mask, gens, readback, t_dispatch, seq))
        return True

    def _pop_request(self) -> Optional[_Request]:
        """Atomically dequeue a request and mark it as mid-admission, so
        bind()'s busy check never sees a gap where the request is neither
        queued nor occupying a slot."""
        self._fire("engine.dequeue")
        with self._lock:
            if None not in self._occupant:
                return None
            req = self._room.pop()
            if req is None:
                return None
            self._admitting += 1
        self._g_queue_depth.set(self._room.qsize())
        return req

    def _pop_bypass(self, parked: _Request) -> Optional[_Request]:
        """The PROMOTE path: while ``parked`` head-of-line-blocks its
        class on pool exhaustion, a STRICTLY higher-priority request
        may still admit past it (the waiting room's parked-lane gating
        releases nothing at or below the parked class) — without this,
        a premium request would wait out a bulk backlog's parked head
        in exactly the overload the scheduler exists for."""
        with self._lock:
            if None not in self._occupant:
                return None
            req = self._room.pop(
                above_rank=priority_rank(parked.priority)
            )
            if req is None:
                return None
            self._admitting += 1
        self._flight_rec(
            "promote", rid=req.rid, tenant=req.tenant,
            priority=req.priority, past=parked.rid,
            past_priority=parked.priority,
        )
        self._g_queue_depth.set(self._room.qsize())
        return req

    def _drop_admission(self, req: _Request, exc: BaseException) -> None:
        """Fail a request still mid-admission and release its count.
        Idempotent (keyed on the request event): the dispatcher's own
        error path and a concurrent ``_recover`` from the harvester must
        not double-release ``_admitting``."""
        with self._lock:
            if req.event.is_set():
                return
            req.error = exc
            self._admitting -= 1
            if self.paged:
                # the slot never became occupied, so every dispatched
                # chunk carried active=False for it (writes trash-routed
                # on device) — immediate free is safe
                self._drop_blocks_now_locked(req)
        if req.abandoned:
            self._m_abandoned.inc()
            cause = "abandoned"
            if self._usage is not None:
                self._usage.record_drop(req.tenant, "abandoned")
        elif isinstance(exc, DeadlineExceeded):
            self._m_deadline_shed.inc()
            cause = "deadline_shed"
            if self._usage is not None:
                self._usage.record_deadline_shed(req.tenant)
        else:
            self._m_errors.inc()
            cause = f"error:{type(exc).__name__}"
            if self._usage is not None:
                self._usage.record_drop(req.tenant, "error")
        self._flight_rec("drop", rid=req.rid, tenant=req.tenant, cause=cause)
        self._tracer.finish_request(req.rid)
        req.event.set()
        req.finish_stream()

    def _start_admission(self, req: _Request) -> None:
        """Dispatcher: begin admitting a dequeued request (counted in
        ``_admitting`` by ``_pop_request``). Short buckets prefill in one
        monolithic dispatch; buckets larger than ``prefill_chunk`` start
        a chunked admission whose lead chunks are dispatched one per loop
        pass, interleaved with decode chunks."""
        try:
            if req.abandoned:
                self._drop_admission(
                    req, TimeoutError("request abandoned before admission")
                )
                return
            if req.deadline is not None and time.perf_counter() > req.deadline:
                # shed at dequeue: an expired request never consumes prefill
                waited_ms = (time.perf_counter() - req.submitted) * 1e3
                self._drop_admission(req, DeadlineExceeded(
                    f"request deadline expired while queued "
                    f"(waited {waited_ms:.0f} ms)",
                    deadline_ms=(req.deadline - req.submitted) * 1e3,
                ))
                return
            self._fire("engine.prefill")
            if self.paged and not req._block_ids and req._resv_blocks == 0:
                # reserve the WORST-CASE block count up front so table
                # growth can never fail mid-decode; a transiently full
                # pool PARKS the admission (retried every dispatcher
                # pass) until retirements free blocks
                rows_cap = min(
                    len(req.prompt) + req.max_new_tokens - len(req.tokens),
                    self.cache_len,
                )
                needed = self.kv_pool.blocks_for_rows(rows_cap)
                with self._lock:
                    try:
                        # retries of a parked admission count neither a
                        # new alloc failure nor a new flight event
                        self.kv_pool.reserve(
                            needed, count_failure=not req._park_logged
                        )
                    except PoolExhausted as exc:
                        self._room.park(req)
                        if not req._park_logged:
                            req._park_logged = True
                            resident = [
                                r for r in self._occupant if r is not None
                            ]
                            cand = (
                                min(resident, key=lambda r: r.submitted)
                                if resident else None
                            )
                            self._flight_rec(
                                "pool_pressure", reason="alloc_fail",
                                rid=req.rid, priority=req.priority,
                                needed_blocks=exc.needed,
                                available_blocks=exc.available,
                                preempt_candidate=(
                                    cand.rid if cand is not None else None
                                ),
                                preempt_candidate_blocks=(
                                    len(cand._block_ids)
                                    if cand is not None else 0
                                ),
                            )
                        return
                    req._resv_blocks = needed
                    req._rows_cap = rows_cap
                    req._park_logged = False
                    req._pool_gen = self.kv_pool.generation
            bucket = self._bucket_for(len(req.prompt))
            chunk = self.prefill_chunk
            req._prefilled_tokens = len(req.prompt)
            if chunk is None or bucket <= chunk:
                self._admit(req)
                with self._lock:
                    self._admitting -= 1
                return
            slot, bucket, padded = self._admission_preamble(req)
            # only the chunks covering the TRUE length run
            n_chunks = -(-len(req.prompt) // chunk)
            pool_ids = None
            if self.paged:
                with self._lock:
                    pool_ids = self._take_covered_locked(req, slot, bucket)
            adm = _Admission(
                req=req, slot=slot, bucket=bucket, chunk=chunk,
                n_chunks=n_chunks, padded=padded,
                fresh=self._init_fresh(bucket=bucket), pool_ids=pool_ids,
            )
            with self._lock:
                self._admission = adm
        except BaseException as exc:
            with self._lock:
                self._admission = None
            self._drop_admission(req, exc)

    def _advance_admission(self, adm: _Admission) -> None:
        """Dispatch ONE step of the in-progress admission — a lead prefill
        chunk, or the final chunk that finishes into the slot; decode
        chunks dispatch between calls. ``_recover``/``close`` may
        concurrently null ``_admission`` — every transition re-checks
        identity under the lock so the admission is completed or dropped
        exactly once."""
        req = adm.req
        try:
            if req.abandoned:
                with self._lock:
                    if self._admission is not adm:
                        return
                    self._admission = None
                self._drop_admission(
                    req, TimeoutError("request abandoned during admission")
                )
                return
            self._fire("engine.prefill")
            start = adm.next_chunk * adm.chunk
            toks = _upload(adm.padded[None, start: start + adm.chunk], self.device).long()
            if adm.next_chunk < adm.n_chunks - 1:
                t0 = time.perf_counter()
                adm.fresh = self._prefill_step(self._params, adm.fresh, toks, start)
                if self._usage is not None:
                    req._attr_flops += self._program_cost(
                        "engine.prefill_chunk", tuple(toks.shape)
                    )
                self._tracer.record_span(
                    req.rid, f"prefill-chunk[{adm.next_chunk}]", t0,
                    time.perf_counter(), tokens=adm.chunk,
                )
                adm.next_chunk += 1
                return
            with self._lock:
                ep0 = self._epoch
                st = self._state
                if self._admission is not adm:
                    # raced with _recover/close: the request was already
                    # failed and its count released — do not re-admit
                    return
            if st is None:
                # first admission ever, or a recovery dropped the resident
                # state while this admission was mid-flight: build it fresh
                st = self._init_state()
            if self.paged:
                first = self._prefill_final(
                    self._params, st, adm.fresh, adm.slot,
                    _upload(adm.pool_ids, self.device), toks, start,
                    len(req.prompt),
                )
            else:
                first = self._prefill_final(
                    self._params, st, adm.fresh, adm.slot, toks, start,
                    len(req.prompt),
                )
            readback = _Readback(first)
            if self._usage is not None:
                req._attr_flops += self._program_cost(
                    "engine.prefill_final", tuple(toks.shape)
                )
            with self._lock:
                if self._admission is not adm or self._epoch != ep0:
                    # raced with _recover/close mid-dispatch: the request
                    # was already failed
                    return
                self._state = st
                self._admission = None
                self._occupant[adm.slot] = req
                self._slot_gen[adm.slot] += 1
                req._expected = len(req.tokens) + 1
                self._admitting -= 1
                self._m_slots_busy.set(self._slots_in_use_locked())
            req.admission_ms = (time.perf_counter() - req._dispatch_t) * 1e3
            self._flight_rec(
                "prefill", rid=req.rid, tenant=req.tenant, slot=adm.slot,
                bucket=adm.bucket, tokens=req._prefilled_tokens,
                cached_tokens=0, chunks=adm.n_chunks,
            )
            self._inflight.put(("prefill", ep0, adm.slot, req, readback))
        except BaseException as exc:
            with self._lock:
                if self._admission is adm:
                    self._admission = None
            self._drop_admission(req, exc)

    def _advance_admission_budgeted(self, adm: _Admission) -> None:
        """One dispatcher pass of admission work under the scheduler's
        mixing budget: with ``mix_prefill_tokens`` unset exactly one
        admission step runs per pass, else lead prefill chunks keep
        dispatching until the token budget is spent."""
        budget = self._mix_budget
        if budget is None:
            self._advance_admission(adm)
            return
        remaining = budget
        while self._admission is adm:
            self._advance_admission(adm)
            remaining -= adm.chunk
            if remaining <= 0:
                break

    def _run(self):
        """Dispatcher: admit queued requests into free slots and keep up
        to ``pipeline_depth`` decode chunks in flight. NEVER waits for the
        device — the harvester thread owns the readbacks."""
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    if not self._run_pass():
                        # nothing admittable or dispatchable: arrivals and
                        # harvest-freed slots are picked up next pass
                        if self._perf is not None:
                            self._perf.note_idle()
                        time.sleep(0.002)
                except BaseException as exc:  # pragma: no cover - engine crash
                    self._recover(exc)

    def _run_pass(self) -> bool:
        """One dispatcher pass; returns whether it made progress."""
        progressed = False
        adm = self._admission
        if adm is not None:
            self._advance_admission_budgeted(adm)
            progressed = True
        else:
            # a parked admission (pool exhausted at reservation) retries
            # FIRST; the waiting room only releases strictly-higher-
            # priority requests past it
            req = None
            with self._lock:
                has_slot = None in self._occupant
            if has_slot:
                req = self._room.take_parked()
            if req is None:
                req = self._pop_request()
            if req is not None:
                self._start_admission(req)
                if self._room.is_parked(req):
                    # pool exhausted: a strictly-higher-priority request
                    # may admit past the parked head (it may itself park)
                    breq = self._pop_bypass(req)
                    if breq is not None:
                        self._start_admission(breq)
                        progressed = not self._room.is_parked(breq)
                else:
                    progressed = True
        if self._dispatch_chunk():
            progressed = True
        return progressed

    def _harvest_loop(self):
        """Harvester: wait for the oldest in-flight readback, account its
        tokens, retire finished requests, release the pipeline credit."""
        while not self._stop.is_set():
            try:
                entry = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._process_entry(entry)
            except BaseException as exc:  # pragma: no cover - engine crash
                self._recover(exc)
            finally:
                if entry[0] == "chunk":
                    self._chunk_credits.release()

    def _recover(self, exc: BaseException) -> None:
        """Engine supervision: a failed device program fails ONLY the
        poisoned batch — the resident occupants and the in-progress
        admission, whose device state the error invalidated — then bumps
        the readback epoch (in-flight entries from the poisoned era are
        skipped at harvest) and drops the decode state so the
        next admission rebuilds it; queued requests were never touched
        and re-admit as survivors. Each recovery feeds the circuit
        breaker: ``breaker_threshold`` of them within
        ``breaker_window_s`` (with no successful completion in between)
        open it for ``breaker_cooldown_s``. (A real CUDA error is sticky
        for the process: the rebuilt state fails again and the breaker
        opens; only injected faults are recoverable in-process.)"""
        t0 = time.perf_counter()
        logger.info(
            f"decode engine error: {exc!r} — failing the poisoned batch "
            "and rebuilding decode state"
        )
        poisoned: List[str] = []
        with self._lock:
            adm, self._admission = self._admission, None
        if adm is not None:
            poisoned.append(adm.req.rid)
            self._drop_admission(adm.req, exc)
        with self._lock:
            self._epoch += 1
            for slot, req in enumerate(self._occupant):
                if req is not None:
                    poisoned.append(req.rid)
                    req.error = exc
                    self._m_errors.inc()
                    self._tracer.finish_request(req.rid)
                    if self._usage is not None:
                        # close the hold window and bill the drop before
                        # the pool bookkeeping is reset under it
                        self._usage_kv_release(req)
                        self._usage.record_drop(req.tenant, "error")
                    # pool bookkeeping resets wholesale below — zero the
                    # per-request fields so nothing double-frees
                    req._block_ids = []
                    req._resv_blocks = 0
                    req.event.set()
                    req.finish_stream()
                    self._occupant[slot] = None
            self._m_slots_busy.set(0)
            self._state = None
            if self.paged:
                # the device pool arrays are dropped with the state;
                # the next admission's _init_state rebuilds them, so
                # host bookkeeping resets with them (in-flight poisoned
                # readbacks are epoch-skipped and write dead buffers)
                self.kv_pool.reset()
                self._table[:] = 0
                self._slot_covered = [0] * self.slots
                self._slot_rows = [0] * self.slots
                self._deferred_free = []
                self._harvest_seq = self._dispatch_seq
            self._m_recoveries.inc()
            now = time.monotonic()
            self._recovery_times.append(now)
            while (
                self._recovery_times
                and now - self._recovery_times[0] > self.breaker_window_s
            ):
                self._recovery_times.popleft()
            if len(self._recovery_times) >= self.breaker_threshold:
                self._breaker_open_until = now + self.breaker_cooldown_s
                self._g_breaker.set(1.0)
                logger.info(
                    f"engine circuit breaker OPEN: "
                    f"{len(self._recovery_times)} recoveries within "
                    f"{self.breaker_window_s}s; rejecting submissions "
                    f"for {self.breaker_cooldown_s}s"
                )
        # the recovery itself is a traceable event (recoveries get
        # their own synthetic timeline) — with the flight-recorder
        # snapshot of the poisoned requests' lifecycle attached, so the
        # postmortem names WHO died and what they were doing when the
        # device program failed
        span_args: dict = {
            "error": repr(exc)[:200], "poisoned": list(poisoned),
        }
        if self._flight is not None:
            self._flight_rec(
                "recovery", rids=list(poisoned), error=repr(exc)[:200],
            )
            span_args["flight"] = self._flight.snapshot(poisoned)
        rid = self._tracer.new_request("recovery")
        self._tracer.record_span(
            rid, "recover", t0, time.perf_counter(), **span_args
        )
        self._tracer.finish_request(rid)
