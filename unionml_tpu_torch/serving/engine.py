"""Continuous-batching decode engine: step-boundary request joins.

The port of :mod:`unionml_tpu.serving.engine`'s ``DecodeEngine`` in its
two layouts, contiguous and block-paged. The host machinery carries over
in logic: the waiting room, chunked admission (``prefill_chunk``), the
dispatcher thread that never waits for the device and the harvester
thread that does, per-slot generation counters, the epoch-tagged
``_recover``, the circuit breaker, ``drain``/``resume``, deadlines, the
``FaultInjector`` points, the paged allocator with fence-deferred frees
and reservation at submit, usage metering and the serving perf plane.

The device programs are functions on tensors that update the resident
state IN PLACE, the counterpart of the reference's donated state: every
state tensor keeps its storage from chunk to chunk and admission to
admission.

- the decode chunk is a Python loop of ``chunk_steps`` single-token
  steps (the reference's ``lax.scan``), with ``live``, ``done``,
  ``fill`` and ``last_tok`` kept on the device and each step's tokens
  written into one ``[chunk_steps, slots]`` state buffer — nothing in the
  loop reads a device value on the host;
- a monolithic admission prefills a fresh ``[1, bucket]`` cache and
  writes it into the slot's rows (contiguous) or scatters it into the
  slot's pool blocks with one indexed write per buffer (paged);
- on the card each decode chunk (every layout) and each paged admission
  program runs as a CUDA graph captured once per signature and replayed
  (:mod:`~unionml_tpu_torch.serving._programs`, the reference's one
  executable per bucket): a paged admission takes its slot, pool block
  ids, tokens, offset and length as device inputs and fills a static
  ``[1, bucket]`` fresh cache per bucket;
- each chunk's tokens are copied into pinned host memory without
  blocking, on the program's stream right behind it, and a CUDA event is
  recorded after the copy; the harvester waits on that event (never on
  the whole device), so "harvested" means the chunk finished on the card
  — what the fence-deferred frees of the paged pool need.

With ``draft_module`` the engine is SPECULATIVE (contiguous layout
only, as in the reference): each decode chunk is ``chunk_steps`` rounds
of per-slot draft proposals and ONE shared ``[slots, k+1]`` verify
forward of the target, with greedy acceptance, eos truncation and fill
advance kept on the device; the host reads each round's emissions through
the same pinned copy and event.

With a :class:`~unionml_tpu_torch.serving.prefix_cache.RadixPrefixCache`
(``prefix_cache=``, or the ``system_prefix`` shim) admission leases the
longest cached block-prefix of the prompt, splices its host blocks into
the fresh cache (one host→device copy per block from pinned memory,
memoized on the device, then one multi-tensor copy into the fresh rows),
and prefills only the uncovered suffix through the cached path. Right
after a prefill's scatter the prompt's new full blocks are gathered on
the same stream into one staging buffer and copied without blocking into
one pinned host buffer per block; the harvester waits on that copy's
event, then inserts the blocks. Preemption
(``SchedulerConfig(preempt=...)``, on by default with a paged pool and a
prefix cache) saves a victim's blocks through the same path and resumes
it by splicing them back. ``prefill_export`` / ``kv_export`` /
``kv_import`` hand a request's blocks to another engine.

A tree placed over several ranks (tensor and expert parallelism) is
served by one engine per rank under ONE controller, the port's form of
the reference's single controller over the mesh (the reference has no
follower: GSPMD issues its collectives from one program). The first rank
of the tree's parallel groups takes every request (``generate``,
``generate_stream``, ``prefill_export``, a ``ServingApp`` in front of
it) and makes every decision: arrivals, deadline shedding, cancellations,
the queue bound and the breaker, and the host prefix store's exports and
imports. Each dispatcher pass it publishes one
plan of those decisions through the process group's key-value store;
the other ranks run :meth:`DecodeEngine.follow`, whose dispatcher applies
each plan in order and then runs the same pass, so every rank admits,
splices and dispatches alike and their forwards issue the same
collectives in the same order. Every rank decides each pass on a drained
pipeline (the harvests, retirements and prefix inserts of earlier passes
done), so nothing read from the harvest differs between ranks; the
dispatch / harvest overlap is given up there (ROADMAP.md C14).

On the CPU (the tests) the same code runs synchronously. An injected
fault (``FaultInjector``) is recovered as in the reference; a real CUDA
error is sticky for the process and cannot be recovered by rebuilding
state — the engine then fails every later request.
"""

from __future__ import annotations

import itertools
import math
import pickle
import queue
import threading
import time
from collections import OrderedDict, deque
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch import telemetry
from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops._build import nan_scope
from unionml_tpu_torch.serving._programs import EnginePrograms
from unionml_tpu_torch.serving._programs import upload as _upload
from unionml_tpu_torch.serving.faults import (
    DeadlineExceeded,
    EngineUnavailable,
    Overloaded,
    current_deadline_ms,
)
from unionml_tpu_torch.serving.kv_pool import KVBlockPool, PoolExhausted
from unionml_tpu_torch.serving.prefix_cache import (
    block_specs,
    carve,
    host_empty,
    pack_rows,
    packed_base,
    packed_nbytes,
    PrefixLease,
)
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


class _HostBlocks:
    """Full KV blocks on their way to the host store. ``srcs`` holds one
    block tree of ``[1, block, ...]`` device views per block, read in
    stream order behind the program that wrote them. On CUDA they are
    gathered into one staging buffer (one multi-tensor copy), copied
    without blocking into ONE pinned host buffer per block, and an event
    is recorded; :meth:`wait` blocks on that event alone and returns the
    host block trees (views into each block's buffer, the layout
    :func:`~unionml_tpu_torch.serving.prefix_cache.carve` gives)."""

    __slots__ = ("_flats", "_specs", "_event")

    def __init__(self, srcs: list):
        self._specs = block_specs(srcs[0])
        nbytes = packed_nbytes(self._specs)
        self._flats = [host_empty(nbytes) for _ in srcs]
        self._event = None
        device = srcs[0][0][0].device
        if device.type == "cuda":
            staging = torch.empty((len(srcs), nbytes), dtype=torch.uint8, device=device)
            stages = [carve(staging[j], self._specs) for j in range(len(srcs))]
        else:
            stages = [carve(flat, self._specs) for flat in self._flats]
        torch._foreach_copy_(
            [buf for tree in stages for layer in tree for buf in layer],
            [buf for tree in srcs for layer in tree for buf in layer],
        )
        if device.type == "cuda":
            for j, flat in enumerate(self._flats):
                flat.copy_(staging[j], non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [carve(flat, self._specs) for flat in self._flats]


def _upload_rows(rows, device: torch.device):
    """One host block tree on ``device`` without waiting for the device:
    ONE copy of its packed pinned buffer (the engine's own blocks), else
    one copy per buffer from a pinned copy. On the CPU, the tree itself."""
    if device.type != "cuda":
        return rows
    base = packed_base(rows)
    if base is not None and base.is_pinned():
        return carve(base.to(device, non_blocking=True), block_specs(rows))
    return tuple(
        tuple((buf if buf.is_pinned() else buf.pin_memory()).to(device, non_blocking=True)
              for buf in layer)
        for layer in rows
    )


def _splice_rows(fresh, blocks, start: int) -> None:
    """Write block trees into the fresh ``[1, bucket]`` cache at rows
    ``start``, ``start + block``, ... in ONE multi-tensor copy — per
    layer, per buffer, rank-generic (the int8 cache's scale planes
    alike)."""
    dst, src = [], []
    r0 = start
    for tree in blocks:
        n = tree[0][0].shape[1]
        for f_layer, s_layer in zip(fresh, tree):
            for fbuf, sbuf in zip(f_layer, s_layer):
                dst.append(fbuf[:, r0:r0 + n])
                src.append(sbuf)
        r0 += n
    torch._foreach_copy_(dst, src)


@dataclass
class _Admission:
    """A chunked prefill in progress: host cursor over the lead chunks.

    The fresh cache lives here, not in the engine state, so lead chunks
    and decode chunks never touch the same buffers and interleave freely
    in dispatch order."""

    req: "_Request"
    slot: int
    bucket: int
    chunk: int                      # tokens per program (prefill_chunk,
    #                                 or the splice unit of a cache hit)
    n_chunks: int                   # total programs incl. the final
    padded: np.ndarray              # [bucket] right-padded prompt
    fresh: Any                      # [1, bucket] cache being filled
    # paged mode: the slot's pool block ids for the final scatter
    # ([bucket/block] int32; uncovered tail entries = trash block)
    pool_ids: Optional[np.ndarray] = None
    next_chunk: int = 0
    # prefix-cache hit: one entry per chunk-sized splice unit (a tuple of
    # cached host block trees covering rows [i*chunk, (i+1)*chunk)),
    # spliced before the remaining chunks run (next_chunk starts past them)
    splice_rows: List[Any] = field(default_factory=list)
    next_splice: int = 0


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
    _lease: Optional[Any] = None        # PrefixLease pinning matched blocks
    _matched_blocks: int = 0            # radix-tree blocks found at admission
    _prefilled_tokens: int = 0          # prompt tokens actually prefilled
    _saved_tokens: int = 0              # prompt tokens spliced from cache
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
    # preemption: times evicted, when the last eviction happened (the
    # resume-wait span anchor; also marks the request as resumed so its
    # ttft and queue timings stay the first segment's), and the lease
    # pinning the evicted blocks in the host store until the resume
    # admission takes its own
    _preempts: int = 0
    _preempted_at: float = 0.0
    _resume_lease: Optional[Any] = None
    # generated tokens already folded into ``prompt`` by a previous
    # resume: the next eviction appends only tokens[_prompt_incl:]
    _prompt_incl: int = 0
    # prefill_export: set once the request's KV blocks landed in the
    # host store (the insert entry's lease release, or any terminal path)
    _kv_event: Optional[threading.Event] = None
    # serving goodput plane: host-side admission span and ITL anchors
    admission_ms: float = 0.0
    _itl_anchor: float = 0.0
    _itl_sum_ms: float = 0.0
    _itl_n: int = 0
    # a multi-rank engine's plan: the request's id in the plans, the
    # caller's cancellation (applied by the next plan), the controller's
    # deadline verdict, and a prefill_export whose lease the plan takes
    _pid: int = -1
    _cancelled: bool = False
    _shed: bool = False
    _export: bool = False

    def emit(self, chunk: List[int]) -> None:
        if self.stream is not None and chunk:
            self.stream.put(chunk)

    def finish_stream(self) -> None:
        if self.stream is not None:
            self.stream.put(None)


#: per process: how many multi-rank engines each set of ranks has bound,
#: which names each engine's plan channel alike on every rank of the set
_CHANNELS: Dict[Tuple[int, ...], int] = {}
_CHANNELS_LOCK = threading.Lock()


class _PlanChannel:
    """The plans of one multi-rank engine, in order: the controller
    publishes plan ``n`` under ``<key>/<n>`` in the process group's
    key-value store, each follower polls for it, and the last follower to
    read it deletes it. A store, not a collective: an idle controller
    sends nothing and a follower waits without a collective timeout, and
    two engines over the same ranks cannot pair each other's messages."""

    def __init__(self, ranks: Tuple[int, ...]):
        import torch.distributed as dist

        with _CHANNELS_LOCK:
            n = _CHANNELS.get(ranks, 0)
            _CHANNELS[ranks] = n + 1
        self._store = dist.distributed_c10d._get_default_store()
        self._key = f"unionml_engine_plans/{'-'.join(map(str, ranks))}/{n}"
        self.ranks = ranks
        self._followers = len(ranks) - 1
        self.seq = 0

    def publish(self, plan: dict) -> None:
        self._store.set(f"{self._key}/{self.seq}", pickle.dumps(plan))
        self.seq += 1

    def receive(self, stop: threading.Event) -> Optional[dict]:
        """The next plan; ``None`` once ``stop`` is set while waiting."""
        plan = self.read_shared(str(self.seq), stop)
        if plan is not None:
            self.seq += 1
        return plan

    def put(self, name: str, value: Any) -> None:
        """A payload of its own beside the plans (a kv import's blocks, a
        follower's part of a kv export)."""
        self._store.set(f"{self._key}/{name}", pickle.dumps(value))

    def _wait(self, key: str, stop: threading.Event, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        wait = 1e-4
        while not self._store.check([key]):
            if stop.is_set() or (deadline is not None and time.monotonic() > deadline):
                return False
            time.sleep(wait)
            wait = min(2 * wait, 0.01)
        return True

    def read_shared(self, name: str, stop: threading.Event) -> Any:
        """A value every follower reads once (the last deletes it);
        ``None`` once ``stop`` is set while waiting."""
        key = f"{self._key}/{name}"
        if not self._wait(key, stop, None):
            return None
        value = pickle.loads(self._store.get(key))
        if self._store.add(f"{key}/read", 1) == self._followers:
            self._store.delete_key(key)
            self._store.delete_key(f"{key}/read")
        return value

    def take(self, name: str, stop: threading.Event, timeout: float) -> Any:
        """A value one reader takes (and deletes); raises ``TimeoutError``
        after ``timeout`` seconds."""
        key = f"{self._key}/{name}"
        if not self._wait(key, stop, timeout):
            raise TimeoutError(f"no {name} from the engine's ranks in {timeout} s")
        value = pickle.loads(self._store.get(key))
        self._store.delete_key(key)
        return value


class _KvOp:
    """A multi-rank engine's ``kv_export`` / ``kv_import`` waiting for the
    plan that applies it on every rank (ROADMAP.md C14)."""

    __slots__ = ("kind", "payload", "pid", "event", "result", "error")

    def __init__(self, kind: str, payload: Any):
        self.kind, self.payload = kind, payload
        self.pid = -1
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class _PlanLease:
    """A multi-rank ``prefill_export``'s lease: every rank took it at the
    same harvest, and its release reaches every rank through the next
    plan (an LRU pin dropped on one rank's clock would let the ranks'
    prefix stores evict differently)."""

    def __init__(self, engine: "DecodeEngine", pid: int, lease):
        self._engine, self._pid = engine, pid
        self.rows, self.n_blocks, self.n_tokens = lease.rows, lease.n_blocks, lease.n_tokens

    def release(self) -> None:
        engine, self._engine = self._engine, None
        if engine is not None:
            with engine._lock:
                engine._releases.append(self._pid)


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
        introspect: program tracking (calls, host time, and the FLOPs and
            bytes counted at each program signature's first dispatch,
            :class:`~unionml_tpu_torch.introspection.ProgramTracker`) and
            flight recording.
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
            .SchedulerConfig` for the waiting room. Preemption (evicting a
            strictly lower-priority resident's blocks to the host prefix
            store so a higher-priority waiter can admit, resuming it later
            through the splice path) is on by default when the engine is
            ``paged`` and has a ``prefix_cache``;
            ``SchedulerConfig(preempt=True)`` makes a missing
            prerequisite a construction error.
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
            "draft": ...}`` params mapping. Greedy only; composes with
            ``system_prefix`` (the prefix rides through both prefills),
            not with ``paged`` or ``prefix_cache``.
        speculate_k: draft tokens proposed per round (k+1 emitted at
            most; a round costs k+1 draft steps and one (k+1)-token
            verify).
        system_prefix: token ids prepended to EVERY request's prompt.
            The shim over the prefix cache: its blocks are pinned there,
            so after the first admission computes them they are spliced,
            never prefilled again, and never evicted. Buckets are widened
            by the prefix length (and rounded to the block unit).
        prefix_cache: a :class:`~unionml_tpu_torch.serving.prefix_cache
            .RadixPrefixCache` (or ``True`` for a default one) enabling
            cross-request prefix reuse: admission splices the longest
            cached block-prefix of the prompt and prefills only the
            uncovered suffix; completion inserts the prompt's new blocks.
            Buckets are rounded up to ``lcm(block_size, prefill_chunk)``
            multiples. One cache per weight binding: ``bind`` to other
            params clears it. Defaults to a private cache when
            ``system_prefix`` is set, else off.

    A tree placed over several ranks (:func:`~unionml_tpu_torch.parallel
    .shard_pytree` with ``tensor`` or ``expert`` > 1) is served by one
    engine per rank, built alike and bound in the same order on every
    rank, under one controller: the first rank of the tree's ``expert`` x
    ``tensor`` ranks (:attr:`role` ``"controller"``, rank 0 of the tensor
    group under plain tensor parallelism) takes every request — put a
    ``ServingApp`` in front of it — and publishes each dispatcher pass's
    plan; every other rank calls :meth:`follow` with its own placed tree
    and takes no request (its ``generate`` / ``generate_stream`` /
    ``prefill_export`` / ``kv_export`` / ``kv_import`` raise, naming the
    controller). The controller's ``kv_export`` and ``kv_import`` ride its
    next plan: every rank looks up or attaches its own kv heads of the
    blocks at the same plan position, so the ranks' host stores keep one
    LRU order.
    Closing the controller's engine ends the followers' :meth:`follow`.
    Swapping the weights of such an engine is refused: close it on every
    rank and build another.
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
        if slots < 1:
            raise ValueError("need at least one slot")
        if not prompt_buckets:
            raise ValueError("need at least one prompt bucket")
        self.device = resolve_device(device)
        self.phase = validate_phase(phase)
        self.model_version: Optional[str] = None
        self.module = module
        self.cfg = module.config
        # the layout caches and pool blocks are built with: the config's
        # kv heads, or a placed tree's local ones once it binds
        self._cache_cfg = self.cfg
        self._draft_cache_cfg = draft_module.config if draft_module is not None else None
        self._params_src: Any = None
        # a placed tree over several ranks: one controller publishes each
        # pass's plan (_take_plan), every rank decides on a drained
        # pipeline (_drain_pipeline). The controller's submitted requests
        # wait in _staged for the next plan; _planned holds every rank's
        # planned requests by plan id until they finish
        self._lockstep = False
        self.role = "solo"
        self._controller_rank = 0
        self._channel: Optional[_PlanChannel] = None
        self._followed = threading.Event()
        self._staged: List[_Request] = []
        self._planned: Dict[int, _Request] = {}
        self._plan_ids = itertools.count()
        self._releases: List[int] = []
        self._export_leases: Dict[int, Any] = {}
        # kv_export / kv_import calls waiting for a plan, and the
        # controller's ones in the plan being applied (by op id)
        self._kv_ops: List[_KvOp] = []
        self._kv_applying: Dict[int, _KvOp] = {}
        self._kv_ids = itertools.count()
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
        # shared system prefix (the shim over the prefix cache): its tokens
        # are PREPENDED to every prompt and its blocks pinned in the cache
        self._prefix_tokens = (
            None if system_prefix is None
            else np.asarray(system_prefix, np.int32).ravel()
        )
        if self._prefix_tokens is not None and self._prefix_tokens.size == 0:
            raise ValueError("system_prefix must be non-empty when given")
        self.prefix_len = 0 if self._prefix_tokens is None else len(self._prefix_tokens)
        if prefix_cache is None and self._prefix_tokens is not None and self.draft is None:
            prefix_cache = True
        if prefix_cache is True:
            from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

            prefix_cache = RadixPrefixCache(registry=self._registry)
        self.prefix_cache = prefix_cache or None
        if self._prefix_tokens is not None and self.prefix_cache is not None:
            self.prefix_cache.pin(self._prefix_tokens)
        self.paged = bool(
            paged or kv_pool_bytes is not None or kv_pool_blocks is not None
        )
        self._kv_block_size_arg = (
            None if kv_block_size is None else int(kv_block_size)
        )
        if self._kv_block_size_arg is not None and self._kv_block_size_arg < 1:
            raise ValueError("kv_block_size must be >= 1")
        # device copies of recently spliced units (dispatcher thread
        # only): a hot prefix uploads host→device once, not per admission.
        # Entries hold the host block tuples too, so an id() key can never
        # be recycled while its entry lives.
        self._dev_splice: "OrderedDict" = OrderedDict()
        self._dev_splice_cap = 8
        # the prefix widens every bucket (prompts include it), and a
        # shared block unit (prefix cache and/or paged pool) rounds buckets
        # up to lcm(block, prefill_chunk) so cached admissions, paged block
        # scatters and chunked prefill keep evenly-covered shapes
        self._kv_block_size, align = self._block_geometry()
        raw = sorted(set(int(b) for b in prompt_buckets))
        if self.prefix_len or self.prefix_cache is not None or self.paged:
            raw = sorted(set(-(-(b + self.prefix_len) // align) * align for b in raw))
        self.buckets = tuple(raw)
        # prompts are truncated to this BEFORE the prefix is prepended
        self._user_max = self.buckets[-1] - self.prefix_len
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
            self._pool_bytes_arg = None if kv_pool_blocks is not None else kv_pool_bytes
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
        # the compiled programs (one CUDA graph per signature on the card);
        # a sampling engine's graphs draw from its generator
        self._graphs = EnginePrograms(
            self.device, self.instance,
            generators=(self._gen,) if temperature != 0.0 else (),
        )
        # paged mode: one static [1, bucket] fresh cache per bucket, which
        # every admission of that bucket fills (its programs' graphs read it)
        self._fresh: Dict[int, Any] = {}
        self._params: Any = None
        self._weight_dtypes: tuple = ()
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
        can_preempt = self.paged and self.prefix_cache is not None
        if sched_cfg.preempt and not can_preempt:
            raise ValueError(
                "SchedulerConfig(preempt=True) needs a paged engine with a "
                "prefix cache — eviction stores the victim's pool blocks in "
                "the host prefix-cache store and resume splices them back; "
                "pass paged=True and prefix_cache=..."
            )
        self._preempt_enabled = (
            can_preempt if sched_cfg.preempt is None else bool(sched_cfg.preempt)
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
        self._closing = False
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
        .introspection.ProgramTracker`: calls, host time, FLOPs and bytes
        per program (counted at each signature's first dispatch) land in
        ``/metrics`` and ``stats()["programs"]``. The sig lambdas are ONE
        shape attribute each (they run per dispatch)."""
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
        if self.prefix_cache is not None:
            self._splice_block = tr.wrap(
                "engine.splice_block", self._splice_block,
                sig_fn=lambda fresh, rows, start: len(rows),
            )
            self._extract_blocks = tr.wrap(
                "engine.extract_blocks", self._extract_blocks,
                sig_fn=lambda st, slot, ids, first, n: n - first,
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
                    queue_depth=self._room.qsize() + len(self._staged),
                )
                if self._lockstep:
                    self._staged.append(req)
                else:
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
            # a multi-rank controller's arrivals wait for the next plan
            depth = self._room.qsize() + len(self._staged)
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
            "queue_depth": self._room.qsize() + len(self._staged),
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
                    and not self._staged
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
        """The single home for KV block geometry: ``(block, align)``.

        ``block`` is the shared unit of the paged pool AND the prefix
        cache's host store (splice and extract are per-block copies), so
        an explicit ``kv_block_size`` that contradicts the attached cache
        raises. ``align`` is the bucket rounding unit ``lcm(block,
        prefill_chunk)``."""
        cache_blk = self.prefix_cache.block_size if self.prefix_cache is not None else None
        pool_blk = self._kv_block_size_arg if self.paged else None
        if pool_blk is not None and cache_blk is not None and pool_blk != cache_blk:
            raise ValueError(
                f"kv_block_size {pool_blk} != prefix cache block_size "
                f"{cache_blk} — the device pool and the host block store "
                "share one block unit (admission splice and harvest "
                "extract are per-block copies); drop kv_block_size or "
                "rebuild the cache with the matching block_size"
            )
        block = pool_blk or cache_blk or (16 if self.paged else None)
        align = block or 1
        if self.prefill_chunk is not None:
            align = math.lcm(align, self.prefill_chunk)
        return block, align

    def _kv_block_nbytes(self, blk: int) -> int:
        """Device bytes of one pool block across every layer and buffer
        (``init_cache``'s layout: bf16 k/v, or int8 k/v + fp32
        per-(row, head) scales under ``kv_quant``)."""
        cfg = self._cache_cfg
        rows = blk * cfg.num_kv_heads
        if getattr(cfg, "kv_quant", False):
            per_layer = 2 * (rows * cfg.head_dim * 1 + rows * 4)
        else:
            per_layer = 2 * rows * cfg.head_dim * 2
        return cfg.num_layers * per_layer

    # ------------------------------------------------------------------ #
    # device programs (eager; they update the resident state in place)
    # ------------------------------------------------------------------ #

    def _run_prefill(self, params, fresh, toks, start, true_len, *, full: bool = False):
        """The prefill tail shared by every admission: run ``toks`` (the
        whole right-padded bucket at ``start=0``, or the final chunk at
        its offset) against ``fresh`` and sample the first token at the
        last REAL position. ``start`` and ``true_len`` are ints, or device
        tensors (a 0-d offset, a ``[1]`` length) where the program is
        captured. Returns ``(first [] device tensor, fresh)``."""
        dev = self.device
        bucket = fresh[0][0].shape[1]
        c = toks.shape[1]
        kv_mask = (torch.arange(bucket, device=dev) < true_len)[None, :]
        last = true_len - 1 - start
        logits, filled = self.module(
            params, toks,
            positions=start + torch.arange(c, device=dev)[None, :],
            cache=fresh, cache_index=start, kv_mask=kv_mask,
            # head on the last REAL position only
            logit_index=(last.reshape(1).long() if isinstance(last, torch.Tensor)
                         else torch.full((1,), last, dtype=torch.long, device=dev)),
            full_prefill=full,
        )
        first = self._sample(logits[:, 0], self._gen)[0]
        return first, filled

    def _run_program(self, program: str, key: tuple, fn, args: tuple, host: tuple,
                     sig=None):
        """Device program ``fn(*args, *inputs)``, ``inputs`` the host arrays
        ``host`` on the device: on the card the CUDA graph of its signature
        (``key``, the layout's dtypes and the identities of ``args``),
        captured at its first call; else eagerly
        (:class:`~unionml_tpu_torch.serving._programs.EnginePrograms`)."""
        st = args[1]
        bufs = st["pool" if "pool" in st else "cache"] if isinstance(st, dict) else st
        dtypes = (self._weight_dtypes, bufs[0][0].dtype)
        return self._graphs.run(program, (*key, *dtypes), fn, args, host,
                                tracker=self._programs, sig=sig)

    def _forget_state(self, st) -> None:
        """Drop the graphs captured on a state a recovery replaced (they
        hold it alive); the next dispatch captures on the new one."""
        if st is not None and st is not self._state:
            self._graphs.drop(keep=lambda key, refs: all(r is not st for r in refs))

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
                "cache": init_cache(self._cache_cfg, B, L, device=dev),
                "kv_mask": torch.zeros((B, L), dtype=torch.bool, device=dev),
                # empty slots idle at row 0: dead slots still run the
                # decode step and write garbage k/v at their fill row —
                # row 0 stays masked False and is overwritten by the next
                # admission's full-bucket write
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
                # each decode chunk's tokens
                "toks": torch.zeros((self.chunk_steps, B), dtype=torch.long, device=dev),
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
            fresh = init_cache(self._cache_cfg, 1, tokens.shape[0], device=dev)
            return finish_prefill(
                params, state, fresh, slot, tokens[None], 0, true_len, full=full_ok,
            )

        self._prefill = prefill
        self._prefill_final = finish_prefill
        self._init_fresh = lambda *, bucket: init_cache(self._cache_cfg, 1, bucket, device=dev)
        self._prefill_step = self._make_prefill_step()

        def decode_chunk(params, state, active):
            """``chunk_steps`` decode steps for every slot, in place;
            returns the state's token buffer [chunk_steps, slots]."""
            fill, done, kv_mask = state["fill"], state["done"], state["kv_mask"]
            for i in range(self.chunk_steps):
                live = active & ~done
                # this step writes its k/v at row `fill`; the new token
                # must see ITSELF, so expose the row before the step — for
                # live slots only
                kv_mask |= (rows_l[None, :] == fill[:, None]) & live[:, None]
                logits, _ = module(
                    params, state["last_tok"][:, None], cache=state["cache"],
                    cache_index=fill, kv_mask=kv_mask,
                )
                nxt = torch.where(live, sample(logits[:, -1], self._gen), pad_id)
                stop = live & (nxt == eos_id) if eos_id is not None else None
                advance = live & (fill + 1 < L)
                # a live slot at the cache end freezes its fill on a
                # masked-True row — mark done so it stops writing there
                done |= live & ~advance
                if stop is not None:
                    done |= stop
                fill += advance.int()
                state["last_tok"].copy_(torch.where(live, nxt, state["last_tok"]))
                state["toks"][i].copy_(nxt)
            return state["toks"]

        self._decode_chunk = decode_chunk
        self._build_cache_programs()

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

    def _build_cache_programs(self):
        """Prefix-cache device programs (cache-enabled engines only):

        - ``_splice_block(fresh, rows, start)``: one splice unit's device
          block trees written into the fresh cache from row ``start``
          (:func:`_splice_rows`);
        - ``_extract_blocks(st, slot, ids, first, n)``: blocks ``[first,
          n)`` of a slot on their way to the host store
          (:class:`_HostBlocks`), by pool block id ``ids[j]`` (paged) or
          by row window (contiguous). Enqueued on the stream right behind
          the program that wrote them, so they read its rows and nothing
          later.

        Both are rank-generic over the cache tree, so the int8 cache's
        scale planes ride along."""
        if self.prefix_cache is None:
            return
        blk = self._kv_block_size

        def splice_block(fresh, rows, start):
            _splice_rows(fresh, rows, start)
            return fresh

        def extract_blocks(st, slot, ids, first, n):
            if self.paged:
                srcs = [
                    tuple(tuple(buf[b:b + 1] for buf in layer) for layer in st["pool"])
                    for b in (int(i) for i in ids[first:n])
                ]
            else:
                srcs = [
                    tuple(tuple(buf[slot:slot + 1, j * blk:(j + 1) * blk] for buf in layer)
                          for layer in st["cache"])
                    for j in range(first, n)
                ]
            return _HostBlocks(srcs)

        self._splice_block = splice_block
        self._extract_blocks = extract_blocks

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
                "pool": init_cache(self._cache_cfg, n_pool, blk, device=dev),
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
                # each decode chunk's tokens, and an admission's first token
                "toks": torch.zeros((self.chunk_steps, B), dtype=torch.long, device=dev),
                "first": torch.zeros((), dtype=torch.long, device=dev),
            }

        self._init_state = init_state

        def finish_prefill(params, state, fresh, slot, ids, toks, start,
                           true_len, full=False):
            """Prefill tail, then the table-directed block scatter: fresh
            rows into pool blocks ``ids`` ([bucket/block]; duplicate trash
            entries write garbage over garbage). ``slot`` ([1]), ``ids``,
            ``start`` (0-d, or the int 0 of a monolithic admission) and
            ``true_len`` ([1]) are device tensors: the program reads no
            value on the host, so its graph serves every admission of the
            bucket.

            Rows of ``fresh`` past the chunks this admission wrote hold an
            earlier admission's rows and are never read: attention masks
            every row at or past ``true_len``, and the rows past the final
            chunk fall in blocks past the ``ceil(true_len / block)``
            covered ones, whose ids are the trash block (chunks are whole
            blocks); decode never reads a pool row at or past a slot's
            fill before writing it."""
            first, filled = self._run_prefill(
                params, fresh, toks, start, true_len, full=full
            )
            idx = ids.long()
            nb = idx.shape[0]
            for p_layer, f_layer in zip(state["pool"], filled):
                for pbuf, fbuf in zip(p_layer, f_layer):
                    pbuf[idx] = fbuf.reshape((nb, blk) + tuple(fbuf.shape[2:])).to(pbuf.dtype)
            state["fill"].index_copy_(0, slot, true_len.int())
            state["last_tok"].index_copy_(0, slot, first.reshape(1))
            state["done"].index_fill_(0, slot, False)
            state["first"].copy_(first)
            return state["first"]

        full_ok = cfg.prefill_impl == "flash"

        def prefill(params, state, slot, ids, tokens, true_len):
            return finish_prefill(
                params, state, init_fresh(bucket=tokens.shape[0]), slot, ids, tokens[None],
                0, true_len, full=full_ok,
            )

        def init_fresh(*, bucket):
            fresh = self._fresh.get(bucket)
            if fresh is None:
                fresh = self._fresh[bucket] = init_cache(self._cache_cfg, 1, bucket, device=dev)
            return fresh

        self._prefill = prefill
        self._prefill_final = finish_prefill
        self._init_fresh = init_fresh
        self._prefill_step = self._make_prefill_step()

        def decode_chunk(params, state, active, table):
            """``chunk_steps`` paged decode steps, in place. The block table
            is a per-chunk input (the host grows it between chunks);
            retired and dead slots' rows go to the trash block every step,
            so their writes never land in a block the allocator recycled."""
            fill, done = state["fill"], state["done"]
            for i in range(self.chunk_steps):
                live = active & ~done
                step_table = torch.where(live[:, None], table, 0)
                logits, _ = module(
                    params, state["last_tok"][:, None], cache=state["pool"],
                    cache_index=fill, block_table=step_table,
                )
                nxt = torch.where(live, sample(logits[:, -1], self._gen), pad_id)
                stop = live & (nxt == eos_id) if eos_id is not None else None
                advance = live & (fill + 1 < L)
                done |= live & ~advance
                if stop is not None:
                    done |= stop
                fill += advance.int()
                state["last_tok"].copy_(torch.where(live, nxt, state["last_tok"]))
                state["toks"][i].copy_(nxt)
            return state["toks"]

        self._decode_chunk = decode_chunk
        self._build_cache_programs()

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
                "cache": init_cache(self._cache_cfg, B, L, device=dev),
                "d_cache": init_cache(self._draft_cache_cfg, B, L, device=dev),
                "kv_mask": torch.zeros((B, L), dtype=torch.bool, device=dev),
                "fill": torch.zeros((B,), dtype=torch.int32, device=dev),
                "last_tok": torch.zeros((B,), dtype=torch.long, device=dev),
                "done": torch.ones((B,), dtype=torch.bool, device=dev),
                # each chunk's rounds: emission row, emitted and accepted counts
                "toks": torch.zeros((self.chunk_steps, B, k + 3), dtype=torch.long, device=dev),
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
            return (init_cache(self._cache_cfg, 1, bucket, device=dev), init_cache(self._draft_cache_cfg, 1, bucket, device=dev))

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
            """``chunk_steps`` speculative rounds, in place. Returns the
            state's int64 token buffer [R, B, k+3]: per round and slot the
            emission row (k+1 tokens), the emitted count (eos-truncated on
            the device) and the accepted draft count; the host truncates at
            the budget."""
            kv_mask, fill, done0 = state["kv_mask"], state["fill"], state["done"]
            for r in range(self.chunk_steps):
                live = active & ~done0
                fill0 = fill   # this round's start (updated in place last)
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
                done0.copy_(done | (live & (new_fill + k + 1 >= L)))
                kv_mask |= (rows_l >= fill0[:, None]) & (rows_l < new_fill[:, None])
                fill.copy_(new_fill)
                state["last_tok"].copy_(torch.where(live, correction, state["last_tok"]))
                state["toks"][r].copy_(torch.cat([
                    torch.where(live[:, None], emit, pad_id),
                    n_emit[:, None],
                    torch.where(live, accepted, 0)[:, None],
                ], dim=1))
            return state["toks"]

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
        self._refuse_on_follower("generate")
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
                    self._abandon(r)
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
        self._refuse_on_follower("generate_stream")
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
                self._abandon(req)


    def _canonical_row(self, prompt) -> np.ndarray:
        """The engine's canonical prompt row: int32, left-truncated to the
        user budget, system prefix prepended — ONE home shared by the
        generate paths and the KV export, so a disaggregated prefill engine
        and its decode peer (configured alike) key the same bytes under
        the same tokens."""
        row = np.asarray(prompt, dtype=np.int32).ravel()
        if row.size == 0:
            raise ValueError("empty prompt")
        row = row[-self._user_max:]
        if self._prefix_tokens is not None:
            row = np.concatenate([self._prefix_tokens, row])
        return row

    def prefill_export(
        self,
        params,
        prompt: Sequence[int],
        *,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> dict:
        """Prefill-only admission — the disaggregated serving prefill leg:
        run the prompt's prefill through the normal admission machinery,
        let the harvest store the prompt's full KV blocks in the host
        prefix store, and return a handle instead of streaming:

        ``{"tokens": [first_token], "prompt": [...canonical row...],
        "cached_tokens": N, "lease": PrefixLease, "rid": ..., "engine":
        ...}``

        ``lease`` pins the exported path until the decode leg has spliced
        it (release it exactly once; it is idempotent); ``cached_tokens``
        is how much of the prompt an engine sharing this store will splice.
        Blocks the byte budget could not store shrink the match — the
        decode leg recomputes the difference. Billed as a 1-token
        request. On a multi-rank engine every rank's host store holds the
        prompt's blocks of its own shard, and the lease's release reaches
        every rank through the next plan."""
        if self.prefix_cache is None:
            raise ValueError(
                "prefill_export needs a prefix cache — the harvested KV "
                "blocks land in its host block store for the decode leg to "
                "splice; construct the engine with prefix_cache=True (or a "
                "shared RadixPrefixCache)"
            )
        self.bind(params)
        self._refuse_on_follower("prefill_export")
        tenant = validate_tenant(tenant) if tenant is not None else current_tenant()
        priority = validate_priority(priority) if priority is not None else current_priority()
        if deadline_ms is None:
            deadline_ms = current_deadline_ms()
        row = self._canonical_row(prompt)
        req = _Request(prompt=row, max_new_tokens=1, tenant=tenant, priority=priority)
        req._kv_event = threading.Event()
        req._export = self._lockstep
        if deadline_ms is not None:
            req.deadline = req.submitted + deadline_ms / 1e3
        req.rid = self._tracer.new_request("prefill")
        try:
            self._gated_submit([req])
        except BaseException:
            self._tracer.finish_request(req.rid)  # no leak on rejection
            raise
        if not req.event.wait(self.submit_timeout):
            self._m_timeouts.inc()
            self._abandon(req)
            raise TimeoutError("prefill did not finish in time")
        if req.error is not None:
            raise req.error
        # the insert entry carrying the blocks is FIFO right behind the
        # prefill: wait for the lease release that marks it processed (a
        # timeout degrades to a shorter match, never an error)
        req._kv_event.wait(self.submit_timeout)
        if self._lockstep:
            # taken at that harvest on every rank (_process_entry)
            with self._lock:
                taken = self._export_leases.get(req._pid)
            # (an empty lease, not a lookup: a lookup here would stamp the
            # controller's store alone)
            lease = _PlanLease(self, req._pid, taken if taken is not None
                               else PrefixLease(self.prefix_cache, []))
        else:
            lease = self.prefix_cache.lease(row)
        return {
            "tokens": list(req.tokens),
            "prompt": [int(t) for t in row],
            "cached_tokens": int(lease.n_tokens),
            "lease": lease,
            "rid": req.rid,
            "engine": self.instance,
        }

    def kv_export(self, prompt: Sequence[int], *, wait_s: float = 0.25) -> List[dict]:
        """The host prefix-store entries covering ``prompt`` — the donor
        half of the cross-process KV handoff (``POST /debug/kv/export``).
        ``wait_s`` bounds a short poll for inserts still in flight;
        whatever is covered when it expires is exported. On a multi-rank
        engine the controller's next plan takes the lookup (so every
        rank's store stamps the same blocks at the same plan position) and
        the rows come back whole: every rank's kv heads put together in
        head order, as the reference's one store holds them."""
        cache = self.prefix_cache
        if cache is None:
            raise ValueError(
                "no prefix cache on this engine — KV export needs the host "
                "block store; construct with prefix_cache=True"
            )
        self._refuse_on_follower("kv_export")
        row = self._canonical_row(prompt)
        target = (len(row) // cache.block_size) * cache.block_size
        deadline = time.monotonic() + max(0.0, wait_s)
        while cache.peek(row) < target and time.monotonic() < deadline:
            time.sleep(0.005)
        if not self._lockstep:
            return cache.export_request(row)
        op = self._planned_kv("export", row)
        return self._whole_heads(op)

    def kv_import(self, entries: Sequence[dict]) -> int:
        """Attach a donor's exported entries to this engine's host prefix
        store (``POST /debug/kv/import``); returns blocks newly attached.
        Rows that are not packed host blocks (a numpy tree, another
        package's entries) are packed first. On a multi-rank engine the
        controller publishes the entries with its next plan and every rank
        attaches its own kv heads of each block at that plan position."""
        cache = self.prefix_cache
        if cache is None:
            raise ValueError(
                "no prefix cache on this engine — KV import needs the host "
                "block store; construct with prefix_cache=True"
            )
        self._refuse_on_follower("kv_import")
        packed = [
            entry if packed_base(entry["rows"]) is not None
            else {**entry, "rows": pack_rows(entry["rows"])}
            for entry in entries
        ]
        if not self._lockstep:
            return int(cache.import_blocks(packed))
        return int(self._planned_kv("import", packed).result)

    # ------------------------------------------------------------------ #
    # the host store's lookups and attaches on a multi-rank engine (C14)
    # ------------------------------------------------------------------ #

    def _planned_kv(self, kind: str, payload: Any) -> _KvOp:
        """Queue a host-store operation for the controller's next plan and
        wait until this rank applied it."""
        op = _KvOp(kind, payload)
        with self._lock:
            self._kv_ops.append(op)
        if not op.event.wait(self.submit_timeout):
            raise TimeoutError(f"kv_{kind} was not applied in time")
        if op.error is not None:
            raise op.error
        return op

    def _kv_head_index(self) -> List[List[int]]:
        """Per layer of a host block, the global kv head of each head this
        rank's store holds (the target's layers, then a draft's)."""
        from unionml_tpu_torch.models.layers import local_kv_index

        if self.draft is None:
            return [local_kv_index(self.cfg, self._params)] * self.cfg.num_layers
        target = local_kv_index(self.cfg, self._params["target"])
        draft = local_kv_index(self.draft.config, self._params["draft"])
        return [target] * self.cfg.num_layers + [draft] * self.draft.config.num_layers

    def _apply_kv(self, item: tuple) -> None:
        """One planned host-store operation on this rank: an export's
        lookup (a follower puts its rows, with their heads, for the
        controller), or an import of this rank's kv heads of each block."""
        kind, pid = item[0], item[1]
        op = self._kv_applying.pop(pid, None)   # the controller's waiter
        cache = self.prefix_cache
        try:
            if kind == "export":
                local = cache.export_request(np.asarray(item[2], np.int32))
                if op is None:
                    import torch.distributed as dist

                    self._channel.put(f"kv/{pid}/{dist.get_rank()}",
                                      (self._kv_head_index(), [e["rows"] for e in local]))
                else:
                    op.result = local
                return
            entries = op.payload if op is not None else \
                self._channel.read_shared(f"kv/{pid}", self._stop)
            if entries is None:
                return
            index = self._kv_head_index()

            def mine(rows):
                return pack_rows(tuple(
                    tuple(buf[:, :, heads] for buf in layer) for layer, heads in zip(rows, index)
                ))

            attached = cache.import_blocks([{**e, "rows": mine(e["rows"])} for e in entries])
            if op is not None:
                op.result = attached
        except BaseException as exc:
            if op is None:
                raise
            op.error = exc
        finally:
            if op is not None:
                op.event.set()

    def _whole_heads(self, op: _KvOp) -> List[dict]:
        """The controller's export entries with every rank's kv heads put
        together in head order (the first rank in rank order that holds a
        head gives it)."""
        parts = [(self._kv_head_index(), [e["rows"] for e in op.result])]
        for rank in self._channel.ranks[1:]:
            parts.append(self._channel.take(f"kv/{op.pid}/{rank}", self._stop,
                                            self.submit_timeout))
        out = []
        for i, entry in enumerate(op.result[:min(len(rows) for _, rows in parts)]):
            layers = []
            for li, layer in enumerate(entry["rows"]):
                heads = 1 + max(max(index[li]) for index, _ in parts)
                bufs = []
                for bi in range(len(layer)):
                    cols = []
                    for h in range(heads):
                        index, rows = next((ix, r) for ix, r in parts if h in ix[li])
                        cols.append(rows[i][li][bi][:, :, index[li].index(h)])
                    bufs.append(torch.stack(cols, dim=2))
                layers.append(tuple(bufs))
            out.append({**entry, "rows": pack_rows(tuple(layers))})
        return out

    def bind(self, params):
        """Set (or swap) the served weights (on the engine's device);
        state allocates lazily. Swapping while requests are in flight
        would mix weights within a decode — refused instead.

        A tree placed under tensor (or expert) parallelism is served on
        this rank's local shards (:func:`~unionml_tpu_torch.models.layers
        .localize_params`, once, here): the cache, the pool's blocks and
        their byte count hold the rank's kv heads. Over several ranks this
        sets the engine's :attr:`role`: the first of the tree's ranks is the
        controller, the others followers (see the class docstring and
        :meth:`follow`); every rank must bind its engines in the same
        order."""
        if params is self._params or params is self._params_src:
            return
        if self.draft is not None:
            if not (isinstance(params, Mapping) and "target" in params and "draft" in params):
                raise ValueError(
                    'a speculative engine binds a mapping {"target": params, '
                    '"draft": params} (the make_speculative_predictor artifact '
                    "contract)"
                )
        from unionml_tpu_torch.models.layers import localize_params
        from unionml_tpu_torch.models.llama import cache_config

        from unionml_tpu_torch.models.layers import LocalParams
        from unionml_tpu_torch.models.train import tree_leaves

        src = params
        draft_layout = self._draft_cache_cfg
        if self.draft is not None:
            params = {"target": localize_params(params["target"]),
                      "draft": localize_params(params["draft"])}
            layout = cache_config(self.cfg, params["target"])
            draft_layout = cache_config(self.draft.config, params["draft"])
            trees = params.values()
        else:
            params = localize_params(params)
            layout = cache_config(self.cfg, params)
            trees = [params]
        ranks = max((t.ranks for t in trees if isinstance(t, LocalParams)),
                    key=len, default=())
        lockstep = len(ranks) > 1
        if self._params is not None and (lockstep or self._lockstep):
            raise RuntimeError(
                "an engine served over several ranks keeps the tree it was "
                "bound to: close it on every rank and build another"
            )
        with self._lock:
            busy = (
                any(r is not None for r in self._occupant)
                or self._admitting > 0
                or not self._room.empty()
                or bool(self._staged)
                or not self._inflight.empty()
            )
            if self._params is not None and busy:
                raise RuntimeError(
                    "cannot swap engine params while requests are in "
                    "flight — drain the engine (or create a new one) first"
                )
            if self._params is not None and self.prefix_cache is not None:
                # stored blocks belong to the OLD weights (pin
                # registrations survive; the prefix re-pins on reinsert),
                # and the device splice memo goes with them
                self.prefix_cache.clear()
                self._dev_splice.clear()
            if self._params is not None:
                # every graph captured the old params
                self._graphs.drop()
            if (layout, draft_layout) != (self._cache_cfg, self._draft_cache_cfg):
                self._draft_cache_cfg = draft_layout
                self._adopt_layout(layout)
            self._params = params
            self._weight_dtypes = tuple(sorted({
                str(t.dtype) for t in tree_leaves(params) if isinstance(t, torch.Tensor)
            }))
            self._params_src = src
            if lockstep:
                import torch.distributed as dist

                self._controller_rank = ranks[0]
                self.role = "controller" if dist.get_rank() == ranks[0] else "follower"
                self._channel = _PlanChannel(ranks)
            self._lockstep = lockstep

    def _adopt_layout(self, layout) -> None:
        """Caches and pool blocks from now on hold ``layout``'s kv heads
        (a placed tree's local ones): the idle engine drops its device
        state, and a pool sized by bytes is re-counted in blocks of the
        new size. Called with the lock held."""
        self._cache_cfg = layout
        self._state = None
        self._fresh.clear()
        self._graphs.drop()
        self._dev_splice.clear()
        if self.kv_pool is not None:
            pool = self.kv_pool
            nbytes = self._kv_block_nbytes(pool.block_size)
            blocks = pool.num_blocks
            if self._pool_bytes_arg is not None:
                blocks = max(2, int(self._pool_bytes_arg) // nbytes)
            pool.resize(num_blocks=blocks, block_nbytes=nbytes)

    def warmup(self, params) -> int:
        """Run one request per bucket (2 tokens: a 1-token request would
        finish at prefill and never run a decode chunk), so a live request
        never pays first-use costs (kernel builds, allocator growth) — with
        a prefix cache also that bucket's cached admission (a full hit,
        and a partial hit where the bucket has room). Returns the number
        of cold-path programs; the cache is left empty."""
        self.bind(params)
        n = min(2, self.max_new_tokens)
        for b in self.buckets:
            if self.prefix_cache is not None:
                # each bucket must MISS first (the warmup prompts share
                # prefixes across buckets)
                self.prefix_cache.clear()
            ones = np.ones(b - self.prefix_len, np.int32)
            self.generate(params, [ones], max_new_tokens=n)
            if self.prefix_cache is not None:
                blk = self.prefix_cache.block_size
                self.generate(params, [ones], max_new_tokens=n)   # full hit
                if b >= 3 * blk:
                    # partial hit: >= 1 matched block, >= 2 uncovered
                    part = ones.copy()
                    part[-2 * blk:] = 2
                    self.generate(params, [part], max_new_tokens=n)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
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
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.kv_pool is not None:
            out["kv_pool"] = self.kv_pool.stats()
        if self._usage is not None:
            # the compact per-tenant view (GET /debug/usage has the
            # full per-tenant resource vectors)
            out["usage"] = self._usage.stats()
        if self._programs is not None:
            # per device program: calls and host time
            out["programs"] = self._programs.stats()
        graphs = self._graphs.stats()
        if graphs:
            # the captured programs: graphs, capture ms, replays
            out["graphs"] = graphs
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
        if self.prefix_cache is not None:
            self.prefix_cache.reset_stats()
        if self.kv_pool is not None:
            self.kv_pool.reset_stats()
        if self._usage is not None:
            self._usage.reset_stats()
        if self._programs is not None:
            self._programs.reset()
        self._sched.reset_stats()

    def close(self):
        if self.role == "controller" and not self._closing:
            # the dispatcher finishes its pass (its collectives pair the
            # followers'), then the followers are told to stop
            self._closing = True
            self._worker.join(timeout=60.0)
            self._channel.publish({"stop": True})
        self._closing = True
        self._stop.set()
        self._followed.set()
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
        # the in-flight pipeline the harvester no longer owns: stranded
        # insert entries still hold lease refcounts (leaking them would pin
        # blocks in a user-supplied cache forever), and a stranded preempt
        # entry holds a request no queue or slot can see
        while True:
            try:
                entry = self._inflight.get_nowait()
            except queue.Empty:
                break
            self._inflight.task_done()
            if entry[0] == "insert":
                self._release_lease(entry[2])
            elif entry[0] == "preempt":
                self._fail_orphan(entry[2], RuntimeError("decode engine closed"))
        with self._lock:
            staged, self._staged = self._staged, []
            leases, self._export_leases = list(self._export_leases.values()), {}
        for lease in leases:
            lease.release()
        for req in [*self._room.pop_all(), *staged]:
            req.error = RuntimeError("decode engine closed")
            self._release_lease(req)   # a resumed-queued stream's pin
            self._tracer.finish_request(req.rid)
            req.event.set()
            req.finish_stream()
        for req in self._occupant:
            if req is not None:
                req.error = RuntimeError("decode engine closed")
                self._tracer.finish_request(req.rid)
                self._release_lease(req)
                req.event.set()
                req.finish_stream()
        self._occupant = [None] * self.slots
        self._m_slots_busy.set(0)
        # the device buffers (the KV cache or pool, the splice memo) and
        # the bound weights go with the engine: a closed engine holds no
        # card memory, so an autoscaler's scale-in hands its pool back and
        # a reaped or rolled-back canary its version's weights
        with self._lock:
            self._state = None
            self._params = self._params_src = None
            self._dev_splice.clear()
            self._fresh.clear()
            # every graph and the pool they share
            self._graphs.close()


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
        if req._preempted_at:
            # a resumed stream: its queue wait already landed; record the
            # evict→re-admit gap as its own span
            self._tracer.record_span(
                req.rid, f"resume-wait[{req._preempts - 1}]", req._preempted_at, t0,
            )
        else:
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
        if self.paged:
            first = self._run_program(
                "engine.prefill", (bucket,), self._prefill, (self._params, st),
                (np.array([slot]), ids, padded.astype(np.int64),
                 np.array([len(req.prompt)])),
                sig=(bucket,),
            )
        else:
            toks = _upload(padded, self.device).long()
            first = self._prefill(self._params, st, slot, toks, len(req.prompt))
        readback = _Readback(first)
        if self._usage is not None:
            req._attr_flops += self._program_cost("engine.prefill", (bucket,))
        with self._lock:
            if self._epoch != ep0:
                # _recover ran (harvester thread) while this prefill was
                # being dispatched: fail this request with the poisoned
                # batch (self._state stays the recovery's None)
                self._forget_state(st)
                raise RuntimeError(
                    "engine recovered while this admission's prefill "
                    "was in flight; the request failed with the "
                    "poisoned batch"
                )
            self._state = st
            self._occupant[slot] = req
            self._slot_gen[slot] += 1
            # resumed streams already hold harvested tokens
            req._expected = len(req.tokens) + 1
            self._m_slots_busy.set(self._slots_in_use_locked())
        req.admission_ms = (time.perf_counter() - req._dispatch_t) * 1e3
        self._flight_rec(
            "prefill", rid=req.rid, tenant=req.tenant, slot=slot,
            bucket=bucket, tokens=req._prefilled_tokens,
            cached_tokens=req._saved_tokens,
        )
        self._inflight.put(("prefill", ep0, slot, req, readback))
        self._schedule_insert(req, st, slot, ids, ep0)

    def _device_splice_rows(self, blocks):
        """Device copies of one splice unit (a tuple of cached host block
        trees), LRU-memoized on the blocks' identity: a hot prefix — the
        pinned ``system_prefix`` above all — uploads host→device once.
        Each entry keeps the host tuples alive, so an ``id()`` key is never
        recycled while its entry lives. Dispatcher thread only."""
        key = tuple(id(b) for b in blocks)
        hit = self._dev_splice.get(key)
        if hit is not None:
            self._dev_splice.move_to_end(key)
            return hit[1]
        dev = [_upload_rows(b, self.device) for b in blocks]
        self._dev_splice[key] = (blocks, dev)
        while len(self._dev_splice) > self._dev_splice_cap:
            self._dev_splice.popitem(last=False)
        return dev

    def _schedule_insert(self, req: _Request, st, slot: int, ids, epoch: int) -> None:
        """Dispatcher, right after a prefill dispatch: the prompt's full
        blocks past the matched ones on their way to the host
        (:class:`_HostBlocks`, enqueued behind the prefill's writes on the
        same stream), and the tree insert queued behind the in-flight
        readbacks — the harvester waits on the copy's event and attaches
        them. ``ids`` is the admission's own scatter id vector (paged), not
        the table row, which a retirement on the harvester may already have
        cleared. The entry always carries the request, so its lease is
        released only after the insert could build on live ancestors."""
        cache = self.prefix_cache
        if cache is None:
            return
        nb = len(req.prompt) // cache.block_size
        first_new = min(req._matched_blocks, nb)
        inserted = None   # nothing new to store: a release-only entry
        if first_new < nb and st is not None:
            inserted = first_new, self._extract_blocks(st, slot, ids, first_new, nb)
        self._inflight.put(("insert", epoch, req, inserted))

    def _release_lease(self, req: _Request) -> None:
        """Unpin the request's matched blocks AND any resume pin
        (idempotent: error paths and the insert path may both get here),
        and wake a ``prefill_export`` waiter."""
        lease, req._lease = req._lease, None
        if lease is not None:
            lease.release()
        self._release_resume_lease(req)
        if req._kv_event is not None:
            req._kv_event.set()

    def _release_resume_lease(self, req: _Request) -> None:
        """Drop the pin holding a preempted stream's saved blocks — once
        the resume admission holds its own lease over the same path, or on
        any terminal path (idempotent)."""
        lease, req._resume_lease = req._resume_lease, None
        if lease is not None:
            lease.release()

    def _fail_orphan(self, req: _Request, exc: BaseException) -> None:
        """Fail a request stranded between its preemption and its
        requeue: it lives only in the in-flight pipeline there, so recovery
        and close reach it through the preempt entry alone. Its pool blocks
        were released at eviction."""
        with self._lock:
            if req.event.is_set():
                return
            req.error = exc
        self._release_lease(req)
        self._m_errors.inc()
        if self._usage is not None:
            self._usage.record_drop(req.tenant, "error")
        self._flight_rec("drop", rid=req.rid, tenant=req.tenant,
                         cause=f"error:{type(exc).__name__}")
        self._tracer.finish_request(req.rid)
        req.event.set()
        req.finish_stream()

    # ------------------------------------------------------------------ #
    # usage metering helpers (no-ops when usage=None)
    # ------------------------------------------------------------------ #

    def _program_cost(self, key: str, sig=None) -> float:
        """FLOPs of one dispatch of a tracked program (0 with
        ``introspect=False``)."""
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
                        cached_tokens=req._saved_tokens,
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
            # poisoned-era readback: _recover already failed its requests.
            # An insert entry still releases its lease, and a preempt entry
            # must FAIL its evicted stream (recovery could not see it)
            if entry[0] == "insert":
                self._release_lease(entry[2])
            elif entry[0] == "preempt":
                self._fail_orphan(entry[2], RuntimeError(
                    "engine recovered while this stream was preempted; its "
                    "evicted device state belonged to the poisoned era"
                ))
            return
        self._fire("engine.harvest")
        if entry[0] == "insert":
            # the prompt's new blocks into the radix tree once their copy
            # to the host has landed. A failed insert never fails the
            # request (its own prefill readback came first)
            _, _, req, inserted = entry
            try:
                if inserted is not None:
                    first_new, host = inserted
                    self.prefix_cache.insert(req.prompt, first_new, host.wait())
            except Exception as exc:
                logger.info(f"prefix-cache insert skipped: {exc!r}")
            finally:
                if req._export:
                    # a multi-rank export's pin, taken at this harvest on
                    # every rank; the plan releases it
                    lease = self.prefix_cache.lease(req.prompt)
                    with self._lock:
                        self._export_leases[req._pid] = lease
                self._release_lease(req)
            return
        if entry[0] == "preempt":
            # a preempted stream's saved blocks land in the host store, the
            # path is pinned against LRU, and the stream re-enters the
            # waiting room at the FRONT of its queue; FIFO entry order puts
            # the insert before its re-admission can match
            _, _, req, nb, saved, resume_prompt, incl = entry
            cache = self.prefix_cache
            try:
                if saved is not None:
                    cache.insert(resume_prompt, 0, saved.wait())
            except Exception as exc:
                # the resume admission simply matches fewer blocks
                logger.info(f"preempt KV save skipped: {exc!r}")
            self._release_resume_lease(req)   # a prior preemption's
            req._resume_lease = cache.lease(resume_prompt)
            req.prompt = resume_prompt
            req._prompt_incl = incl
            req._matched_blocks = 0
            req._park_logged = False
            self._flight_rec(
                "resume", rid=req.rid, tenant=req.tenant, priority=req.priority,
                tokens=len(req.tokens), cached_blocks=int(nb),
            )
            self._room.put(req, front=True)
            self._g_queue_depth.set(self._room.qsize())
            return
        if entry[0] == "prefill":
            _, _, slot, req, readback = entry
            tok = int(readback.wait()[()])
            now = time.perf_counter()  # after the readback: prefill_ms
            with self._lock:           # includes its in-flight lag
                req.prefill_ms = (now - req._dispatch_t) * 1e3
                if req.ttft_ms == 0.0:
                    # a RESUMED stream keeps its first segment's ttft
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
            toks = self._run_program(
                "engine.decode", (self.slots, self.chunk_steps), self._decode_chunk,
                (self._params, st), (mask,) if table_np is None else (mask, table_np),
            )
            # enqueued on the program's stream right behind it: the next
            # chunk cannot overwrite the token buffer before it is copied
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
                self._forget_state(st)
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
        self._release_lease(req)
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

    # ------------------------------------------------------------------ #
    # preemption
    # ------------------------------------------------------------------ #

    def _eligible_victims_locked(self) -> List:
        """Residents the scheduler may evict (lock held): prefill harvested
        (a token-exact resume point), waiter still listening, and the
        resume prompt — prompt plus every harvested token — still fits an
        admission bucket."""
        out = []
        for slot, r in enumerate(self._occupant):
            if r is None or r.abandoned or not r.tokens:
                continue
            if len(r.prompt) + len(r.tokens) - r._prompt_incl > self.buckets[-1]:
                continue
            out.append((slot, r))
        return out

    def _maybe_preempt(self, waiter: _Request) -> bool:
        """A parked (pool-exhausted) admission asks the scheduler to act:
        evict at most ONE strictly-lower-priority resident per dispatcher
        pass. Returns True when a victim was evicted."""
        if not self._preempt_enabled:
            return False
        with self._lock:
            # anti-cascade: blocks already on the deferred fence land once
            # the in-flight chunks harvest — if they cover the waiter, a
            # further eviction would thrash a second victim
            pending = sum(len(ids) for _, ids in self._deferred_free)
            needed = self.kv_pool.blocks_for_rows(min(
                len(waiter.prompt) + waiter.max_new_tokens - len(waiter.tokens),
                self.cache_len,
            ))
            if self.kv_pool.available + pending >= needed:
                return False
            victim = self._sched.select_victim(waiter, self._eligible_victims_locked())
        if victim is None:
            return False
        return self._preempt_victim(victim[0], victim[1], waiter)

    def _preempt_victim(self, slot: int, victim: _Request, waiter: _Request) -> bool:
        """Evict ``victim`` from its slot so ``waiter`` can admit
        (dispatcher thread): its full blocks whose every row is covered by
        harvested tokens go to the host (the extract path, enqueued behind
        every chunk already dispatched), the slot retires with fenced
        block frees, and the harvester's ``preempt`` entry stores the
        blocks and requeues the stream at the front of its queue. The
        resume admission splices the same bytes back."""
        t0 = time.perf_counter()
        blk = self._kv_block_size
        with self._lock:
            if self._occupant[slot] is not victim or self._state is None:
                return False
            ep0 = self._epoch
            st = self._state
            # rows past prompt + tokens[:-1] may still be written by chunks
            # in flight: only FULL blocks below them are saved (a resumed
            # victim's prompt already holds its first _prompt_incl tokens)
            nb = min(
                (len(victim.prompt) + len(victim.tokens) - victim._prompt_incl - 1) // blk,
                self._slot_covered[slot],
            )
            ids = self._table[slot, :nb].copy()
        saved = self._extract_blocks(st, slot, ids, 0, nb) if nb > 0 else None
        with self._lock:
            if self._epoch != ep0 or self._occupant[slot] is not victim:
                return False  # recovery or retirement raced: nothing evicted
            if len(victim.prompt) + len(victim.tokens) - victim._prompt_incl > self.buckets[-1]:
                # tokens harvested since the eligibility check pushed the
                # resume prompt past the largest bucket: leave it resident
                return False
            # tokens of chunks already in flight for this slot are
            # discarded at harvest (recomputed after resume)
            self._slot_gen[slot] += 1
            self._occupant[slot] = None
            victim._preempts += 1
            victim._preempted_at = time.perf_counter()
            # the evict→resume gap is queueing, not decode cadence
            victim._itl_anchor = 0.0
            resume_prompt = np.concatenate([
                victim.prompt, np.asarray(victim.tokens[victim._prompt_incl:], np.int32),
            ])
            incl = len(victim.tokens)
            freed = len(victim._block_ids)
            self._release_blocks_locked(victim, slot)
            self.kv_pool.note_preempted(freed)
            self._m_slots_busy.set(self._slots_in_use_locked())
        self._sched.record_preemption("priority")
        self._flight_rec(
            "preempt", rid=victim.rid, tenant=victim.tenant, priority=victim.priority,
            slot=slot, by=waiter.rid, by_priority=waiter.priority, blocks_saved=int(nb),
            blocks_freed=freed, tokens=len(victim.tokens),
        )
        self._tracer.record_span(
            victim.rid, f"preempt[{victim._preempts - 1}]", t0, time.perf_counter(),
            tokens=len(victim.tokens),
        )
        self._inflight.put(("preempt", ep0, victim, nb, saved, resume_prompt, incl))
        return True

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
            if (req._shed if self._lockstep else
                    req.deadline is not None and time.perf_counter() > req.deadline):
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
            cache, m_used = self.prefix_cache, 0
            bucket = self._bucket_for(len(req.prompt))
            chunk = self.prefill_chunk
            # cached-admission granularity: the cache block for
            # monolithic-class buckets, lcm(block, prefill_chunk) for
            # chunked ones (a cached long prompt never degrades its suffix
            # to block-sized programs)
            unit = None
            if cache is not None:
                unit = cache.block_size
                if chunk is not None and bucket > chunk:
                    unit = math.lcm(unit, chunk)
                lease = cache.match(req.prompt)
                req._lease = lease
                req._matched_blocks = lease.n_blocks
                # the resume pin's job is done: the match lease covers it
                self._release_resume_lease(req)
                blk = cache.block_size
                # usable match: unit-quantized, and one token short of the
                # prompt — the final chunk must run the last real token to
                # sample token 0 from it
                m_used = (
                    min(lease.n_blocks, (len(req.prompt) - 1) // blk) * blk // unit * unit
                )
            # credited to the tokens-saved counter when the admission
            # completes: a dropped one saved nothing
            req._saved_tokens = m_used
            req._prefilled_tokens = len(req.prompt) - m_used
            if m_used == 0 and (chunk is None or bucket <= chunk):
                self._admit(req)
                with self._lock:
                    self._admitting -= 1
                return
            slot, bucket, padded = self._admission_preamble(req)
            # only the chunks covering the TRUE length run (and of a
            # cached admission only the uncovered suffix)
            chunk_use = unit if m_used else chunk
            if m_used:
                # matched blocks grouped into unit-sized splice entries
                g = unit // cache.block_size
                splice_rows = [
                    tuple(req._lease.rows[u * g:(u + 1) * g]) for u in range(m_used // unit)
                ]
            else:
                splice_rows = []
            n_chunks = -(-len(req.prompt) // chunk_use)
            pool_ids = None
            if self.paged:
                with self._lock:
                    pool_ids = self._take_covered_locked(req, slot, bucket)
            adm = _Admission(
                req=req, slot=slot, bucket=bucket, chunk=chunk_use,
                n_chunks=n_chunks, padded=padded,
                fresh=self._init_fresh(bucket=bucket), pool_ids=pool_ids,
                next_chunk=m_used // chunk_use, splice_rows=splice_rows,
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
            if adm.next_splice < len(adm.splice_rows):
                # a cached unit: its device copies (memoized upload)
                # spliced into the fresh cache in place of the prefill
                # program that would have recomputed them
                i = adm.next_splice
                t0 = time.perf_counter()
                rows = self._device_splice_rows(adm.splice_rows[i])
                adm.fresh = self._splice_block(adm.fresh, rows, i * adm.chunk)
                adm.next_splice += 1
                self._tracer.record_span(
                    req.rid, f"prefix-splice[{i}]", t0, time.perf_counter(),
                    tokens=adm.chunk,
                )
                return
            start = adm.next_chunk * adm.chunk
            host_toks = adm.padded[None, start: start + adm.chunk].astype(np.int64)
            if self.paged:
                # device inputs: one graph per bucket serves every offset
                toks, host_start = None, np.array(start, np.int64)
            else:
                toks = _upload(host_toks, self.device)
            sig = tuple(host_toks.shape)
            if adm.next_chunk < adm.n_chunks - 1:
                t0 = time.perf_counter()
                if self.paged:
                    adm.fresh = self._run_program(
                        "engine.prefill_chunk", (adm.bucket, adm.chunk), self._prefill_step,
                        (self._params, adm.fresh), (host_toks, host_start), sig=sig,
                    )
                else:
                    adm.fresh = self._prefill_step(self._params, adm.fresh, toks, start)
                if self._usage is not None:
                    req._attr_flops += self._program_cost("engine.prefill_chunk", sig)
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
                first = self._run_program(
                    "engine.prefill_final", (adm.bucket, adm.chunk), self._prefill_final,
                    (self._params, st, adm.fresh),
                    (np.array([adm.slot]), adm.pool_ids, host_toks, host_start,
                     np.array([len(req.prompt)])),
                    sig=sig,
                )
            else:
                first = self._prefill_final(
                    self._params, st, adm.fresh, adm.slot, toks, start,
                    len(req.prompt),
                )
            readback = _Readback(first)
            if self._usage is not None:
                req._attr_flops += self._program_cost("engine.prefill_final", sig)
            with self._lock:
                if self._admission is not adm or self._epoch != ep0:
                    # raced with _recover/close mid-dispatch: the request
                    # was already failed
                    self._forget_state(st)
                    return
                self._state = st
                self._admission = None
                self._occupant[adm.slot] = req
                self._slot_gen[adm.slot] += 1
                req._expected = len(req.tokens) + 1
                self._admitting -= 1
                self._m_slots_busy.set(self._slots_in_use_locked())
            # admission segment: dispatch start → final chunk enqueued
            # (every interleaved lead chunk and splice included)
            req.admission_ms = (time.perf_counter() - req._dispatch_t) * 1e3
            self._flight_rec(
                "prefill", rid=req.rid, tenant=req.tenant, slot=adm.slot,
                bucket=adm.bucket, tokens=req._prefilled_tokens,
                cached_tokens=req._saved_tokens, chunks=adm.n_chunks,
            )
            self._inflight.put(("prefill", ep0, adm.slot, req, readback))
            self._schedule_insert(req, st, adm.slot, adm.pool_ids, ep0)
            if self.prefix_cache is not None and req._saved_tokens:
                # the admission completed on spliced rows: NOW the skipped
                # prefill work is real
                self.prefix_cache.record_saved_tokens(req._saved_tokens)
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
            # splices are copies of stored rows and never charge the budget
            was_splice = adm.next_splice < len(adm.splice_rows)
            self._advance_admission(adm)
            if not was_splice:
                remaining -= adm.chunk
                if remaining <= 0:
                    break

    def _run(self):
        """Dispatcher: admit queued requests into free slots and keep up
        to ``pipeline_depth`` decode chunks in flight. NEVER waits for the
        device — the harvester thread owns the readbacks."""
        with torch.inference_mode():
            while not (self._stop.is_set() or self._closing):
                try:
                    with nan_scope():   # a NaN guard entered on any thread
                        progressed = self._run_pass()
                    if not progressed:
                        # nothing admittable or dispatchable: arrivals and
                        # harvest-freed slots are picked up next pass
                        if self._perf is not None:
                            self._perf.note_idle()
                        time.sleep(0.002)
                except BaseException as exc:  # pragma: no cover - engine crash
                    self._recover(exc)

    def _drain_pipeline(self) -> None:
        """Wait until the harvester has processed every in-flight entry
        (readbacks, retirements, prefix-cache inserts). On a multi-rank
        engine every decision the dispatcher takes then rests on state
        that is the same on every rank (the plan carries the decisions
        that read a clock or a caller), so the ranks' forwards issue their
        collectives in one order. Kept rather than planned: the harvest's
        effects (retirements, freed blocks, prefix inserts, preemption
        saves) feed admission, pool and splice decisions everywhere, and
        shipping them all would rebuild the harvester in the plan."""
        q = self._inflight
        with q.all_tasks_done:
            while q.unfinished_tasks and not self._stop.is_set():
                q.all_tasks_done.wait(0.1)

    def _refuse_on_follower(self, what: str) -> None:
        if self.role == "follower":
            raise RuntimeError(
                f"{what} on a follower rank of an engine served over several "
                f"ranks: rank {self._controller_rank}, the controller, takes "
                "every request; this rank runs follow()"
            )

    def _abandon(self, req: _Request) -> None:
        """A waiter gave up on ``req``. On a multi-rank engine the next
        plan abandons it on every rank at the same pass."""
        if self._lockstep:
            req._cancelled = True
        else:
            req.abandoned = True

    def follow(self, params) -> int:
        """Serve ``params`` (this rank's placed tree) as a follower of the
        engine's controller; returns once the controller's engine has
        closed (then :meth:`close` this one), with the plans applied. Every
        rank of the tree but the controller calls it, while the controller
        serves requests (:meth:`generate`, a ``ServingApp``...); a follower
        applies the plans from its :meth:`bind` on, so where it serves
        several engines it binds them all first, in the controller's
        order. Raises ``ValueError`` on the controller or where the tree is
        not served over several ranks."""
        self.bind(params)
        if self.role != "follower":
            raise ValueError(
                f"follow() on the {self.role} engine: only the ranks other "
                "than the first of a tree placed over several ranks follow"
            )
        self._followed.wait()
        return self._channel.seq

    def _take_plan(self) -> bool:
        """A multi-rank engine's plan for this dispatcher pass: built and
        published by the controller, read by a follower, then applied
        alike on both. False (and no pass) when the controller is idle
        with nothing to say, or a follower is stopping."""
        if self.role == "follower":
            plan = self._channel.receive(self._stop)
            if plan is None or plan.get("stop"):
                self._stop.set()
                self._followed.set()
                return False
            arrivals = self._follower_requests(plan["arrivals"])
        else:
            built = self._build_plan()
            if built is None:
                return False
            plan, arrivals = built
            self._channel.publish(plan)
        self._apply_plan(plan, arrivals)
        return True

    def _build_plan(self):
        """Controller: this pass's decisions — the arrivals since the last
        plan, cancellations, deadlines expired on this rank's clock, the
        export leases released, the host-store exports and imports callers
        asked for — or ``None`` when there is nothing to say and no work in
        hand (work in hand is the same on every rank after the drain, so a
        follower has none either)."""
        now = time.perf_counter()
        with self._lock:
            arrivals, self._staged = self._staged, []
            releases, self._releases = self._releases, []
            kv_ops, self._kv_ops = self._kv_ops, []
            busy = (
                any(r is not None for r in self._occupant)
                or self._admission is not None
                or not self._room.empty()
                or self._room.parked_count() > 0
            )
            live = [r for r in self._planned.values() if not r.event.is_set()]
        for req in arrivals:
            req._pid = next(self._plan_ids)
        reqs = live + arrivals
        cancel = [r._pid for r in reqs if r._cancelled and not r.abandoned]
        shed = [r._pid for r in reqs
                if r.deadline is not None and not r._shed and now > r.deadline]
        if not (arrivals or releases or cancel or shed or busy or kv_ops):
            return None
        kv = []
        for op in kv_ops:
            op.pid = next(self._kv_ids)
            self._kv_applying[op.pid] = op
            if op.kind == "export":
                kv.append(("export", op.pid, op.payload.tolist()))
            else:   # the blocks go under a key of their own, beside the plan
                self._channel.put(f"kv/{op.pid}", op.payload)
                kv.append(("import", op.pid))
        plan = {
            "arrivals": [(r._pid, r.prompt.tolist(), r.max_new_tokens, r.tenant,
                          r.priority, r.submitted, r._export) for r in arrivals],
            "cancel": cancel, "shed": shed, "release": releases,
            # usage-fed fair weights read this rank's clock: every rank
            # uses the controller's for the pass
            "weights": self._room.fair_weights({r.tenant for r in arrivals}),
            "kv": kv,
        }
        return plan, arrivals

    def _follower_requests(self, arrivals) -> List[_Request]:
        """A follower's own requests for a plan's arrivals, in its order."""
        out = []
        for pid, prompt, n, tenant, priority, submitted, export in arrivals:
            req = _Request(prompt=np.asarray(prompt, np.int32), max_new_tokens=n,
                           submitted=submitted, tenant=tenant, priority=priority)
            req._pid, req._export = pid, export
            req.rid = self._tracer.new_request("follow")
            out.append(req)
        return out

    def _apply_plan(self, plan: dict, arrivals: List[_Request]) -> None:
        """The plan on this rank, in its order: arrivals into the waiting
        room, cancellations and deadline verdicts on the planned requests,
        export leases released, the pass's fair weights held, then the
        host-store exports and imports (:meth:`_apply_kv`)."""
        released = []
        with self._lock:
            for pid in [p for p, r in self._planned.items() if r.event.is_set()]:
                del self._planned[pid]
            for req in arrivals:
                self._planned[req._pid] = req
            for pid in plan["cancel"]:
                if pid in self._planned:
                    self._planned[pid].abandoned = True
            for pid in plan["shed"]:
                if pid in self._planned:
                    self._planned[pid]._shed = True
            for pid in plan["release"]:
                released.append(self._export_leases.pop(pid, None))
            self._room.hold_weights(plan["weights"])
            for req in arrivals:
                self._room.put(req)
        for lease in released:
            if lease is not None:
                lease.release()
        for item in plan["kv"]:
            self._apply_kv(item)
        self._g_queue_depth.set(self._room.qsize())

    def _run_pass(self) -> bool:
        """One dispatcher pass; returns whether it made progress."""
        if self._lockstep:
            self._drain_pipeline()
            if not self._take_plan():
                return False
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
                    # pool exhausted: EVICTING a strictly lower-priority
                    # resident is progress; else retry once retirements
                    # free blocks
                    progressed = self._maybe_preempt(req)
                    # a strictly-higher-priority request may admit past
                    # the parked head (it may itself park, and preempt on
                    # its own behalf)
                    breq = self._pop_bypass(req)
                    if breq is not None:
                        self._start_admission(breq)
                        if self._room.is_parked(breq):
                            progressed = self._maybe_preempt(breq) or progressed
                        else:
                            progressed = True
                else:
                    progressed = True
        if self._lockstep:
            self._drain_pipeline()
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
                with nan_scope():
                    self._process_entry(entry)
            except BaseException as exc:  # pragma: no cover - engine crash
                self._recover(exc)
            finally:
                if entry[0] == "chunk":
                    self._chunk_credits.release()
                self._inflight.task_done()

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
                    self._release_lease(req)
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
            # drop and recapture: the graphs captured on the dropped state
            # go with it; the next admission's fresh state captures anew
            old, self._state = self._state, None
            self._forget_state(old)
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
