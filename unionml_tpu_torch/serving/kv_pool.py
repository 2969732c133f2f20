"""Block-paged device KV pool: the host-side free-list allocator.

The contiguous engine reserves ``cache_len`` rows of device KV per slot
— a short prompt routed into a long bucket strands the bucket's full
padding in HBM, and the slot count (the effective batch size) is capped
by the WORST-case sequence, not the traffic actually served. The paged
layout (PagedAttention lineage — Kwon et al., SOSP 2023) breaks that
coupling: device KV lives in one global pool of fixed-size blocks
(``block_size`` tokens each, per layer ``[num_blocks, block_size,
kv_heads, head_dim]``), each resident slot holds an int32 **block
table** mapping its logical rows to pool blocks, and a sequence's table
grows one block at a time as decode proceeds — so HBM is charged for
tokens actually materialized, not for bucket padding.

This module is the host half: a thread-compatible free-list allocator
(callers synchronize — the engine serializes access under its own lock,
matching the dispatcher/harvester split) with **reservation** semantics:
admission reserves a request's worst-case block count up front
(``ceil((prompt + max_new_tokens) / block_size)``), so mid-decode table
growth can never fail — pool exhaustion surfaces at ADMISSION (a typed
:class:`PoolExhausted` the engine maps to a clean ``Overloaded``/parked
admission), never as a corrupted decode. Block id **0 is the trash
block**: never allocated, it is where the engine routes writes from
retired/overshooting slots, so a recycled block can never be corrupted
by a dead slot's in-flight program.

The device half lives in :class:`~unionml_tpu_torch.serving.engine
.DecodeEngine` (pool state + table-directed scatter/gather programs)
and :mod:`unionml_tpu_torch.ops.paged_attention` (the decode kernel). The
prefix cache (:mod:`unionml_tpu_torch.serving.prefix_cache`) shares the same
``block_size``, so host-store splice and harvest extract are per-block
copies addressed by table entries.

Telemetry (``unionml_kv_pool_*``, per-instance ``pool`` label):

- ``unionml_kv_pool_blocks`` / ``_blocks_in_use`` / ``_blocks_reserved``
  — capacity and live allocation gauges,
- ``unionml_kv_pool_bytes`` — device bytes held by in-use blocks,
- ``unionml_kv_pool_occupancy_ratio`` — (in_use + reserved) / capacity,
- ``unionml_kv_pool_fragmentation_ratio`` — 1 - used rows / (in-use
  blocks x block_size): the internal fragmentation of partially-filled
  tail blocks,
- ``unionml_kv_pool_allocated_blocks_total`` /
  ``_freed_blocks_total`` — flow counters,
- ``unionml_kv_pool_alloc_failures_total`` — reservations refused for
  lack of blocks (the pool-full pressure signal the flight recorder
  pairs with its ``pool_pressure`` events),
- ``unionml_kv_pool_preempted_blocks_total`` — blocks released by
  scheduler preemption (docs/robustness.md "Preemption & fairness"):
  a resident's KV evicted to the host prefix-cache store so a
  higher-priority waiter could admit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from unionml_tpu_torch import telemetry

__all__ = ["KVBlockPool", "PoolExhausted", "TRASH_BLOCK"]

# block id 0: never allocated; dead/overshooting slots' writes land here
TRASH_BLOCK = 0


class PoolExhausted(Exception):
    """A reservation could not be satisfied: the pool has fewer
    unreserved free blocks than requested. Raised at ADMISSION time
    (reservations make later table growth infallible); the engine maps
    it to a parked admission or a typed ``Overloaded`` reject."""

    def __init__(self, msg: str, *, needed: int = 0, available: int = 0):
        super().__init__(msg)
        self.needed = needed
        self.available = available


class KVBlockPool:
    """Free-list allocator over ``num_blocks`` device KV blocks.

    Args:
        num_blocks: total pool blocks INCLUDING the reserved trash
            block 0 (``capacity == num_blocks - 1`` allocatable) — the
            same count the device pool arrays are built with.
        block_size: tokens per block (shared with the prefix cache).
        block_nbytes: device bytes of one block across every layer and
            buffer — sizes the ``unionml_kv_pool_bytes`` gauge; 0 keeps
            the gauge at 0 (tests without a device pool).
        registry: explicit :class:`~unionml_tpu_torch.telemetry
            .MetricsRegistry`; defaults to the process-global one.

    Not internally locked: the engine owns the synchronization (every
    call site holds the engine lock).
    """

    def __init__(
        self,
        *,
        num_blocks: int,
        block_size: int,
        block_nbytes: int = 0,
        registry: Optional[telemetry.MetricsRegistry] = None,
    ):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the trash block), "
                f"got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.block_nbytes = int(block_nbytes)
        # LIFO free list: recently-freed blocks are re-issued first
        # (their HBM pages are the warmest)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._reserved = 0
        self._used_rows = 0
        # bumped by reset(): ids taken under an older generation are
        # STALE — a late give() from a request that raced the reset
        # must not re-add them (the free list was already rebuilt)
        self.generation = 0
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        self.instance = telemetry.instance_label("kv_pool")
        self._build_instruments()
        self._sync_gauges()

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def _build_instruments(self) -> None:
        R, lbl = self._registry, {"pool": self.instance}

        def gauge(name, help):
            return R.gauge(name, help, ("pool",)).labels(**lbl)

        def counter(name, help):
            return R.counter(name, help, ("pool",)).labels(**lbl)

        self._g_capacity = gauge(
            "unionml_kv_pool_blocks",
            "Allocatable device KV blocks (pool size minus the trash "
            "block).",
        )
        self._g_in_use = gauge(
            "unionml_kv_pool_blocks_in_use",
            "Blocks currently assigned to a slot's block table.",
        )
        self._g_reserved = gauge(
            "unionml_kv_pool_blocks_reserved",
            "Blocks committed to admitted requests but not yet taken "
            "(lazy table growth draws from these).",
        )
        self._g_bytes = gauge(
            "unionml_kv_pool_bytes",
            "Device bytes held by in-use KV blocks.",
        )
        self._g_occupancy = gauge(
            "unionml_kv_pool_occupancy_ratio",
            "(in-use + reserved) blocks / capacity — 1.0 means the next "
            "admission parks or sheds.",
        )
        self._g_frag = gauge(
            "unionml_kv_pool_fragmentation_ratio",
            "1 - used rows / (in-use blocks x block_size): internal "
            "fragmentation of partially-filled tail blocks.",
        )
        self._m_allocated = counter(
            "unionml_kv_pool_allocated_blocks_total",
            "Blocks taken from the free list.",
        )
        self._m_freed = counter(
            "unionml_kv_pool_freed_blocks_total",
            "Blocks returned to the free list.",
        )
        self._m_alloc_failures = counter(
            "unionml_kv_pool_alloc_failures_total",
            "Reservations refused because the pool had too few "
            "unreserved free blocks.",
        )
        self._m_preempted = counter(
            "unionml_kv_pool_preempted_blocks_total",
            "Blocks released by scheduler preemption (a resident's KV "
            "evicted to the host prefix-cache store; the blocks return "
            "to the free list once the dispatch fence passes).",
        )

    def _sync_gauges(self) -> None:
        cap = self.capacity
        in_use = self.in_use
        self._g_capacity.set(cap)
        self._g_in_use.set(in_use)
        self._g_reserved.set(self._reserved)
        self._g_bytes.set(in_use * self.block_nbytes)
        self._g_occupancy.set((in_use + self._reserved) / max(1, cap))
        self._g_frag.set(
            0.0 if in_use == 0
            else 1.0 - self._used_rows / (in_use * self.block_size)
        )

    # ------------------------------------------------------------------ #
    # allocation
    # ------------------------------------------------------------------ #

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the trash block)."""
        return self.num_blocks - 1

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def reserved(self) -> int:
        return self._reserved

    @property
    def available(self) -> int:
        """Blocks a NEW reservation may claim: free minus already
        committed to other requests' lazy growth."""
        return len(self._free) - self._reserved

    def reserve(self, n: int, *, count_failure: bool = True) -> None:
        """Commit ``n`` blocks to a request (taken lazily via
        :meth:`take`); raises :class:`PoolExhausted` — and counts an
        alloc failure — when fewer than ``n`` unreserved free blocks
        exist. All-or-nothing, so a reserved request's table growth can
        never fail mid-decode.

        ``count_failure=False`` suppresses the failure counter: the
        engine RETRIES a parked admission every dispatcher pass, and
        the counter must tally pool-pressure INCIDENTS (one per park,
        pairing with the flight recorder's ``pool_pressure`` events),
        not retry spin."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        if n > self.available:
            if count_failure:
                self._m_alloc_failures.inc()
            self._sync_gauges()
            raise PoolExhausted(
                f"kv pool exhausted: {n} blocks needed, "
                f"{self.available} available "
                f"({self.in_use} in use, {self._reserved} reserved, "
                f"capacity {self.capacity})",
                needed=n, available=self.available,
            )
        self._reserved += n
        self._sync_gauges()

    def take(self) -> int:
        """Convert one reserved block into a concrete id (table
        growth). The caller must hold an unconverted reservation — the
        free list cannot be empty then (reservation invariant)."""
        if self._reserved < 1:
            raise RuntimeError("take() without a reservation")
        bid = self._free.pop()
        self._reserved -= 1
        self._m_allocated.inc()
        self._sync_gauges()
        return bid

    def give(self, ids: Sequence[int], unreserve: int = 0) -> None:
        """Return taken blocks to the free list and drop ``unreserve``
        never-taken reservation slots (a finished/failed request frees
        both in one call)."""
        for bid in ids:
            if not 1 <= bid < self.num_blocks:
                raise ValueError(f"block id {bid} outside pool")
            self._free.append(bid)
        if unreserve < 0 or unreserve > self._reserved:
            raise ValueError(
                f"unreserve {unreserve} outside [0, {self._reserved}]"
            )
        self._reserved -= unreserve
        if ids:
            self._m_freed.inc(len(ids))
        if self.in_use < 0:  # pragma: no cover - double-free guard
            raise RuntimeError("kv pool double-free")
        self._sync_gauges()

    def note_preempted(self, n: int) -> None:
        """Count ``n`` blocks released by a scheduler preemption (the
        engine calls this at eviction time; the actual free rides the
        normal deferred-fence :meth:`give` path, so the flow counters
        stay consistent — this series only attributes the CAUSE)."""
        if n > 0:
            self._m_preempted.inc(n)

    def note_used_rows(self, rows: int) -> None:
        """Update the fragmentation gauge's numerator: total rows
        actually holding KV across every in-use block (the engine's
        host-side fill estimate)."""
        self._used_rows = max(0, int(rows))
        self._sync_gauges()

    def reset(self) -> None:
        """Return EVERY block to the free list (engine recovery: the
        device pool arrays were invalidated wholesale, so host
        bookkeeping resets with them)."""
        freed = self.in_use
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._reserved = 0
        self._used_rows = 0
        self.generation += 1
        if freed:
            self._m_freed.inc(freed)
        self._sync_gauges()

    def resize(self, *, num_blocks: int, block_nbytes: int) -> None:
        """Re-count an idle pool: ``num_blocks`` blocks of ``block_nbytes``
        (the engine's blocks changed size: a placed tree's local kv heads).
        Refused while any block is taken or reserved."""
        if self.in_use or self._reserved:
            raise RuntimeError(
                f"cannot resize a pool with {self.in_use} blocks in use and "
                f"{self._reserved} reserved"
            )
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the trash block), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_nbytes = int(block_nbytes)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.generation += 1
        self._sync_gauges()

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #

    def blocks_for_rows(self, rows: int) -> int:
        """Blocks needed to cover ``rows`` KV rows."""
        return -(-max(0, int(rows)) // self.block_size)

    def stats(self) -> dict:
        """The ``kv_pool`` section of ``DecodeEngine.stats()`` — a thin
        view over this instance's registry series."""
        in_use = self.in_use
        return {
            "block_size": self.block_size,
            "capacity_blocks": self.capacity,
            "blocks_in_use": in_use,
            "blocks_reserved": self._reserved,
            "blocks_free": len(self._free),
            "bytes_in_use": in_use * self.block_nbytes,
            "occupancy": round(
                (in_use + self._reserved) / max(1, self.capacity), 3
            ),
            "fragmentation": round(
                0.0 if in_use == 0
                else 1.0 - self._used_rows / (in_use * self.block_size), 3
            ),
            "allocated_blocks": int(self._m_allocated.value),
            "freed_blocks": int(self._m_freed.value),
            "alloc_failures": int(self._m_alloc_failures.value),
            "preempted_blocks": int(self._m_preempted.value),
        }

    def reset_stats(self) -> None:
        """Zero the flow counters (benchmarks call this between
        phases); the occupancy gauges re-sync to live contents."""
        for m in (
            self._m_allocated, self._m_freed, self._m_alloc_failures,
            self._m_preempted,
        ):
            m.reset()
        self._sync_gauges()
