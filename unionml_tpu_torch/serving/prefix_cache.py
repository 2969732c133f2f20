"""Automatic prefix KV-cache: radix-tree prompt reuse over a host store.

The port of :mod:`unionml_tpu.serving.prefix_cache`. Real LLM traffic
repeats itself: system prompts, few-shot templates and chat histories
give most requests a long common prefix. This module is the
cross-request reuse layer (RadixAttention, SGLang; vLLM automatic prefix
caching) for the engine's host/device split:

- :class:`RadixPrefixCache` — a thread-safe radix tree keyed on
  fixed-size **token blocks** (``block_size`` tokens per node). Each node
  owns the host copy of its block's KV rows: the per-layer
  tuple-of-tuples cache tree with ``[1, block, ...]`` leaves, rank-generic
  so bf16 KV buffers and the int8 cache's scale planes ride along alike.
- a **byte-budgeted host block store**: inserts charge each block's bytes
  against ``max_bytes`` and evict least-recently-used leaf blocks to fit,
  skipping blocks that are **pinned** (a ``system_prefix``) or **leased**
  by an in-flight admission.
- :class:`PrefixLease` — the refcount pin :meth:`RadixPrefixCache.match`
  returns; the engine releases it exactly once, after its splice and the
  insert of the prompt's new blocks.

Host rows are CPU torch tensors (numpy cannot name bf16 without
``ml_dtypes``). The engine's own blocks are views into ONE flat host
buffer per block (:func:`pack_rows` / :func:`carve`), pinned when a CUDA
device exists, so the device side moves a block host↔device in one copy
that never makes the host wait. The cache itself stores whatever trees it
is given and never touches a device.

Telemetry (per-instance ``cache`` label), the reference's series:
``unionml_prefix_cache_hits_total`` / ``_partial_hits_total`` /
``_misses_total``, ``_prefill_tokens_saved_total``, ``_bytes`` /
``_entries``, ``_evictions_total`` / ``_inserted_blocks_total`` /
``_insert_rejected_blocks_total``, ``_lookup_ms`` / ``_insert_ms``.
"""

from __future__ import annotations

import base64
import heapq
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch import telemetry

__all__ = [
    "RadixPrefixCache",
    "PrefixLease",
    "carve",
    "decode_entries",
    "encode_entries",
    "pack_rows",
    "packed_base",
    "tree_nbytes",
]


def _nbytes(buf: Any) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size()
    return int(np.asarray(buf).nbytes)


def tree_nbytes(rows: Any) -> int:
    """Total bytes of one block's KV tree (tuple-of-tuples of tensors or
    arrays)."""
    return sum(_nbytes(buf) for layer in rows for buf in layer)


# --------------------------------------------------------------------- #
# packed host blocks: one flat buffer per block tree
# --------------------------------------------------------------------- #

_ALIGN = 16   # every leaf starts 16-byte aligned inside its block buffer


def _layout(specs) -> Tuple[list, int]:
    """Byte offsets of ``specs`` (per layer, per buffer: ``(shape,
    dtype)``) packed in order, and the total size."""
    offsets, off = [], 0
    for layer in specs:
        row = []
        for shape, dtype in layer:
            row.append(off)
            n = math.prod(shape) * dtype.itemsize
            off += -(-n // _ALIGN) * _ALIGN
        offsets.append(row)
    return offsets, off


def block_specs(rows: Any) -> tuple:
    """``(shape, dtype)`` of every leaf of a block tree."""
    return tuple(
        tuple((tuple(buf.shape), buf.dtype) for buf in layer) for layer in rows
    )


def packed_nbytes(specs) -> int:
    """Size of the flat buffer that holds one block of layout ``specs``."""
    return _layout(specs)[1]


def host_empty(nbytes: int) -> torch.Tensor:
    """A flat uint8 host buffer, pinned when a CUDA device exists: a copy
    to or from pinned memory runs without making the host wait."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=torch.cuda.is_available())


def carve(flat: torch.Tensor, specs) -> tuple:
    """The block tree of layout ``specs`` as views into the flat uint8
    buffer ``flat`` (host or device): the inverse of :func:`packed_base`."""
    offsets, _ = _layout(specs)
    out = []
    for layer, offs in zip(specs, offsets):
        row = []
        for (shape, dtype), off in zip(layer, offs):
            n = math.prod(shape) * dtype.itemsize
            row.append(flat[off:off + n].view(dtype).view(shape))
        out.append(tuple(row))
    return tuple(out)


def pack_rows(rows: Any) -> tuple:
    """Owned copy of a block tree (tensors, or numpy arrays of a dtype
    torch names) packed into one flat host buffer."""
    rows = tuple(
        tuple(buf if isinstance(buf, torch.Tensor) else torch.from_numpy(np.asarray(buf))
              for buf in layer)
        for layer in rows
    )
    specs = block_specs(rows)
    packed = carve(host_empty(packed_nbytes(specs)), specs)
    for dst_layer, src_layer in zip(packed, rows):
        for dst, src in zip(dst_layer, src_layer):
            dst.copy_(src)
    return packed


def packed_base(rows: Any) -> Optional[torch.Tensor]:
    """The flat uint8 buffer every leaf of ``rows`` is carved from, or
    ``None`` when the leaves do not share one host storage laid out as
    :func:`carve` lays it (a tree built elsewhere)."""
    leaves = [buf for layer in rows for buf in layer]
    if not leaves or not all(isinstance(b, torch.Tensor) and b.device.type == "cpu"
                             for b in leaves):
        return None
    storage = leaves[0].untyped_storage()
    offsets, total = _layout(block_specs(rows))
    flat_offs = [o for row in offsets for o in row]
    for buf, off in zip(leaves, flat_offs):
        if (buf.untyped_storage().data_ptr() != storage.data_ptr()
                or not buf.is_contiguous()
                or buf.storage_offset() * buf.element_size() != off):
            return None
    if storage.nbytes() < total:
        return None
    return torch.empty(0, dtype=torch.uint8).set_(storage)[:total]


# --------------------------------------------------------------------- #
# wire codecs for export entries (the cross-host KV handoff)
# --------------------------------------------------------------------- #


def _encode_buf(buf: Any) -> dict:
    """dtype name, shape and base64 of the raw bytes: the reference's
    wire format byte for byte. bf16 leaves are written as their 16-bit
    words, under the name ``"bfloat16"``."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        shape = list(t.shape)
    else:
        a = np.ascontiguousarray(np.asarray(buf))
        name, raw, shape = str(a.dtype), a.tobytes(), list(a.shape)
    return {"dtype": name, "shape": shape, "data": base64.b64encode(raw).decode("ascii")}


def _decode_buf(spec: dict) -> torch.Tensor:
    raw = base64.b64decode(spec["data"])
    shape = [int(d) for d in spec["shape"]]
    name = spec["dtype"]
    if name == "bfloat16":
        # 16-bit words, then their bf16 view (numpy has no bf16)
        words = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"unknown KV buffer dtype {name!r}")
    return torch.from_numpy(np.frombuffer(raw, np.dtype(name)).reshape(shape).copy())


def encode_entries(entries: Sequence[dict]) -> List[dict]:
    """JSON-safe form of :meth:`RadixPrefixCache.export_request` /
    :meth:`~RadixPrefixCache.export_hot` entries — the wire format of
    ``POST /debug/kv/export`` ↔ ``/debug/kv/import``. Each KV buffer
    ships as dtype + shape + base64 bytes, as the reference's does, so a
    payload either package exports imports into the other."""
    out: List[dict] = []
    for entry in entries:
        out.append({
            "tokens": [int(t) for t in np.asarray(entry["tokens"]).ravel()],
            "first_block": int(entry["first_block"]),
            "rows": [[_encode_buf(buf) for buf in layer] for layer in entry["rows"]],
        })
    return out


def decode_entries(payload: Sequence[dict]) -> List[dict]:
    """Inverse of :func:`encode_entries`: importable entries whose rows
    are packed host blocks (:func:`pack_rows`). Raises ``ValueError`` on
    a malformed body — the transport maps it to 422."""
    out: List[dict] = []
    try:
        for entry in payload:
            out.append({
                "tokens": np.asarray([int(t) for t in entry["tokens"]], np.int32),
                "first_block": int(entry["first_block"]),
                "rows": pack_rows(
                    tuple(tuple(_decode_buf(buf) for buf in layer) for layer in entry["rows"])
                ),
            })
    except (KeyError, TypeError, AttributeError, ValueError) as exc:
        raise ValueError(f"malformed KV entry payload: {exc!r}") from exc
    return out


class _Node:
    """One cached block: ``block_size`` tokens' KV rows plus tree links.

    ``refcount`` counts live :class:`PrefixLease` holders; ``pinned``
    marks blocks under a registered pin sequence (``system_prefix``).
    Either makes the node unevictable."""

    __slots__ = (
        "key", "rows", "nbytes", "children", "parent", "refcount",
        "pinned", "last_used", "depth",
    )

    def __init__(self, key: bytes, rows: Any, nbytes: int,
                 parent: Optional["_Node"], depth: int):
        self.key = key
        self.rows = rows
        self.nbytes = nbytes
        self.children: Dict[bytes, "_Node"] = {}
        self.parent = parent
        self.refcount = 0
        self.pinned = False
        self.last_used = 0
        self.depth = depth  # block index (root = -1)


class PrefixLease:
    """In-use pin over the matched path; release exactly once.

    ``rows`` is the list of matched blocks' host KV trees in prompt order
    (``n_blocks`` entries, each covering ``block_size`` tokens). The
    engine may consume fewer than all of them; the lease still pins the
    whole path so a follow-up insert of suffix blocks finds its ancestors
    alive."""

    __slots__ = ("_cache", "_nodes", "rows", "n_blocks", "n_tokens")

    def __init__(self, cache: "RadixPrefixCache", nodes: List[_Node]):
        self._cache = cache
        self._nodes = nodes
        self.rows = [n.rows for n in nodes]
        self.n_blocks = len(nodes)
        self.n_tokens = len(nodes) * cache.block_size

    def release(self) -> None:
        """Drop the in-use pins (idempotent and race-safe: the node list
        is swapped under the cache lock, so refcounts drop only once)."""
        with self._cache._lock:
            nodes, self._nodes = self._nodes, []
            for node in nodes:
                node.refcount -= 1


class RadixPrefixCache:
    """Radix tree of prompt-prefix KV blocks in a byte-budgeted host store.

    Args:
        block_size: tokens per tree node; the engine's KV block unit (the
            paged pool shares it), so it quantizes both the key space and
            the reusable match length.
        max_bytes: host budget for stored KV rows. Inserting past it evicts
            least-recently-used unpinned, unleased leaf blocks; when nothing
            is evictable the incoming blocks are dropped (counted in
            ``insert_rejected_blocks``), never the in-use ones.
        registry: explicit :class:`~unionml_tpu_torch.telemetry
            .MetricsRegistry`; defaults to the process-global one.
    """

    def __init__(
        self,
        *,
        block_size: int = 16,
        max_bytes: int = 256 << 20,
        registry: Optional[telemetry.MetricsRegistry] = None,
    ):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.block_size = int(block_size)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._root = _Node(b"", None, 0, None, -1)
        self._bytes = 0
        self._entries = 0
        self._clock = 0  # monotone LRU stamp (under the lock)
        self._pinned_seqs: List[np.ndarray] = []
        self._registry = registry if registry is not None else telemetry.get_registry()
        self.instance = telemetry.instance_label("prefix_cache")
        self._build_instruments()

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def _build_instruments(self) -> None:
        R, lbl = self._registry, {"cache": self.instance}

        def counter(name, help):
            return R.counter(name, help, ("cache",)).labels(**lbl)

        def hist(name, help):
            return R.histogram(name, help, ("cache",)).labels(**lbl)

        self._m_hits = counter(
            "unionml_prefix_cache_hits_total",
            "Lookups where every cacheable block of the prompt matched.",
        )
        self._m_partial = counter(
            "unionml_prefix_cache_partial_hits_total",
            "Lookups matching some but not all cacheable prompt blocks.",
        )
        self._m_misses = counter(
            "unionml_prefix_cache_misses_total",
            "Lookups matching no cached block.",
        )
        self._m_saved = counter(
            "unionml_prefix_cache_prefill_tokens_saved_total",
            "Prompt tokens whose prefill was skipped via cached KV rows.",
        )
        self._m_evictions = counter(
            "unionml_prefix_cache_evictions_total",
            "Blocks evicted to fit the byte budget.",
        )
        self._m_inserted = counter(
            "unionml_prefix_cache_inserted_blocks_total",
            "Blocks attached to the tree.",
        )
        self._m_rejected = counter(
            "unionml_prefix_cache_insert_rejected_blocks_total",
            "Blocks dropped because the budget had no evictable room.",
        )
        self._g_bytes = R.gauge(
            "unionml_prefix_cache_bytes",
            "Host bytes held by stored KV blocks.", ("cache",),
        ).labels(**lbl)
        self._g_entries = R.gauge(
            "unionml_prefix_cache_entries",
            "Blocks resident in the radix tree.", ("cache",),
        ).labels(**lbl)
        self._h_lookup = hist("unionml_prefix_cache_lookup_ms", "match() wall time.")
        self._h_insert = hist("unionml_prefix_cache_insert_ms", "insert() wall time.")

    # ------------------------------------------------------------------ #
    # lookup / insert
    # ------------------------------------------------------------------ #

    def _block_key(self, tokens: np.ndarray, i: int) -> bytes:
        b = self.block_size
        return tokens[i * b:(i + 1) * b].tobytes()

    def _walk_locked(self, tokens: np.ndarray, limit: int) -> List[_Node]:
        """Lease the longest cached path of ``tokens``' first ``limit``
        blocks: refcount and LRU stamp on every node (lock held)."""
        self._clock += 1
        nodes: List[_Node] = []
        node = self._root
        for i in range(limit):
            child = node.children.get(self._block_key(tokens, i))
            if child is None:
                break
            child.refcount += 1
            child.last_used = self._clock
            nodes.append(child)
            node = child
        return nodes

    def match(self, tokens: Sequence[int]) -> PrefixLease:
        """Longest cached block-prefix of ``tokens``; pins the path.

        Returns a :class:`PrefixLease` (possibly empty) the caller MUST
        release. Counts the lookup as a hit (all ``len(tokens) //
        block_size`` cacheable blocks matched), partial hit, or miss; a
        prompt shorter than one block is not counted at all."""
        t0 = time.perf_counter()
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        cacheable = len(tokens) // self.block_size
        with self._lock:
            nodes = self._walk_locked(tokens, cacheable)
        if cacheable == 0:
            pass
        elif not nodes:
            self._m_misses.inc()
        elif len(nodes) == cacheable:
            self._m_hits.inc()
        else:
            self._m_partial.inc()
        self._h_lookup.observe((time.perf_counter() - t0) * 1e3)
        return PrefixLease(self, nodes)

    def lease(self, tokens: Sequence[int]) -> PrefixLease:
        """Pin the longest cached block-prefix of ``tokens`` WITHOUT
        counting a lookup: the preemptive scheduler's eviction-target pin
        (a preempted stream's saved blocks must survive LRU pressure until
        its resume admission splices them back). Bumps the LRU clock but
        moves no hit/miss counter."""
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        with self._lock:
            nodes = self._walk_locked(tokens, len(tokens) // self.block_size)
        return PrefixLease(self, nodes)

    def peek(self, tokens: Sequence[int]) -> int:
        """Longest cached block-prefix of ``tokens``, in TOKENS — a
        read-only probe (routing affinity): no lease, no LRU bump, no
        hit/miss counters."""
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        matched = 0
        with self._lock:
            node = self._root
            for i in range(len(tokens) // self.block_size):
                child = node.children.get(self._block_key(tokens, i))
                if child is None:
                    break
                matched += 1
                node = child
        return matched * self.block_size

    def insert(self, tokens: Sequence[int], first_block: int, blocks: Sequence[Any]) -> int:
        """Attach ``blocks`` (host KV trees for token blocks
        ``[first_block, first_block + len(blocks))`` of ``tokens``) to
        the tree; returns how many were newly attached.

        Blocks whose node already exists are skipped; blocks whose
        ancestors are missing are dropped (a child's rows are meaningless
        without the path above them). Each attach charges the byte budget
        and evicts LRU unpinned, unleased leaves to fit; when nothing more
        is evictable the remaining blocks are rejected."""
        t0 = time.perf_counter()
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        attached = rejected = evicted = 0
        with self._lock:
            self._clock += 1
            # the walked/attached chain is refcount-protected for the
            # call: a mid-insert eviction pass must never pick it
            path: List[_Node] = []
            # ONE tree walk seeds the eviction heap for the whole insert
            heap: Optional[List[Tuple[int, int, _Node]]] = None

            def step(n: _Node) -> _Node:
                n.refcount += 1
                path.append(n)
                return n

            node = self._root
            ok = True
            for i in range(first_block):
                node = node.children.get(self._block_key(tokens, i))
                if node is None:
                    ok = False
                    break
                step(node)
            if ok:
                for j, rows in enumerate(blocks):
                    i = first_block + j
                    key = self._block_key(tokens, i)
                    child = node.children.get(key)
                    if child is not None:
                        child.last_used = self._clock
                        node = step(child)
                        continue
                    nbytes = tree_nbytes(rows)
                    n, heap = self._evict_locked(self.max_bytes - nbytes, heap)
                    evicted += n
                    if self._bytes + nbytes > self.max_bytes:
                        rejected += len(blocks) - j
                        break
                    child = _Node(key, rows, nbytes, node, i)
                    child.last_used = self._clock
                    child.pinned = self._under_pin(tokens, i)
                    node.children[key] = child
                    node = step(child)
                    self._bytes += nbytes
                    self._entries += 1
                    attached += 1
            else:
                rejected += len(blocks)
            for n in path:
                n.refcount -= 1
            self._sync_gauges_locked()
        if attached:
            self._m_inserted.inc(attached)
        if rejected:
            self._m_rejected.inc(rejected)
        if evicted:
            self._m_evictions.inc(evicted)
        self._h_insert.observe((time.perf_counter() - t0) * 1e3)
        return attached

    def record_saved_tokens(self, n: int) -> None:
        """Credit ``n`` prompt tokens whose prefill the caller skipped by
        splicing cached rows (the engine calls this per admission)."""
        if n > 0:
            self._m_saved.inc(n)

    # ------------------------------------------------------------------ #
    # fleet warming (export / import)
    # ------------------------------------------------------------------ #

    def export_hot(self, *, max_blocks: int = 64) -> List[dict]:
        """The hottest ``<= max_blocks`` cached blocks as entries a peer
        cache can :meth:`import_blocks` (the warm-join donor path).

        Most-recently-used first with ancestor closure (a hot deep node
        pulls its whole path in, or is skipped whole for a shallower one);
        each entry is ``{"tokens", "first_block", "rows"}`` — one
        :meth:`insert` call — emitted parent-before-child. The selected
        path is leased while entries are built, and ``rows`` reference the
        store's own write-once tensors. No hit/miss counter moves."""
        if max_blocks < 1:
            return []
        with self._lock:
            nodes: List[_Node] = []
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                nodes.append(node)
            nodes.sort(key=lambda n: n.last_used, reverse=True)
            selected: List[_Node] = []
            chosen = set()
            for node in nodes:
                if id(node) in chosen:
                    continue
                chain: List[_Node] = []
                cur = node
                while cur is not None and cur.parent is not None and id(cur) not in chosen:
                    chain.append(cur)
                    cur = cur.parent
                if len(selected) + len(chain) > max_blocks:
                    continue  # try a shallower hot node
                for n in chain:
                    chosen.add(id(n))
                    selected.append(n)
                if len(selected) >= max_blocks:
                    break
            selected.sort(key=lambda n: n.depth)   # parent before child
            for n in selected:
                n.refcount += 1
            lease = PrefixLease(self, selected)
        try:
            entries: List[dict] = []
            for node in selected:
                path_keys: List[bytes] = []
                cur: Optional[_Node] = node
                while cur is not None and cur.parent is not None:
                    path_keys.append(cur.key)
                    cur = cur.parent
                tokens = np.concatenate([
                    np.frombuffer(k, np.int32) for k in reversed(path_keys)
                ]) if path_keys else np.zeros((0,), np.int32)
                entries.append({"tokens": tokens, "first_block": node.depth, "rows": node.rows})
            return entries
        finally:
            lease.release()

    def export_request(self, tokens: Sequence[int]) -> List[dict]:
        """Export the cached blocks covering ONE prompt — the
        disaggregated-serving KV handoff donor path: one ``{"tokens",
        "first_block", "rows"}`` entry per matched block,
        parent-before-child, built under a lease. No hit/miss counter
        moves."""
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        lease = self.lease(tokens)
        try:
            blk = self.block_size
            return [
                {"tokens": tokens[: (i + 1) * blk].copy(), "first_block": i, "rows": rows}
                for i, rows in enumerate(lease.rows)
            ]
        finally:
            lease.release()

    def import_blocks(self, entries: Sequence[dict]) -> int:
        """Attach exported entries from a donor cache; returns how many
        blocks were newly attached. Each entry rides the normal
        :meth:`insert` budget and eviction."""
        attached = 0
        for entry in entries:
            attached += self.insert(entry["tokens"], int(entry["first_block"]), [entry["rows"]])
        return attached

    # ------------------------------------------------------------------ #
    # pinning / eviction
    # ------------------------------------------------------------------ #

    def pin(self, tokens: Sequence[int]) -> None:
        """Mark every block under ``tokens`` never-evictable — present
        AND future (blocks inserted later along this path are pinned at
        attach time). The ``system_prefix`` path."""
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        if tokens.size == 0:
            return
        with self._lock:
            self._pinned_seqs.append(tokens)
            node = self._root
            for i in range(len(tokens) // self.block_size):
                node = node.children.get(self._block_key(tokens, i))
                if node is None:
                    break
                node.pinned = True

    def _under_pin(self, tokens: np.ndarray, i: int) -> bool:
        """Is block ``i`` of ``tokens`` covered by a pinned sequence?
        (lock held)"""
        end = (i + 1) * self.block_size
        return any(
            seq.size >= end and np.array_equal(seq[:end], tokens[:end])
            for seq in self._pinned_seqs
        )

    @staticmethod
    def _evictable(node: _Node) -> bool:
        return not node.children and not node.pinned and node.refcount == 0

    def _evict_locked(self, budget: int, heap=None):
        """Evict LRU evictable leaves until ``self._bytes <= budget``;
        returns ``(evicted, heap)``. One tree walk seeds a min-heap of
        evictable leaves keyed on recency, reused across an insert's
        blocks; parents are pushed as their last child goes and every pop
        is re-validated. (lock held)"""
        if self._bytes <= budget:
            return 0, heap
        if heap is None:
            heap = []
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is not self._root and self._evictable(node):
                    heapq.heappush(heap, (node.last_used, id(node), node))
        evicted = 0
        while self._bytes > budget and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.parent is None or not self._evictable(victim):
                continue  # detached or re-shielded since pushed
            parent = victim.parent
            del parent.children[victim.key]
            self._bytes -= victim.nbytes
            self._entries -= 1
            victim.parent = None
            victim.rows = None
            evicted += 1
            if parent is not self._root and self._evictable(parent):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return evicted, heap

    # ------------------------------------------------------------------ #
    # maintenance / views
    # ------------------------------------------------------------------ #

    def clear(self) -> None:
        """Drop every stored block (pinned included: cached KV belongs to
        ONE weight binding; the engine clears on a params swap). Pin
        registrations survive, so re-inserted prefix blocks re-pin."""
        with self._lock:
            self._root.children.clear()
            self._bytes = 0
            self._entries = 0
            self._sync_gauges_locked()

    def _sync_gauges_locked(self) -> None:
        self._g_bytes.set(self._bytes)
        self._g_entries.set(self._entries)

    def refcounts(self) -> int:
        """Sum of every stored block's lease refcount (0 when no lease is
        held): what a leak check reads."""
        with self._lock:
            total, stack = 0, list(self._root.children.values())
            while stack:
                node = stack.pop()
                total += node.refcount
                stack.extend(node.children.values())
            return total

    def pinned_blocks(self) -> int:
        """Stored blocks marked never-evictable."""
        with self._lock:
            total, stack = 0, list(self._root.children.values())
            while stack:
                node = stack.pop()
                total += node.pinned
                stack.extend(node.children.values())
            return total

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def entries(self) -> int:
        with self._lock:
            return self._entries

    def stats(self) -> dict:
        """The ``prefix_cache`` section of ``DecodeEngine.stats()`` — a
        thin view over this instance's registry series."""
        hits = int(self._m_hits.value)
        partial = int(self._m_partial.value)
        misses = int(self._m_misses.value)
        lookups = hits + partial + misses
        out = {
            "block_size": self.block_size,
            "max_bytes": self.max_bytes,
            "bytes": self.bytes,
            "entries": self.entries,
            "hits": hits,
            "partial_hits": partial,
            "misses": misses,
            "hit_rate": round((hits + partial) / max(1, lookups), 3),
            "prefill_tokens_saved": int(self._m_saved.value),
            "evictions": int(self._m_evictions.value),
            "inserted_blocks": int(self._m_inserted.value),
            "insert_rejected_blocks": int(self._m_rejected.value),
        }
        for name, h in (("lookup_ms", self._h_lookup), ("insert_ms", self._h_insert)):
            summary = h.summary()
            if summary:
                out[name] = summary
        return out

    def reset_stats(self) -> None:
        """Zero the flow counters and histograms; the store gauges
        re-sync to the live contents."""
        for m in (
            self._m_hits, self._m_partial, self._m_misses, self._m_saved,
            self._m_evictions, self._m_inserted, self._m_rejected,
            self._h_lookup, self._h_insert,
        ):
            m.reset()
        with self._lock:
            self._sync_gauges_locked()
