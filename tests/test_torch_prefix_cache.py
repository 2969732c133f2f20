"""The port's prefix cache (``unionml_tpu_torch.serving.prefix_cache``) on
the CPU: the radix tree and its byte-budgeted host store with fabricated
KV block trees (torch tensors, the port's host rows), as the JAX
package's own tests hold ``unionml_tpu.serving.prefix_cache``; the packed
host blocks the engine moves in one copy; and the wire codecs against the
JAX package's, in both directions, bit for bit (bf16 included).
"""

import threading

import numpy as np
import pytest
import torch

import ml_dtypes

from unionml_tpu.serving import prefix_cache as jpc

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.serving.prefix_cache import (
    RadixPrefixCache,
    carve,
    decode_entries,
    encode_entries,
    pack_rows,
    packed_base,
    tree_nbytes,
)

import torch_threads

torch_threads.share_cores()


def _cache(**kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_bytes", 1 << 20)
    return RadixPrefixCache(registry=telemetry.MetricsRegistry(), **kw)


def _block_tree(block=4, fill=0.0):
    """A fabricated one-layer KV tree shaped like the engine's
    ``[1, block, heads, dim]`` cache rows."""
    k = torch.full((1, block, 2, 4), fill, dtype=torch.float32)
    return ((k, k + 1.0),)


_BLOCK_BYTES = tree_nbytes(_block_tree())


# --------------------------------------------------------------------- #
# host-level store semantics (the JAX package's cache tests)
# --------------------------------------------------------------------- #


def test_prefix_cache_match_insert_roundtrip():
    cache = _cache()
    toks = np.arange(1, 13, dtype=np.int32)          # 3 full blocks
    miss = cache.match(toks)
    assert miss.n_blocks == 0 and miss.rows == []
    miss.release()
    cache.insert(toks, 0, [_block_tree(fill=float(i)) for i in range(3)])
    assert cache.entries == 3
    assert cache.bytes == 3 * _BLOCK_BYTES

    hit = cache.match(toks)
    assert hit.n_blocks == 3 and hit.n_tokens == 12
    assert hit.rows[1][0][0][0, 0, 0, 0] == 1.0      # prompt order
    hit.release()
    part = cache.match(np.concatenate([toks[:8], [90, 91, 92, 93]]))
    assert part.n_blocks == 2
    part.release()
    short = cache.match(toks[:7])                    # sub-block tails never match
    assert short.n_blocks == 1
    short.release()
    s = cache.stats()
    assert s["hits"] == 2 and s["misses"] == 1
    assert s["partial_hits"] == 1 and s["hit_rate"] == pytest.approx(0.75)


def test_prefix_cache_peek_is_readonly():
    cache = _cache()
    toks = np.arange(1, 13, dtype=np.int32)
    assert cache.peek(toks) == 0
    cache.insert(toks, 0, [_block_tree(fill=float(i)) for i in range(3)])
    assert cache.peek(toks) == 12
    assert cache.peek(toks[:7]) == 4
    assert cache.peek(np.concatenate([toks[:8], [90, 91, 92, 93]])) == 8
    assert cache.peek([50, 51]) == 0
    s = cache.stats()
    assert s["hits"] == 0 and s["misses"] == 0 and s["partial_hits"] == 0
    assert cache.refcounts() == 0


def test_prefix_cache_insert_requires_ancestors():
    cache = _cache()
    toks = np.arange(1, 13, dtype=np.int32)
    assert cache.insert(toks, 2, [_block_tree()]) == 0 and cache.entries == 0
    cache.insert(toks, 0, [_block_tree(), _block_tree()])
    assert cache.insert(toks, 2, [_block_tree()]) == 1
    assert cache.entries == 3


def test_prefix_cache_lru_eviction_under_byte_budget():
    cache = _cache(max_bytes=3 * _BLOCK_BYTES)
    a = np.arange(1, 9, dtype=np.int32)
    b = np.arange(50, 58, dtype=np.int32)
    cache.insert(a, 0, [_block_tree(), _block_tree()])
    cache.match(a).release()
    cache.insert(b, 0, [_block_tree(), _block_tree()])
    assert cache.bytes <= 3 * _BLOCK_BYTES
    assert cache.entries == 3
    assert cache.match(a).n_blocks >= 1              # a's leaf was the victim
    got_b = cache.match(b)
    assert got_b.n_blocks == 2
    got_b.release()
    assert cache.stats()["evictions"] == 1


def test_prefix_cache_insert_never_evicts_own_chain():
    cache = _cache(max_bytes=2 * _BLOCK_BYTES + 1)
    toks = np.arange(1, 13, dtype=np.int32)
    attached = cache.insert(toks, 0, [_block_tree(fill=float(i)) for i in range(3)])
    assert attached == 2 and cache.entries == 2
    assert cache.bytes == 2 * _BLOCK_BYTES
    lease = cache.match(toks)
    assert lease.n_blocks == 2
    assert lease.rows[1][0][0][0, 0, 0, 0] == 1.0
    lease.release()
    assert cache.stats()["evictions"] == 0
    cache.insert(np.arange(50, 58, dtype=np.int32), 0, [_block_tree(), _block_tree()])
    assert cache.bytes <= 2 * _BLOCK_BYTES + 1


def test_prefix_cache_pinned_blocks_survive_pressure():
    cache = _cache(max_bytes=2 * _BLOCK_BYTES)
    pinned = np.arange(1, 9, dtype=np.int32)
    cache.pin(pinned)
    cache.insert(pinned, 0, [_block_tree(), _block_tree()])
    for i in range(5):
        cache.insert(np.arange(100 + 10 * i, 104 + 10 * i, dtype=np.int32), 0, [_block_tree()])
    surv = cache.match(pinned)
    assert surv.n_blocks == 2, "pinned blocks were evicted"
    surv.release()
    assert cache.pinned_blocks() == 2
    assert cache.bytes <= 3 * _BLOCK_BYTES


def test_prefix_cache_lease_blocks_eviction():
    cache = _cache(max_bytes=_BLOCK_BYTES)
    a = np.arange(1, 5, dtype=np.int32)
    cache.insert(a, 0, [_block_tree()])
    lease = cache.match(a)
    assert lease.n_blocks == 1 and cache.refcounts() == 1
    b = np.arange(50, 54, dtype=np.int32)
    cache.insert(b, 0, [_block_tree()])              # no room: a is leased
    assert cache.match(b).n_blocks == 0
    assert cache.stats()["insert_rejected_blocks"] == 1
    still = cache.match(a)
    assert still.n_blocks == 1
    still.release()
    lease.release()
    lease.release()                                  # idempotent
    assert cache.refcounts() == 0
    cache.insert(b, 0, [_block_tree()])
    got = cache.match(b)
    assert got.n_blocks == 1
    got.release()


def test_prefix_cache_concurrent_lookup_insert():
    cache = _cache(max_bytes=20 * _BLOCK_BYTES)
    rng = np.random.default_rng(0)
    seqs = [np.concatenate([np.arange(1, 9), rng.integers(10, 90, 8)]).astype(np.int32)
            for _ in range(8)]
    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(60):
                toks = seqs[r.integers(len(seqs))]
                lease = cache.match(toks)
                nb = len(toks) // 4
                if lease.n_blocks < nb:
                    cache.insert(toks, lease.n_blocks,
                                 [_block_tree(fill=float(j)) for j in range(lease.n_blocks, nb)])
                lease.release()
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert cache.bytes <= 20 * _BLOCK_BYTES
    assert cache.refcounts() == 0
    lease = cache.match(seqs[0])
    assert 0 <= lease.n_blocks <= 4
    lease.release()


def test_prefix_cache_clear_keeps_pins():
    cache = _cache()
    toks = np.arange(1, 9, dtype=np.int32)
    cache.pin(toks)
    cache.insert(toks, 0, [_block_tree(), _block_tree()])
    cache.clear()
    assert cache.entries == 0 and cache.bytes == 0
    cache.insert(toks, 0, [_block_tree(), _block_tree()])
    cache.max_bytes = 2 * _BLOCK_BYTES
    cache.insert(np.arange(60, 64, dtype=np.int32), 0, [_block_tree()])
    lease = cache.match(toks)
    assert lease.n_blocks == 2
    lease.release()


def test_prefix_cache_series_share_the_reference_names():
    registry = telemetry.MetricsRegistry()
    cache = RadixPrefixCache(block_size=4, registry=registry)
    cache.insert(np.arange(1, 5, dtype=np.int32), 0, [_block_tree()])
    cache.match(np.arange(1, 5, dtype=np.int32)).release()
    cache.record_saved_tokens(4)
    text = registry.exposition()
    for name in ("hits_total", "partial_hits_total", "misses_total",
                 "prefill_tokens_saved_total", "bytes", "entries", "evictions_total",
                 "inserted_blocks_total", "insert_rejected_blocks_total",
                 "lookup_ms", "insert_ms"):
        assert f"unionml_prefix_cache_{name}" in text, name
    assert cache.stats()["prefill_tokens_saved"] == 4
    cache.reset_stats()
    assert cache.stats()["prefill_tokens_saved"] == 0 and cache.entries == 1


# --------------------------------------------------------------------- #
# fleet warming: export_hot / import_blocks
# --------------------------------------------------------------------- #


def test_export_hot_selects_hottest_with_ancestor_closure():
    cache = _cache()
    deep = list(range(100, 112))
    shallow = list(range(200, 204))
    cache.insert(deep, 0, [_block_tree(fill=float(i)) for i in range(3)])
    cache.insert(shallow, 0, [_block_tree(fill=9.0)])
    cache.match(shallow).release()
    entries = cache.export_hot(max_blocks=1)
    assert len(entries) == 1
    assert entries[0]["tokens"].tolist() == shallow and entries[0]["first_block"] == 0
    cache.match(deep).release()
    entries = cache.export_hot(max_blocks=2)
    assert len(entries) == 2
    exported = sorted((e["tokens"].tolist()[:4], e["first_block"]) for e in entries)
    assert (deep[:4], 0) in exported or (shallow, 0) in exported
    firsts = [e["first_block"] for e in entries]
    assert firsts == sorted(firsts)
    assert cache.refcounts() == 0


def test_export_import_roundtrip_warms_peer_and_keeps_counters_clean():
    donor, joiner = _cache(), _cache()
    tokens = list(range(1, 13))
    donor.insert(tokens, 0, [_block_tree(fill=float(i)) for i in range(3)])
    before = donor.stats()["hits"], donor.stats()["misses"]
    assert joiner.import_blocks(donor.export_hot(max_blocks=8)) == 3
    assert joiner.peek(tokens) == 12
    assert (donor.stats()["hits"], donor.stats()["misses"]) == before
    assert joiner.stats()["hits"] == 0 and joiner.stats()["misses"] == 0
    assert joiner.bytes == donor.bytes
    donor.clear()
    assert donor.entries == 0
    assert donor.export_hot() == []
    assert joiner.export_hot(max_blocks=0) == []
    assert joiner.import_blocks([]) == 0
    # export_request: one entry per matched block, under a lease
    entries = joiner.export_request(tokens + [7])
    assert [e["first_block"] for e in entries] == [0, 1, 2]
    assert entries[2]["tokens"].tolist() == tokens and joiner.refcounts() == 0


def test_import_respects_byte_budget_of_importer():
    donor = _cache()
    tokens = list(range(1, 17))
    donor.insert(tokens, 0, [_block_tree(fill=float(i)) for i in range(4)])
    tiny = _cache(max_bytes=2 * _BLOCK_BYTES)
    assert tiny.import_blocks(donor.export_hot(max_blocks=8)) == 2
    assert tiny.bytes <= 2 * _BLOCK_BYTES
    assert tiny.peek(tokens) == 8


# --------------------------------------------------------------------- #
# packed host blocks and the wire codecs
# --------------------------------------------------------------------- #


def _kv_tree(seed: int, quant: bool):
    """Two layers of engine-shaped rows: bf16 k / v, or int8 k / v with
    fp32 scale planes (the int8 cache)."""
    g = torch.Generator().manual_seed(seed)
    layers = []
    for _ in range(2):
        if quant:
            kq = torch.randint(-127, 128, (1, 4, 2, 8), generator=g, dtype=torch.int8)
            layers.append((kq, kq.flip(1), torch.rand(1, 4, 2, generator=g),
                           torch.rand(1, 4, 2, generator=g)))
        else:
            k = torch.randn(1, 4, 2, 8, generator=g).to(torch.bfloat16)
            layers.append((k, -k))
    return tuple(layers)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(torch.uint8) == b.view(torch.uint8)).all()
    )


@pytest.mark.parametrize("quant", [False, True])
def test_packed_blocks_carve_back_to_their_rows(quant):
    rows = _kv_tree(1, quant)
    packed = pack_rows(rows)
    base = packed_base(packed)
    assert base is not None and base.dtype == torch.uint8
    assert packed_base(rows) is None          # separate tensors: not one buffer
    from unionml_tpu_torch.serving.prefix_cache import block_specs

    again = carve(base.clone(), block_specs(rows))
    for src, p, a in zip(rows, packed, again):
        for x, y, z in zip(src, p, a):
            assert _same_bits(x, y) and _same_bits(x, z)
    assert tree_nbytes(packed) == tree_nbytes(rows)


@pytest.mark.parametrize("quant", [False, True])
def test_jax_payload_decodes_in_the_port_bit_for_bit(quant):
    """A payload the JAX package encodes (numpy rows, bf16 through
    ml_dtypes) decodes in the port to the same bits."""
    rows = _kv_tree(2, quant)
    as_numpy = tuple(
        tuple(b.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
              if b.dtype == torch.bfloat16 else b.numpy() for b in layer)
        for layer in rows
    )
    wire = jpc.encode_entries([{"tokens": np.arange(4), "first_block": 0, "rows": as_numpy}])
    back = decode_entries(wire)
    assert back[0]["tokens"].tolist() == [0, 1, 2, 3] and back[0]["first_block"] == 0
    for src, got in zip(rows, back[0]["rows"]):
        for x, y in zip(src, got):
            assert _same_bits(x, y)
    assert packed_base(back[0]["rows"]) is not None


@pytest.mark.parametrize("quant", [False, True])
def test_port_payload_decodes_in_the_jax_package_bit_for_bit(quant):
    """The port's payload decodes in ``unionml_tpu`` to the same bits, and
    the wire form is byte for byte the JAX package's."""
    rows = _kv_tree(3, quant)
    wire = encode_entries([{"tokens": np.arange(8), "first_block": 1, "rows": rows}])
    back = jpc.decode_entries(wire)
    for src, got in zip(rows, back[0]["rows"]):
        for x, y in zip(src, got):
            want = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
            got_bits = y.view(np.int16) if str(y.dtype) == "bfloat16" else y
            assert str(y.dtype) == str(x.dtype).removeprefix("torch.")
            assert np.array_equal(got_bits, want)
    assert jpc.encode_entries(back) == wire


def test_decode_rejects_a_malformed_payload():
    with pytest.raises(ValueError, match="malformed"):
        decode_entries([{"tokens": [1]}])
    with pytest.raises(ValueError, match="malformed"):
        decode_entries([{"tokens": [1], "first_block": 0,
                         "rows": [[{"dtype": "nope", "shape": [1], "data": ""}]]}])
