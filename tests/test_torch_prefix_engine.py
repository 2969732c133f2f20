"""The port's shared-prefix serving against the JAX package's, on the CPU.

``DecodeEngine(prefix_cache=..., system_prefix=...)`` (contiguous and
paged), preemption, the KV handoff (``prefill_export`` / ``kv_export`` /
``kv_import``), ``make_generator(prefix_len>0)`` / ``make_prefix_cache``
and ``make_lm_predictor(system_prefix=)``: the JAX model's weights
(random, from a JAX key) reach the port through ``from_jax_params`` and
everything runs at ``LlamaConfig.tiny`` sizes in fp32 activations, where
greedy decoding has no near-tie flips — so tokens must equal the JAX
package's on the same prompts, and the tokens-saved counters must equal
the JAX engine's. The host store's blocks are held against the JAX
engine's at 1e-5. Last, a CPU rehearsal of chip_smoke's prefix phase.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models import generate as jgen
from unionml_tpu.serving.engine import DecodeEngine as JEngine
from unionml_tpu.serving.prefix_cache import RadixPrefixCache as JCache

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from unionml_tpu_torch.models import generate as gen
from unionml_tpu_torch.serving import DecodeEngine, FaultInjector, ServingApp
from unionml_tpu_torch.serving.faults import xla_oom_error
from unionml_tpu_torch.serving.prefix_cache import (
    RadixPrefixCache,
    decode_entries,
    encode_entries,
    packed_base,
)
from unionml_tpu_torch.serving.scheduler import SchedulerConfig

import torch_threads

torch_threads.share_cores()

VOCAB = 97


def _configs(**overrides):
    kw = dict(vocab_size=VOCAB, dtype="float32", **overrides)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _configs()
    jp = JLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")


def _prompts(rng, lengths):
    return [rng.integers(1, VOCAB, size=int(n)).tolist() for n in lengths]


def _pair(jcfg, cfg, *, cache_block=None, port=None, **kw):
    """The JAX engine and the port's, alike in every knob, each with its
    own prefix cache of ``cache_block`` (or none); ``port`` adds knobs to
    the port's alone."""
    jkw, tkw = dict(kw), {**kw, **(port or {})}
    if cache_block is not None:
        jkw["prefix_cache"] = JCache(block_size=cache_block, max_bytes=32 << 20,
                                     registry=jtelemetry.MetricsRegistry())
        tkw["prefix_cache"] = RadixPrefixCache(block_size=cache_block, max_bytes=32 << 20,
                                               registry=telemetry.MetricsRegistry())
    je = JEngine(JLlama(jcfg), registry=jtelemetry.MetricsRegistry(), **jkw)
    te = DecodeEngine(Llama(cfg), device="cpu", registry=telemetry.MetricsRegistry(), **tkw)
    return je, te


def _in_turn(je, te, jp, tp, prompts, **kw):
    """Each prompt through both engines in turn (later ones splice what
    earlier ones stored); returns both token lists."""
    want = [je.generate(jp, [p], **kw)[0] for p in prompts]
    got = [te.generate(tp, [p], **kw)[0] for p in prompts]
    return want, got


def _saved(engine) -> int:
    return engine.stats()["prefix_cache"]["prefill_tokens_saved"]


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _assert_pool_drained(engine):
    _wait_for(lambda: engine.stats()["kv_pool"]["blocks_in_use"] == 0
              and engine.stats()["kv_pool"]["blocks_reserved"] == 0, what="pool drained")


def _jax_solo(jcfg, jp, prompt, n_new, max_len):
    g = jgen.make_generator(JLlama(jcfg), max_new_tokens=n_new, max_len=max_len)
    return np.asarray(g(jp, jnp.asarray([prompt], jnp.int32)))[0].tolist()


# --------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("paged", [False, True])
def test_engine_prefix_cache_token_parity_and_savings(weights, paged):
    """Cold, full-hit and partial-hit prompts: tokens equal the JAX
    engine's, the tokens-saved counters too, and the warm admissions
    prefilled only their suffixes (the trace's prefill spans)."""
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    shared = rng.integers(1, VOCAB, 24).tolist()
    prompts = [shared + rng.integers(1, VOCAB, 4).tolist()]
    prompts += [prompts[0], shared + rng.integers(1, VOCAB, 7).tolist()]
    tracer = telemetry.TraceRecorder()
    je, te = _pair(jcfg, cfg, cache_block=8, slots=2, max_new_tokens=6, prompt_buckets=(32,),
                   chunk_steps=3, paged=paged, port=dict(tracer=tracer))
    try:
        want, got = _in_turn(je, te, jp, tp, prompts)
        assert got == want
        assert _saved(te) == _saved(je) >= 48
        s, js = te.stats()["prefix_cache"], je.stats()["prefix_cache"]
        assert (s["hits"], s["partial_hits"], s["misses"]) == (
            js["hits"], js["partial_hits"], js["misses"])
        spans = [json.loads(line) for line in tracer.export_jsonl().splitlines() if line]
        names = [sp["name"] for sp in spans]
        assert names.count("prefill") == 3
        assert any(n.startswith("prefix-splice[") for n in names)
        tokens = sorted(sp["tokens"] for sp in spans if sp["name"] == "prefill")
        assert tokens == [len(prompts[0]) - 24, len(prompts[2]) - 24, len(prompts[0])]
        if paged:
            _assert_pool_drained(te)
        _wait_for(lambda: te.prefix_cache.refcounts() == 0, what="leases released")
    finally:
        je.close()
        te.close()


def test_engine_prefix_cache_composes_with_chunked_prefill(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(11)
    shared = rng.integers(1, VOCAB, 32).tolist()
    prompts = [shared + rng.integers(1, VOCAB, n).tolist() for n in (5, 17, 30)]
    je, te = _pair(jcfg, cfg, cache_block=8, slots=2, max_new_tokens=6,
                   prompt_buckets=(16, 64), prefill_chunk=16, chunk_steps=3)
    try:
        want, got = _in_turn(je, te, jp, tp, prompts)
        assert got == want
        assert _saved(te) == _saved(je) >= 64
    finally:
        je.close()
        te.close()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_prefix_cache_with_kv_quant(weights, paged):
    """Cached blocks carry the int8 layout (quantized rows + scale planes)
    through extract → host store → splice unchanged."""
    jp, _ = weights
    jcfg, cfg = _configs(kv_quant=True)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(13)
    shared = rng.integers(1, VOCAB, 16).tolist()
    p1 = shared + rng.integers(1, VOCAB, 5).tolist()
    p2 = shared + rng.integers(1, VOCAB, 9).tolist()
    je, te = _pair(jcfg, cfg, cache_block=8, slots=2, max_new_tokens=6, prompt_buckets=(32,),
                   chunk_steps=3, paged=paged)
    try:
        want, got = _in_turn(je, te, jp, tp, [p1, p1, p2])
        assert got == want
        assert _saved(te) == _saved(je) > 0
        lease = te.prefix_cache.lease(p1)
        assert lease.n_blocks == 2 and all(len(layer) == 4 for layer in lease.rows[0])
        lease.release()
    finally:
        je.close()
        te.close()


def test_engine_system_prefix_rides_cache_pinned(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, VOCAB, 16).tolist()
    prompts = _prompts(rng, (5, 9))
    je, te = _pair(jcfg, cfg, slots=2, max_new_tokens=6, prompt_buckets=(8, 16),
                   chunk_steps=3, system_prefix=prefix)
    try:
        assert te.prefix_cache is not None          # the shim turns it on
        assert te.buckets == je.buckets and te.cache_len == je.cache_len
        want, got = _in_turn(je, te, jp, tp, prompts)
        assert got == want
        assert _saved(te) == _saved(je) >= 16
        # pinned entries survive a pressure cap far below the store size
        te.prefix_cache.max_bytes = 1
        te.prefix_cache.insert(np.arange(200, 216, dtype=np.int32) % VOCAB, 0,
                               [((torch.zeros(1, 16, 2, 4),),)])
        lease = te.prefix_cache.match(np.asarray(prefix, np.int32))
        assert lease.n_blocks == 1, "pinned system_prefix block evicted"
        lease.release()
        assert te.prefix_cache.pinned_blocks() == 1
    finally:
        je.close()
        te.close()


def test_engine_system_prefix_matches_prefixed_jax(weights):
    """system_prefix that is not block-aligned, three slots and a second
    round on reused slots: tokens equal the JAX engine's."""
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, VOCAB, 7).tolist()
    prompts = _prompts(rng, (5, 8, 12))
    je, te = _pair(jcfg, cfg, slots=3, max_new_tokens=6, prompt_buckets=(8, 16),
                   chunk_steps=3, system_prefix=prefix)
    try:
        for batch in (prompts, prompts[:2]):
            assert te.generate(tp, batch) == je.generate(jp, batch)
    finally:
        je.close()
        te.close()


def test_chunked_prefill_with_system_prefix(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, VOCAB, 7).tolist()
    prompts = _prompts(rng, (9, 20, 32))
    je, te = _pair(jcfg, cfg, slots=2, max_new_tokens=6, prompt_buckets=(32,),
                   prefill_chunk=8, chunk_steps=3, system_prefix=prefix)
    try:
        assert te.generate(tp, prompts) == je.generate(jp, prompts)
    finally:
        je.close()
        te.close()


def test_spec_engine_accepts_system_prefix(weights):
    """The speculative engine takes system_prefix (the prefix rides both
    prefills) and keeps refusing prefix_cache."""
    jp, tp = weights
    jcfg, cfg = _configs()
    kw = dict(speculate_k=2, slots=2, max_new_tokens=6, prompt_buckets=(16,), chunk_steps=2,
              system_prefix=[5, 9, 13])
    je = JEngine(JLlama(jcfg), draft_module=JLlama(jcfg), registry=jtelemetry.MetricsRegistry(),
                 **kw)
    te = DecodeEngine(Llama(cfg), draft_module=Llama(cfg), device="cpu",
                      registry=telemetry.MetricsRegistry(), **kw)
    try:
        assert te.prefix_cache is None
        prompt = [1, 2, 3, 4, 5]
        got = te.generate({"target": tp, "draft": tp}, [prompt])[0]
        assert got == je.generate({"target": jp, "draft": jp}, [prompt])[0]
        assert got == _jax_solo(jcfg, jp, [5, 9, 13] + prompt, 6, te.cache_len)
    finally:
        je.close()
        te.close()
    with pytest.raises(ValueError, match="prefix KV-cache"):
        DecodeEngine(Llama(cfg), draft_module=Llama(cfg), prefix_cache=True, device="cpu")


def test_engine_prefix_cache_eviction_stress(weights):
    """A byte budget of ~4 blocks against many distinct prompts: tokens
    equal the JAX engine's, the budget holds, blocks are evicted."""
    jp, tp = weights
    jcfg, cfg = _configs()
    je, te = _pair(jcfg, cfg, cache_block=8, slots=2, max_new_tokens=4, prompt_buckets=(32,),
                   chunk_steps=2)
    try:
        rng = np.random.default_rng(23)
        first = rng.integers(1, VOCAB, 16).tolist()
        assert te.generate(tp, [first]) == je.generate(jp, [first])
        _wait_for(lambda: te.prefix_cache.entries == 2, what="first insert")
        block_bytes = te.prefix_cache.bytes // te.prefix_cache.entries
        te.prefix_cache.max_bytes = 4 * block_bytes
        je.prefix_cache.max_bytes = 4 * (je.prefix_cache.bytes // max(1, je.prefix_cache.entries))
        shared = rng.integers(1, VOCAB, 8).tolist()
        prompts = [(shared if i % 3 == 0 else []) + rng.integers(1, VOCAB, int(n)).tolist()
                   for i, n in enumerate(rng.integers(9, 25, size=12))]
        for p in prompts:
            assert te.generate(tp, [p]) == je.generate(jp, [p])
            assert te.prefix_cache.bytes <= te.prefix_cache.max_bytes
        s = te.stats()["prefix_cache"]
        assert s["evictions"] > 0 and s["entries"] <= 4
        assert _saved(te) == _saved(je)
    finally:
        je.close()
        te.close()


def test_host_store_blocks_match_the_jax_engines(weights):
    """After one cold request both host stores hold the prompt's full
    blocks, in the same ``[1, block, heads, dim]`` layout, within 1e-5."""
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(29)
    prompt = rng.integers(1, VOCAB, 37).tolist()
    for paged in (False, True):
        je, te = _pair(jcfg, cfg, cache_block=8, slots=2, max_new_tokens=3,
                       prompt_buckets=(48,), chunk_steps=3, paged=paged)
        try:
            assert te.generate(tp, [prompt]) == je.generate(jp, [prompt])
            _wait_for(lambda: te.prefix_cache.entries == 4 and je.prefix_cache.entries == 4,
                      what="both inserts")
            jl, tl = je.prefix_cache.lease(prompt), te.prefix_cache.lease(prompt)
            try:
                assert jl.n_blocks == tl.n_blocks == 4
                for jrows, trows in zip(jl.rows, tl.rows):
                    assert packed_base(trows) is not None
                    for jlayer, tlayer in zip(jrows, trows):
                        for jbuf, tbuf in zip(jlayer, tlayer):
                            assert tuple(tbuf.shape) == tuple(jbuf.shape)
                            assert str(tbuf.dtype).removeprefix("torch.") == str(jbuf.dtype)
                            np.testing.assert_allclose(
                                tbuf.float().numpy(), np.asarray(jbuf, np.float32),
                                rtol=1e-5, atol=1e-5)
            finally:
                jl.release()
                tl.release()
        finally:
            je.close()
            te.close()


# --------------------------------------------------------------------- #
# the paged engine: cold / warm / partial, leases under pressure
# --------------------------------------------------------------------- #


def test_paged_prefix_cache_cold_warm_partial(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(2)
    shared = rng.integers(1, VOCAB, 32).tolist()
    p_cold = shared + rng.integers(1, VOCAB, 8).tolist()
    p_part = shared + rng.integers(1, VOCAB, 12).tolist()
    je, te = _pair(jcfg, cfg, cache_block=16, slots=2, max_new_tokens=6, prompt_buckets=(48,),
                   chunk_steps=3, paged=True)
    try:
        want, got = _in_turn(je, te, jp, tp, [p_cold, p_cold, p_part])
        assert got == want and got[0] == got[1]
        assert got[0] == _jax_solo(jcfg, jp, p_cold, 6, te.cache_len)
        pc = te.stats()["prefix_cache"]
        assert pc["hits"] + pc["partial_hits"] >= 2
        assert _saved(te) == _saved(je) > 0
        _assert_pool_drained(te)
    finally:
        je.close()
        te.close()


def test_lease_pinned_prefix_blocks_survive_pool_pressure(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    cache = RadixPrefixCache(block_size=16, max_bytes=64 << 10,
                             registry=telemetry.MetricsRegistry())
    engine = DecodeEngine(Llama(cfg), paged=True, slots=2, max_new_tokens=5,
                          prompt_buckets=(48,), chunk_steps=3, prefix_cache=cache,
                          device="cpu", registry=telemetry.MetricsRegistry())
    try:
        rng = np.random.default_rng(11)
        prompt = rng.integers(1, VOCAB, 32).tolist() + rng.integers(1, VOCAB, 8).tolist()
        cold = engine.generate(tp, [prompt])[0]
        lease = cache.match(prompt)
        assert lease.n_blocks >= 2
        for _ in range(12):
            engine.generate(tp, [rng.integers(1, VOCAB, 40).tolist()])
        assert cache.stats()["evictions"] > 0
        assert all(rows is not None for rows in lease.rows)
        lease.release()
        assert engine.generate(tp, [prompt])[0] == cold
        assert cold == _jax_solo(jcfg, jp, prompt, 5, engine.cache_len)
        _assert_pool_drained(engine)
    finally:
        engine.close()


def test_recovery_and_abandon_release_prefix_cache_leases(weights):
    """A poisoned batch whose requests hold leases (one a concurrently
    abandoned stream) releases every lease at recovery, and the cache
    still serves."""
    jp, tp = weights
    jcfg, cfg = _configs()
    fi = FaultInjector()
    cache = RadixPrefixCache(block_size=4, registry=telemetry.MetricsRegistry())
    engine = DecodeEngine(Llama(cfg), slots=2, max_new_tokens=32, prompt_buckets=(16,),
                          chunk_steps=2, fault_injector=fi, prefix_cache=cache, device="cpu",
                          registry=telemetry.MetricsRegistry())
    try:
        shared = list(range(1, 13))
        engine.generate(tp, [shared + [20]])
        _wait_for(lambda: cache.refcounts() == 0, what="seed leases released")
        assert cache.entries > 0
        stream = engine.generate_stream(tp, shared + [21])
        next(iter(stream))
        res = {}

        def run_b():
            try:
                res["b"] = engine.generate(tp, [shared + [22]])[0]
            except BaseException as exc:
                res["b"] = exc

        t = threading.Thread(target=run_b)
        t.start()
        _wait_for(lambda: sum(r is not None for r in engine._occupant) == 2, what="both resident")
        fi.arm("engine.dispatch", exc=xla_oom_error())
        stream.close()
        t.join(timeout=120)
        assert not t.is_alive()
        _wait_for(lambda: int(engine._m_recoveries.value) == 1, what="recovery")
        _wait_for(lambda: cache.refcounts() == 0, what="all leases released")
        out = engine.generate(tp, [shared + [23]])[0]
        assert out == _jax_solo(jcfg, jp, shared + [23], 32, engine.cache_len)
        _wait_for(lambda: cache.refcounts() == 0, what="post-check release")
    finally:
        engine.close()


# --------------------------------------------------------------------- #
# preemption
# --------------------------------------------------------------------- #


def _preempt_engine(cfg, **kw):
    registry = telemetry.MetricsRegistry()
    for key, value in dict(slots=2, max_new_tokens=48, prompt_buckets=(64,), chunk_steps=2,
                           pipeline_depth=2, kv_block_size=16, kv_pool_blocks=5).items():
        kw.setdefault(key, value)
    return DecodeEngine(Llama(cfg), paged=True, device="cpu", registry=registry,
                        prefix_cache=RadixPrefixCache(block_size=16, registry=registry), **kw)


def test_preempt_requires_prerequisites(weights):
    _, cfg = _configs()
    with pytest.raises(ValueError, match="preempt"):
        DecodeEngine(Llama(cfg), slots=1, max_new_tokens=4, prompt_buckets=(16,),
                     scheduler=SchedulerConfig(preempt=True), device="cpu",
                     registry=telemetry.MetricsRegistry())
    with pytest.raises(ValueError, match="preempt"):
        DecodeEngine(Llama(cfg), paged=True, slots=1, max_new_tokens=4, prompt_buckets=(16,),
                     scheduler=SchedulerConfig(preempt=True), device="cpu",
                     registry=telemetry.MetricsRegistry())
    engine = _preempt_engine(cfg)
    try:
        assert engine._preempt_enabled                  # on by default
    finally:
        engine.close()
    engine = _preempt_engine(cfg, scheduler=SchedulerConfig(preempt=False))
    try:
        assert not engine._preempt_enabled
    finally:
        engine.close()


def test_preempted_stream_resumes_with_token_parity(weights):
    """A low-priority mid-decode stream is evicted to the host store, the
    high-priority waiter admits, the victim resumes through the splice
    path — and both equal their uncontended runs of the JAX package."""
    jp, tp = weights
    jcfg, cfg = _configs()
    flight = telemetry.FlightRecorder()
    engine = _preempt_engine(cfg, flight=flight)
    try:
        rng = np.random.default_rng(0)
        low_prompt = rng.integers(1, VOCAB, 8).tolist()
        high_prompt = rng.integers(1, VOCAB, 8).tolist()
        low_out, low_err = [], []

        def low_client():
            try:
                for chunk in engine.generate_stream(tp, low_prompt, priority="low"):
                    low_out.extend(chunk)
            except BaseException as exc:
                low_err.append(exc)

        t = threading.Thread(target=low_client)
        t.start()
        _wait_for(lambda: bool(low_out), timeout=60, what="the low stream's first token")
        high_out = engine.generate(tp, [high_prompt], max_new_tokens=8, priority="high")[0]
        t.join(timeout=120)
        assert not t.is_alive() and not low_err
        assert high_out == _jax_solo(jcfg, jp, high_prompt, 8, engine.cache_len)
        assert low_out == _jax_solo(jcfg, jp, low_prompt, 48, engine.cache_len)
        assert engine.stats()["scheduler"]["preemptions"] >= 1
        kinds = [e["kind"] for e in flight.dump()]
        assert "preempt" in kinds and "resume" in kinds
        _assert_pool_drained(engine)
        _wait_for(lambda: engine.prefix_cache.refcounts() == 0, what="leases released")
    finally:
        engine.close()


def test_preemption_under_recovery_leaks_nothing(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    fi = FaultInjector()
    flight = telemetry.FlightRecorder()
    engine = _preempt_engine(cfg, flight=flight, fault_injector=fi)
    try:
        rng = np.random.default_rng(2)
        low_prompt = rng.integers(1, VOCAB, 8).tolist()
        high_prompt = rng.integers(1, VOCAB, 8).tolist()
        results, errors = [], []
        lock = threading.Lock()

        def client(prompt, priority, n):
            try:
                out = engine.generate(tp, [prompt], max_new_tokens=n, priority=priority)[0]
                with lock:
                    results.append((prompt, n, out))
            except Exception as exc:
                with lock:
                    errors.append(exc)

        t_low = threading.Thread(target=client, args=(low_prompt, "low", 48))
        t_low.start()
        _wait_for(lambda: any(e["kind"] == "decode" for e in flight.dump()), timeout=60,
                  what="a decode chunk")
        t_high = threading.Thread(target=client, args=(high_prompt, "high", 8))
        t_high.start()
        _wait_for(lambda: any(e["kind"] == "preempt" for e in flight.dump()), timeout=60,
                  what="a preemption")
        fi.arm("engine.dispatch", exc=xla_oom_error())
        t_low.join(timeout=120)
        t_high.join(timeout=120)
        assert not t_low.is_alive() and not t_high.is_alive()
        for prompt, n, out in results:
            assert out == _jax_solo(jcfg, jp, prompt, n, engine.cache_len)
        probe = rng.integers(1, VOCAB, 8).tolist()
        assert engine.generate(tp, [probe], max_new_tokens=8)[0] == _jax_solo(
            jcfg, jp, probe, 8, engine.cache_len)
        _assert_pool_drained(engine)
        _wait_for(lambda: engine.prefix_cache.refcounts() == 0, what="leases released")
    finally:
        engine.close()


# --------------------------------------------------------------------- #
# the KV handoff
# --------------------------------------------------------------------- #


def _handoff_engine(cfg, **kw):
    registry = telemetry.MetricsRegistry()
    kw.setdefault("prefix_cache", RadixPrefixCache(registry=registry))
    return DecodeEngine(Llama(cfg), paged=True, slots=2, max_new_tokens=8,
                        prompt_buckets=(48,), chunk_steps=4, device="cpu",
                        registry=registry, **kw)


def test_prefill_export_handle_and_lease(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    engine = _handoff_engine(cfg, phase="prefill")
    prompt = list(range(1, 21))
    try:
        handle = engine.prefill_export(tp, prompt)
        assert handle["tokens"] == _jax_solo(jcfg, jp, prompt, 1, engine.cache_len)
        assert handle["cached_tokens"] == 16 and handle["prompt"] == prompt
        assert engine.prefix_cache.peek(prompt) == 16
        assert engine.prefix_cache.refcounts() == 1     # the handle's lease
        handle["lease"].release()
        handle["lease"].release()
        assert engine.prefix_cache.refcounts() == 0
        entries = engine.kv_export(prompt)
        assert len(entries) == 1 and entries[0]["tokens"].tolist() == prompt[:16]
    finally:
        engine.close()


def test_prefill_export_requires_cache(weights):
    _, cfg = _configs()
    engine = DecodeEngine(Llama(cfg), slots=2, max_new_tokens=8, prompt_buckets=(48,),
                          chunk_steps=4, device="cpu", registry=telemetry.MetricsRegistry())
    try:
        for call in (lambda: engine.prefill_export({}, [1, 2, 3]),
                     lambda: engine.kv_export([1, 2, 3]), lambda: engine.kv_import([])):
            with pytest.raises(ValueError, match="prefix cache"):
                call()
    finally:
        engine.close()


def test_kv_handoff_between_engines_and_packages(weights):
    """Blocks exported by one engine import into another through the wire
    codecs, and the importer splices them (its tokens equal the JAX
    package's); entries exported by the JAX engine import into the port's
    too."""
    jp, tp = weights
    jcfg, cfg = _configs()
    prompt = list(range(1, 40))
    a, b, c = _handoff_engine(cfg), _handoff_engine(cfg), _handoff_engine(cfg)
    je = JEngine(JLlama(jcfg), paged=True, slots=2, max_new_tokens=8, prompt_buckets=(48,),
                 chunk_steps=4, prefix_cache=JCache(registry=jtelemetry.MetricsRegistry()),
                 registry=jtelemetry.MetricsRegistry())
    try:
        a.prefill_export(tp, prompt)["lease"].release()
        wire = encode_entries(a.kv_export(prompt))
        assert b.kv_import(decode_entries(wire)) == 2
        assert b.prefix_cache.peek(prompt) == 32
        want = je.generate(jp, [prompt])[0]
        assert b.generate(tp, [prompt])[0] == want
        assert _saved(b) == 32
        # the JAX engine's own export, through its codec, into the port
        je.prefill_export(jp, prompt)["lease"].release()
        from unionml_tpu.serving.prefix_cache import encode_entries as jencode

        assert c.kv_import(decode_entries(jencode(je.kv_export(prompt)))) == 2
        assert c.generate(tp, [prompt])[0] == want and _saved(c) == 32
    finally:
        for e in (a, b, c, je):
            e.close()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _engine_app(engine, params, *, wired=True):
    import unionml_tpu_torch
    from unionml_tpu_torch import ModelArtifact

    dataset = unionml_tpu_torch.Dataset(name="prefix_dataset")

    @dataset.reader
    def reader() -> list:
        return [[1, 2, 3]]

    @dataset.feature_loader
    def feature_loader(raw: list) -> list:
        return raw

    model = unionml_tpu_torch.Model(name="prefix_llm", dataset=dataset)

    @model.init
    def init(hyperparameters: dict) -> dict:
        return params

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    model.artifact = ModelArtifact(params)
    hooks = dict(kv_export=engine.kv_export, kv_import=engine.kv_import) if wired else {}
    return ServingApp(model, batch=False, health=engine.health, stats=engine.stats,
                      registry=engine.registry, **hooks)


def test_kv_export_import_http_roundtrip(weights):
    """The cross-host handoff wire: blocks exported from app A over POST
    /debug/kv/export import into app B over POST /debug/kv/import bit for
    bit, after which B's peek covers the prompt and B splices them; an
    unwired app and a malformed body answer 422."""
    jp, tp = weights
    jcfg, cfg = _configs()
    a, b = _handoff_engine(cfg, phase="prefill"), _handoff_engine(cfg, phase="decode")
    apps = [_engine_app(a, tp), _engine_app(b, tp), _engine_app(b, tp, wired=False)]
    bases = []
    for app in apps:
        host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
        bases.append(f"http://{host}:{port}")
    prompt = list(range(1, 21))
    try:
        a.prefill_export(tp, prompt)["lease"].release()
        status, body = _post(bases[0], "/debug/kv/export", {"prompt": prompt})
        assert status == 200 and body["blocks"] == 1
        for orig, back in zip(a.kv_export(prompt), decode_entries(body["entries"])):
            assert np.array_equal(orig["tokens"], back["tokens"])
            for lo, lb in zip(orig["rows"], back["rows"]):
                for bo, bb in zip(lo, lb):
                    assert bo.dtype == bb.dtype and torch.equal(bo.view(torch.int16),
                                                                bb.view(torch.int16))
        status, got = _post(bases[1], "/debug/kv/import", {"entries": body["entries"]})
        assert status == 200 and got["attached"] == 1
        assert b.prefix_cache.peek(prompt) == 16
        assert b.generate(tp, [prompt])[0] == _jax_solo(jcfg, jp, prompt, 8, b.cache_len)
        assert _saved(b) == 16
        assert _post(bases[0], "/debug/kv/export", {"prompt": []})[0] == 422
        assert _post(bases[0], "/debug/kv/import", {"entries": "x"})[0] == 422
        assert _post(bases[1], "/debug/kv/import", {"entries": [{"tokens": [1]}]})[0] == 422
        assert _post(bases[2], "/debug/kv/export", {"prompt": prompt})[0] == 422
    finally:
        for app in apps:
            app.shutdown()
        a.close()
        b.close()


# --------------------------------------------------------------------- #
# the micro-batcher path: make_generator(prefix_len) and the predictor
# --------------------------------------------------------------------- #


def test_prefix_cache_matches_concatenated_generation(weights):
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(6)
    prefix = rng.integers(1, VOCAB, 10).tolist()
    prompts = rng.integers(1, VOCAB, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), bool)
    mask[0, :2] = False
    jg = jgen.make_generator(JLlama(jcfg), max_new_tokens=5, max_len=64, prefix_len=10)
    g = gen.make_generator(Llama(cfg), max_new_tokens=5, max_len=64, prefix_len=10)
    for chunk in (None, 4):
        jpc = jgen.make_prefix_cache(JLlama(jcfg), jp, prefix, max_len=64, prefill_chunk=chunk)
        pc = gen.make_prefix_cache(Llama(cfg), tp, prefix, max_len=64, prefill_chunk=chunk)
        for m in (None, mask):
            want = np.asarray(jg(jp, jnp.asarray(prompts), None,
                                 None if m is None else jnp.asarray(m), prefix_cache=jpc))
            got = g(tp, torch.from_numpy(prompts), None,
                    None if m is None else torch.from_numpy(m), prefix_cache=pc).numpy()
            np.testing.assert_array_equal(got, want)
    # and the prefixed run equals prepending the prefix
    plain = gen.make_generator(Llama(cfg), max_new_tokens=5, max_len=64)
    cat = np.concatenate([np.tile(prefix, (2, 1)), prompts], axis=1)
    np.testing.assert_array_equal(
        plain(tp, torch.from_numpy(cat)).numpy(),
        g(tp, torch.from_numpy(prompts), prefix_cache=pc).numpy())


def test_prefix_cache_validations(weights):
    _, tp = weights
    _, cfg = _configs()
    g = gen.make_generator(Llama(cfg), max_new_tokens=2, max_len=32, prefix_len=4)
    with pytest.raises(ValueError, match="prefix_cache must be passed"):
        g(tp, torch.zeros((1, 4), dtype=torch.long))
    plain = gen.make_generator(Llama(cfg), max_new_tokens=2, max_len=32)
    pc = gen.make_prefix_cache(Llama(cfg), tp, [1, 2, 3, 4], max_len=32)
    with pytest.raises(ValueError, match="prefix_cache must be passed"):
        plain(tp, torch.zeros((1, 4), dtype=torch.long), None, None, pc)
    with pytest.raises(TypeError, match="make_prefix_cache"):
        g(tp, torch.zeros((1, 4), dtype=torch.long), prefix_cache=object())
    with pytest.raises(ValueError, match="built for"):
        g(tp, torch.zeros((1, 4), dtype=torch.long),
          prefix_cache=gen.make_prefix_cache(Llama(cfg), tp, [1, 2, 3], max_len=32))
    with pytest.raises(ValueError, match="no cache room"):
        gen.make_prefix_cache(Llama(cfg), tp, list(range(1, 33)), max_len=32)
    with pytest.raises(ValueError, match="non-empty"):
        gen.make_lm_predictor(Llama(cfg), system_prefix=[])


def test_lm_predictor_system_prefix(weights, monkeypatch):
    """Per-row outputs equal the JAX predictor's and prepending the
    prefix; the prefix cache is built once per (state, bucket) and rebuilt
    for a new state object."""
    jp, tp = weights
    jcfg, cfg = _configs()
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, VOCAB, 8).tolist()
    calls = []
    real = gen.make_prefix_cache

    def spy(*args, **kwargs):
        calls.append(kwargs.get("max_len"))
        return real(*args, **kwargs)

    monkeypatch.setattr(gen, "make_prefix_cache", spy)
    kw = dict(max_new_tokens=3, bucket_lens=(8, 16), max_len=64, system_prefix=prefix)
    pred = gen.make_lm_predictor(Llama(cfg), **kw)
    jpred = jgen.make_lm_predictor(JLlama(jcfg), **kw)
    rows = [[5, 6, 7], [9, 10, 11, 12]]
    out = pred(tp, rows)
    out2 = pred(tp, [[5, 6, 7]])
    assert len(calls) == 1                      # memoized per (state, bucket)
    assert out == jpred(jp, rows) and out2[0] == out[0]
    full = gen.make_generator(Llama(cfg), max_new_tokens=3, max_len=64)
    for row, prompt in zip(out, rows):
        assert row == full(tp, torch.tensor([prefix + prompt])).tolist()[0]
    pred(tp, rows)                              # the same state object
    assert len(calls) == 1
    pred(dict(tp), rows)                        # a new state object rebuilds
    assert len(calls) == 2


# --------------------------------------------------------------------- #
# the chip_smoke prefix phase, rehearsed
# --------------------------------------------------------------------- #


def _chip_smoke():
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    return chip_smoke


def test_chip_smoke_prefix_phase_rehearsal_on_cpu():
    """chip_smoke.py's prefix phase at a tiny config on the CPU (the
    kernels' plain versions): the traffic fills the pool, tokens saved
    equal what the prompt lengths imply, the splice-bit check holds and
    catches its planted faults, leases back at 0; the int8-KV splice bits
    and the fp32 parity / preemption phase too."""
    smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(vocab_size=VOCAB)
    out = smoke.prefix_phase(
        cfg, 4, device="cpu", slots=4, buckets=(16, 64), chunk_steps=2, system_tokens=32,
        pool_blocks=8, conversations=2, turns=3, turn_lengths=(3, 12), one_shots=3,
        one_shot_lengths=(2, 20), pairs=2,
    )
    assert out["prefill_tokens_saved"] == out["expected_tokens_saved"] > 0
    assert out["pool_pressure_events"] > 0 and out["leases_after"] == 0
    assert out["pinned_blocks"] == 2 and out["host_syncs"] == 0
    assert out["warm_cold_logit_cosine"] > smoke.LOGIT_COSINE_MIN
    assert all(n > 0 for n in out["splice_bits"]["faults_caught"].values())
    params = smoke.build_template(smoke.serving_config(cfg), 4, (16,), "cpu")[1]
    quant = smoke.prefix_kv_quant_check(cfg, params, device="cpu", layers=1, buckets=(16, 64))
    assert quant["buffers_per_block"] == 4
    fp32 = smoke.prefix_fp32_parity_phase(
        cfg, 4, device="cpu", layers=2, buckets=(16, 64), shared=(20, 33), per_group=3,
        suffix=(2, 20), preempt_prompt=20, preempt_new_tokens=30,
    )
    assert fp32["match"] == "6/6" and fp32["preemptions"] >= 1


def test_splice_bit_check_rejects_planted_faults():
    """The splice-bit check on fabricated rows: equal rows pass, a unit
    one unit off and two swapped units fail, a flipped bit in a scale
    plane fails."""
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    host = [(((torch.randn(1, 16, 2, 4, generator=g)).to(torch.bfloat16),
              torch.rand(1, 16, 2, generator=g)),) for _ in range(3)]
    rows = smoke.host_store_rows(host)
    assert smoke.splice_bit_mismatches([[b.clone() for b in layer] for layer in rows], rows) == []
    for fault, bad in smoke.splice_faults(rows).items():
        assert smoke.splice_bit_mismatches(bad, rows), fault
    flipped = [[b.clone() for b in layer] for layer in rows]
    flipped[0][1].view(torch.int32)[2, 5, 1] ^= 1
    assert smoke.splice_bit_mismatches(flipped, rows) == [2]
