"""The port's decode engine, paged layers and int8 KV cache against the JAX
package's, on the CPU.

The JAX model's weights (random, from a JAX key) reach the port through
``from_jax_params``; everything runs at ``LlamaConfig.tiny`` sizes in
fp32 with the default bf16 KV cache, where greedy decoding has no
near-tie flips, so tokens must be identical: the port's ``DecodeEngine``
(contiguous and block-paged) against the JAX ``DecodeEngine`` on the same
prompts and weights, or against the JAX solo generator sized to the
engine's cache (``max_len=engine.cache_len``). Logits and written cache
rows are compared at fp32 tolerance (the same products in another
summation order).
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.models.generate import make_lm_predictor as jmake_lm_predictor
from unionml_tpu.models.llama import init_cache as jinit_cache
from unionml_tpu.serving.engine import DecodeEngine as JEngine

import unionml_tpu_torch
from unionml_tpu_torch import ModelArtifact, _graphs, telemetry
from unionml_tpu_torch.models import (
    Llama,
    LlamaConfig,
    from_jax_params,
    init_cache,
    make_generator,
    make_lm_predictor,
)
from unionml_tpu_torch.serving import DecodeEngine, FaultInjector, Overloaded, ServingApp
from unionml_tpu_torch.serving.scheduler import SchedulerConfig

import torch_threads

torch_threads.share_cores()

VOCAB = 97
FP32 = dict(rtol=1e-4, atol=1e-4)


def _configs(**overrides):
    kw = dict(vocab_size=VOCAB, dtype="float32", **overrides)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _configs()
    jp = JLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).tolist() for n in lengths]


def _engine(cfg, **kw):
    kw.setdefault("registry", telemetry.MetricsRegistry())
    return DecodeEngine(Llama(cfg), device="cpu", **kw)


def _jax_engine_tokens(jcfg, jparams, prompts, **kw):
    engine = JEngine(JLlama(jcfg), registry=jtelemetry.MetricsRegistry(), **kw)
    try:
        return engine.generate(jparams, prompts)
    finally:
        engine.close()


def _jax_solo(jcfg, jparams, prompt, n_new, max_len):
    gen = jmake_generator(JLlama(jcfg), max_new_tokens=n_new, max_len=max_len)
    return np.asarray(gen(jparams, jnp.asarray([prompt], jnp.int32)))[0].tolist()


def _assert_pool_drained(engine, timeout=30.0):
    """``unionml_kv_pool_*`` back to baseline (deferred frees land a beat
    after the waiter wakes)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = engine.stats()["kv_pool"]
        if st["blocks_in_use"] == 0 and st["blocks_reserved"] == 0:
            return st
        time.sleep(0.02)
    raise AssertionError(f"kv pool leaked blocks: {engine.stats()['kv_pool']}")


# --------------------------------------------------------------------- #
# layers: the paged decode step and the int8 KV cache
# --------------------------------------------------------------------- #


def test_int8_kv_prefill_and_decode_match_jax(weights):
    """kv_quant: left-padded prefill into the int8 cache, then one decode
    step with per-row fills; logits and every written cache buffer."""
    jp, _ = weights
    jcfg, cfg = _configs(kv_quant=True)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(1, VOCAB, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), bool)
    mask[1, :4] = False
    pos = np.maximum(np.arange(10)[None] - (10 - mask.sum(1))[:, None], 0).astype(np.int32)
    kv_mask = np.concatenate([mask, np.ones((2, 6), bool)], axis=1)
    jl, jc = JLlama(jcfg).apply(
        {"params": jp}, jnp.asarray(toks), positions=jnp.asarray(pos),
        cache=jinit_cache(jcfg, 2, 16), cache_index=jnp.int32(0), kv_mask=jnp.asarray(kv_mask),
    )
    fills = np.array([10, 10], np.int32)
    step = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl2, jc = JLlama(jcfg).apply(
        {"params": jp}, jnp.asarray(step), cache=jc, cache_index=jnp.asarray(fills),
        kv_mask=jnp.asarray(kv_mask),
    )
    with torch.inference_mode():
        tl, tc = Llama(cfg)(
            port, torch.from_numpy(toks), positions=torch.from_numpy(pos),
            cache=init_cache(cfg, 2, 16, device="cpu"), cache_index=0,
            kv_mask=torch.from_numpy(kv_mask),
        )
        tl2, tc = Llama(cfg)(
            port, torch.from_numpy(step), cache=tc, cache_index=torch.from_numpy(fills),
            kv_mask=torch.from_numpy(kv_mask),
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **FP32)
    for jlayer, tlayer in zip(jc, tc):
        assert tlayer[0].dtype == torch.int8 and tlayer[2].dtype == torch.float32
        for jbuf, tbuf in zip(jlayer, tlayer):
            want = np.asarray(jbuf).astype(np.float32)
            got = tbuf.float().numpy()
            if tbuf.dtype == torch.int8:  # one rounding step at most
                assert np.abs(got - want).max() <= 1
                assert np.mean(got == want) > 0.99
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_decode_step_matches_jax(weights, kv_quant):
    """One ``block_table=`` decode step over a pool: ragged fills (one on
    a block edge), a dead row parked on the trash block, shuffled block
    ids. Logits and the pool rows the step wrote."""
    jp, _ = weights
    jcfg, cfg = _configs(kv_quant=kv_quant)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(2)
    n_blocks, blk, width = 10, 8, 3
    jpool = jinit_cache(jcfg, n_blocks, blk)
    tpool = init_cache(cfg, n_blocks, blk, device="cpu")
    # fill the pools with the same random rows (quantized forms: ints + scales)
    filled = []
    for jl_, tl_ in zip(jpool, tpool):
        bufs = []
        for jb, tb in zip(jl_, tl_):
            if tb.dtype == torch.int8:
                a = rng.integers(-127, 128, tb.shape).astype(np.int8)
            elif kv_quant:
                a = (rng.random(tb.shape) * 0.02 + 1e-3).astype(np.float32)
            else:
                a = rng.standard_normal(tb.shape).astype(np.float32)
            tb.copy_(torch.from_numpy(a))
            bufs.append(jnp.asarray(a, jb.dtype))
        filled.append(tuple(bufs))
    jpool = tuple(filled)
    table = np.array([[3, 7, 0], [5, 0, 0], [0, 0, 0], [9, 2, 6]], np.int32)
    fills = np.array([12, 7, 0, 16], np.int32)
    toks = rng.integers(1, VOCAB, size=(4, 1)).astype(np.int32)
    jl, jc = JLlama(jcfg).apply(
        {"params": jp}, jnp.asarray(toks), cache=jpool, cache_index=jnp.asarray(fills),
        block_table=jnp.asarray(table),
    )
    with torch.inference_mode():
        tl, tc = Llama(cfg)(
            port, torch.from_numpy(toks), cache=tpool, cache_index=torch.from_numpy(fills),
            block_table=torch.from_numpy(table),
        )
    np.testing.assert_allclose(tl[[0, 1, 3]].numpy(), np.asarray(jl)[[0, 1, 3]], **FP32)
    for b in (0, 1, 3):  # the written rows (row 2 wrote the trash block)
        pid, off = table[b, fills[b] // blk], fills[b] % blk
        for jbuf, tbuf in zip(jc[0], tc[0]):
            got, want = tbuf[pid, off].float().numpy(), np.asarray(jbuf[pid, off]).astype(np.float32)
            tol = 1 if tbuf.dtype == torch.int8 else 1e-5
            assert np.abs(got - want).max() <= tol


def test_paged_layer_rejects_prefill_shapes(weights):
    _, port = weights
    _, cfg = _configs()
    pool = init_cache(cfg, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="decode steps only"):
        Llama(cfg)(port, torch.ones(1, 3, dtype=torch.long), cache=pool,
                   cache_index=torch.zeros(1, dtype=torch.int32),
                   block_table=torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_mask"):
        Llama(cfg)(port, torch.ones(1, 1, dtype=torch.long), cache=pool,
                   cache_index=torch.zeros(1, dtype=torch.int32),
                   kv_mask=torch.ones(1, 16, dtype=torch.bool),
                   block_table=torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_quant"):
        init_cache(LlamaConfig.tiny(kv_quant=True), 1, 8, dtype=torch.float32, device="cpu")


def test_generator_and_predictor_with_int8_kv_match_jax(weights):
    """make_generator and make_lm_predictor with kv_quant=True (the
    engine parity tests' oracles) give the JAX package's greedy tokens."""
    jp, _ = weights
    jcfg, cfg = _configs(kv_quant=True)
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(3).integers(1, VOCAB, size=(2, 9)).astype(np.int32)
    want = np.asarray(jmake_generator(JLlama(jcfg), max_new_tokens=6, max_len=32)(jp, jnp.asarray(toks)))
    got = make_generator(Llama(cfg), max_new_tokens=6, max_len=32)(port, toks)
    assert got.tolist() == want.tolist()
    prompts = _prompts(4, (3, 11, 20))
    kw = dict(max_new_tokens=5, bucket_lens=(8, 16, 32))
    assert make_lm_predictor(Llama(cfg), **kw)(port, prompts) == [
        list(map(int, r)) for r in jmake_lm_predictor(JLlama(jcfg), **kw)(jp, prompts)
    ]


# --------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("knobs", [{}, dict(prefill_impl="flash", norm_impl="fused")])
def test_engine_matches_jax_engine(weights, paged, knobs):
    """A monolithic admission per bucket, four slots, more prompts than
    slots (slot reuse), with and without the flash prefill and fused norm
    (the kernels' plain versions on the CPU)."""
    jp, tp = weights
    jcfg, cfg = _configs(**knobs)
    prompts = _prompts(0, (5, 8, 11, 16, 3, 9))
    kw = dict(slots=4, max_new_tokens=8, prompt_buckets=(8, 16), chunk_steps=4, paged=paged)
    engine = _engine(cfg, **kw)
    try:
        got = engine.generate(tp, prompts)
        if paged:
            st = _assert_pool_drained(engine)
            assert st["allocated_blocks"] == st["freed_blocks"] > 0
        stats = engine.stats()
    finally:
        engine.close()
    assert got == _jax_engine_tokens(jcfg, jp, prompts, **kw)
    assert stats["completed_requests"] == 6 and 0 < stats["slot_occupancy"] <= 1
    assert stats["programs"]["engine.decode"]["calls"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_and_eos_match_jax_engine(weights, paged):
    """Buckets above ``prefill_chunk`` admit via lead-chunk programs (a
    short prompt in the long bucket, exact multiples, ragged tails); an
    eos retires slots mid-chunk."""
    jp, tp = weights
    jcfg, cfg = _configs()
    prompts = _prompts(11, (5, 9, 16, 33, 64, 7))
    kw = dict(slots=3, max_new_tokens=10, prompt_buckets=(8, 64), prefill_chunk=16,
              chunk_steps=4, eos_id=11, paged=paged)
    engine = _engine(cfg, **kw)
    try:
        got = engine.generate(tp, prompts)
        if paged:
            _assert_pool_drained(engine)
    finally:
        engine.close()
    assert got == _jax_engine_tokens(jcfg, jp, prompts, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_kv_engine_matches_jax_engine(weights, paged):
    jp, _ = weights
    jcfg, cfg = _configs(kv_quant=True)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    prompts = _prompts(4, (7, 12, 16, 30))
    kw = dict(slots=2, max_new_tokens=6, prompt_buckets=(16, 32), prefill_chunk=16,
              chunk_steps=3, paged=paged)
    engine = _engine(cfg, **kw)
    try:
        got = engine.generate(tp, prompts)
    finally:
        engine.close()
    assert got == _jax_engine_tokens(jcfg, jp, prompts, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_mid_decode_join_and_budgets_match_jax_solo(weights, paged):
    """A request submitted while another is mid-decode joins at a chunk
    boundary; per-request budgets cap the tokens. Each equals its JAX
    solo run sized to the engine's cache."""
    jp, tp = weights
    jcfg, cfg = _configs()
    engine = _engine(cfg, slots=2, max_new_tokens=24, prompt_buckets=(8,), chunk_steps=2,
                     paged=paged, kv_block_size=8)
    try:
        p1, p2, p3 = _prompts(1, (8, 6, 5))
        results = {}

        def run(name, prompt, delay, n):
            time.sleep(delay)
            results[name] = engine.generate(tp, [prompt], max_new_tokens=n)[0]

        threads = [threading.Thread(target=run, args=("a", p1, 0.0, 24)),
                   threading.Thread(target=run, args=("b", p2, 0.05, 24)),
                   threading.Thread(target=run, args=("c", p3, 0.02, 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.generate(tp, [p1], max_new_tokens=99)
        L = engine.cache_len
        if paged:
            st = _assert_pool_drained(engine)
            assert st["allocated_blocks"] >= 4  # the table grew past the prompt
    finally:
        engine.close()
    assert results["a"] == _jax_solo(jcfg, jp, p1, 24, L)
    assert results["b"] == _jax_solo(jcfg, jp, p2, 24, L)
    assert results["c"] == _jax_solo(jcfg, jp, p3, 3, L)


def test_stream_matches_generate_and_disconnect_frees_blocks(weights):
    """``generate_stream`` chunks concatenate to ``generate``'s tokens; a
    consumer that stops early frees its slot and its pool blocks."""
    _, tp = weights
    _, cfg = _configs()
    engine = _engine(cfg, slots=1, max_new_tokens=12, prompt_buckets=(8,), chunk_steps=3,
                     paged=True)
    try:
        prompt = [4, 5, 6, 7]
        chunks = list(engine.generate_stream(tp, prompt))
        assert len(chunks[0]) == 1 and all(len(c) <= 3 for c in chunks[1:])
        assert sum(chunks, []) == engine.generate(tp, [prompt])[0]
        stream = engine.generate_stream(tp, [1, 2, 3])
        next(stream)
        stream.close()
        _assert_pool_drained(engine)
        assert len(engine.generate(tp, [[4, 5]], max_new_tokens=4)[0]) == 4
    finally:
        engine.close()


def test_pool_pressure_parks_sheds_and_rejects(weights):
    """A pool that fits one resident request parks the others until
    blocks free (all complete, solo-identical); the backlog behind the
    parked head sheds through max_queue_depth; a request that can never
    fit is rejected at submit."""
    jp, tp = weights
    jcfg, cfg = _configs()
    engine = _engine(cfg, slots=4, max_new_tokens=8, prompt_buckets=(16,), chunk_steps=4,
                     paged=True, kv_pool_blocks=3, max_queue_depth=3)
    try:
        prompts = _prompts(6, (9,) * 3)
        shed, done = [], []

        def client(p):
            try:
                done.append((p, engine.generate(tp, [p])[0]))
            except Overloaded:
                shed.append(p)

        threads = [threading.Thread(target=client, args=(p,)) for p in prompts * 3]
        for t in threads:
            t.start()
            time.sleep(0.002)
        for t in threads:
            t.join(timeout=120)
        assert done and shed
        L = engine.cache_len
        assert engine.stats()["kv_pool"]["alloc_failures"] > 0
        _assert_pool_drained(engine)
    finally:
        engine.close()
    tiny_pool = _engine(cfg, slots=2, max_new_tokens=8, prompt_buckets=(16,), chunk_steps=4,
                        paged=True, kv_pool_blocks=2)  # capacity: one block
    try:
        with pytest.raises(Overloaded, match="never fit"):
            tiny_pool.generate(tp, [list(range(1, 16))])
        assert tiny_pool.stats()["robustness"]["rejected"]["pool_full"] == 1
    finally:
        tiny_pool.close()
    solos = {tuple(p): _jax_solo(jcfg, jp, p, 8, L) for p in prompts}
    assert all(out == solos[tuple(p)] for p, out in done)


def test_injected_fault_recovers_and_frees_the_pool(weights):
    """An injected dispatch fault fails the poisoned batch only; the pool
    resets with the rebuilt state and later requests decode correctly."""
    jp, tp = weights
    jcfg, cfg = _configs()
    faults = FaultInjector()
    engine = _engine(cfg, slots=2, max_new_tokens=6, prompt_buckets=(8,), chunk_steps=2,
                     paged=True, fault_injector=faults)
    try:
        faults.arm("engine.dispatch", exc=RuntimeError("injected"))
        with pytest.raises(RuntimeError, match="injected"):
            engine.generate(tp, [[1, 2, 3]])
        _assert_pool_drained(engine)
        prompt = [9, 8, 7, 6]
        assert engine.generate(tp, [prompt])[0] == _jax_solo(jcfg, jp, prompt, 6, engine.cache_len)
        assert engine.stats()["robustness"]["recoveries"] == 1
    finally:
        engine.close()


def test_temperature_sampling_statistics(weights):
    """Temperature sampling draws from the engine's seeded generator:
    tokens in range, budgets kept, the same seed repeats itself, and a
    near-zero temperature collapses onto the greedy tokens."""
    _, tp = weights
    _, cfg = _configs()
    prompt = list(range(1, 9))
    outs = []
    for seed, temp in ((3, 0.8), (3, 0.8), (4, 0.8), (0, 1e-4)):
        engine = _engine(cfg, slots=2, max_new_tokens=8, prompt_buckets=(8,),
                         chunk_steps=4, temperature=temp, seed=seed)
        try:
            outs.append(engine.generate(tp, [prompt, prompt]))
        finally:
            engine.close()
    assert all(len(o) == 8 and all(0 <= t < VOCAB for t in o) for r in outs for o in r)
    assert outs[0] == outs[1] and outs[0] != outs[2]
    greedy = _engine(cfg, slots=1, max_new_tokens=8, prompt_buckets=(8,), chunk_steps=4)
    try:
        assert outs[3] == greedy.generate(tp, [prompt, prompt])
    finally:
        greedy.close()


def test_bind_refuses_hot_swap_while_busy(weights):
    _, tp = weights
    _, cfg = _configs()
    engine = _engine(cfg, slots=1, max_new_tokens=64, prompt_buckets=(8,), chunk_steps=2)
    try:
        stream = engine.generate_stream(tp, [1, 2, 3])
        next(stream)
        with pytest.raises(RuntimeError, match="swap"):
            engine.bind(dict(tp))
        stream.close()
        assert engine.drain(timeout=30)
        engine.resume()
        engine.bind(dict(tp))
    finally:
        engine.close()


def test_unported_engine_options_raise(weights):
    """The options the port refuses, as the reference does: the
    speculative engine with the paged pool or the prefix cache,
    preemption without its prerequisites, a kv_block_size that contradicts
    the prefix cache, an empty system prefix, a cache past max_len."""
    _, cfg = _configs()
    module = Llama(cfg)
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(module, device="cpu", draft_module=module, paged=True)
    with pytest.raises(ValueError, match="prefix KV-cache"):
        DecodeEngine(module, device="cpu", draft_module=module, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix cache"):
        DecodeEngine(module, device="cpu", paged=True,
                     scheduler=SchedulerConfig(preempt=True))
    from unionml_tpu_torch.serving.prefix_cache import RadixPrefixCache

    with pytest.raises(ValueError, match="block_size"):
        DecodeEngine(module, device="cpu", paged=True, kv_block_size=8,
                     prefix_cache=RadixPrefixCache(block_size=16,
                                                   registry=telemetry.MetricsRegistry()))
    with pytest.raises(ValueError, match="non-empty"):
        DecodeEngine(module, device="cpu", system_prefix=[])
    engine = _engine(cfg, slots=1, max_new_tokens=2, prompt_buckets=(8,))
    try:
        for call in (engine.kv_export, engine.kv_import):
            with pytest.raises(ValueError, match="prefix cache"):
                call([1, 2])
    finally:
        engine.close()
    with pytest.raises(ValueError, match="max_len"):
        DecodeEngine(module, device="cpu", max_new_tokens=300, prompt_buckets=(64,))
    with pytest.raises(ValueError, match="slot"):
        DecodeEngine(module, device="cpu", slots=0)


# --------------------------------------------------------------------- #
# served over HTTP
# --------------------------------------------------------------------- #


def _serving_model(engine, params):
    dataset = unionml_tpu_torch.Dataset(name="engine_dataset")

    @dataset.reader
    def reader() -> list:
        return [[1, 2, 3]]

    @dataset.feature_loader
    def feature_loader(raw: list) -> list:
        return raw

    model = unionml_tpu_torch.Model(name="engine_llm", dataset=dataset)

    @model.init
    def init(hyperparameters: dict) -> dict:
        return params

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return engine.generate(params, prompts)

    model.artifact = ModelArtifact(params)
    return model


def test_serving_app_over_paged_engine_matches_jax(weights):
    """``ServingApp(batch=False)`` over the paged engine: ``/predict``
    equals the JAX engine's tokens, ``/predict/stream`` concatenates to
    the same, ``/health`` and ``/stats`` come from the engine and the
    pool's blocks in use are back at 0 in ``/metrics``."""
    jp, tp = weights
    jcfg, cfg = _configs()
    kw = dict(slots=2, max_new_tokens=6, prompt_buckets=(16,), chunk_steps=3, paged=True)
    registry = telemetry.MetricsRegistry()
    engine = _engine(cfg, registry=registry, **kw)
    prompts = _prompts(9, (3, 7, 12, 16))
    app = ServingApp(
        _serving_model(engine, tp), batch=False, health=engine.health, stats=engine.stats,
        stream=lambda params, features: engine.generate_stream(params, features[0]),
        usage=engine.usage, goodput=engine.goodput_report, registry=registry,
    )
    host, port = app.serve(host="127.0.0.1", port=0, blocking=False)
    base = f"http://{host}:{port}"
    try:
        req = urllib.request.Request(
            base + "/predict", data=json.dumps({"features": prompts}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())
        req = urllib.request.Request(
            base + "/predict/stream", data=json.dumps({"features": [prompts[1]]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            events = [json.loads(line[5:]) for line in resp.read().decode().splitlines()
                      if line.startswith("data:")]
        streamed = sum((e["tokens"] for e in events if "tokens" in e), [])
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        _assert_pool_drained(engine)
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
    finally:
        app.shutdown()
        engine.close()
    want = _jax_engine_tokens(jcfg, jp, prompts, **kw)
    assert got == want
    assert streamed == want[1]
    assert health["status"] == "ok" and stats["engine"] == "continuous"
    in_use = [line for line in metrics.splitlines()
              if line.startswith("unionml_kv_pool_blocks_in_use{")]
    assert in_use and all(float(line.rsplit(" ", 1)[1]) == 0.0 for line in in_use)


def test_chip_smoke_engine_phases_rehearsal_on_cpu():
    """chip_smoke.py's engine, int8-KV and fp32 phases at a tiny config on the
    CPU (the kernels' plain versions), as the script drives them on the
    card."""
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    cfg = LlamaConfig.tiny(vocab_size=VOCAB)
    out = chip_smoke.engine_phase(
        cfg, 4, device="cpu", slots=4, buckets=(8, 16, 32), chunk_steps=2, waves=2,
        lengths=(3, 7, 20, 30, 5, 12),
    )
    assert out["requests"] == 7 and out["paged_logit_cosine"] > chip_smoke.LOGIT_COSINE_MIN
    params = chip_smoke.build_template(chip_smoke.serving_config(cfg), 4, (8,), "cpu")[1]
    assert chip_smoke.kv_quant_phase(
        cfg, params, 4, device="cpu", layers=1, buckets=(8, 16)
    )["requests"] == 5
    out = chip_smoke.fp32_parity_phase(
        cfg, 4, device="cpu", layers=2, buckets=(8, 32), lengths=(3, 20, 9)
    )
    assert out["match"] == "3/3"


def test_closed_engine_drops_its_bound_weights(weights):
    """``close()`` releases the weights ``bind()`` took along with the
    device buffers: a reaped or rolled-back canary engine that something
    still references holds no version's weights."""
    _, tp = weights
    _, cfg = _configs()
    engine = _engine(cfg, slots=1, max_new_tokens=4, prompt_buckets=(8,), chunk_steps=2)
    # the card's program cache, its capture stubbed (a replay runs the body)
    engine._graphs.capturable = True

    def capture(body, *args, **kwargs):
        warm = body()
        return _graphs.Graph(types.SimpleNamespace(replay=body), warm, warm, {}, (0.0, 0.0))

    engine._graphs.capture = capture
    params = dict(tp)
    engine.bind(params)
    engine.generate(params, [[1, 2, 3]])
    assert engine._params is params and engine._state is not None
    assert len(engine._graphs) > 0 and engine._graphs.pool is not None
    engine.close()
    assert engine._params is None and engine._state is None
    # the compiled programs and their memory pool went with them
    assert len(engine._graphs) == 0 and engine._graphs.pool is None
