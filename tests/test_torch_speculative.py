"""The port's speculative decoding (generator, predictor, engine) against the
JAX package's, on the CPU.

A target and an unrelated random draft (low acceptance), both JAX weights
carried over with ``from_jax_params``, in fp32: greedy speculation must
give exactly the JAX package's tokens — which equal plain greedy decoding
of the target — and the same acceptance statistics. The engine runs with
``draft_module`` behind the same greedy contract, over an fp and a packed
int4 target (per-channel and grouped; the verify rows ride the int4
kernel's plain version).
"""

import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.models.quantization import quantize_params as jquantize_params
from unionml_tpu.models.speculative import make_speculative_generator as jmake_spec
from unionml_tpu.serving.engine import DecodeEngine as JEngine

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    from_jax_params,
    make_generator,
    make_speculative_generator,
    make_speculative_predictor,
)
from unionml_tpu_torch.models.speculative import greedy_acceptance
from unionml_tpu_torch.serving import DecodeEngine

VOCAB = 97
DRAFT = dict(hidden_dim=32, num_layers=1, num_heads=2, num_kv_heads=1, mlp_dim=64)


def _cfgs(**over):
    kw = dict(vocab_size=VOCAB, dtype="float32", **over)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


@pytest.fixture(scope="module")
def pair():
    (jt, t), (jd, d) = _cfgs(), _cfgs(**DRAFT)
    jtp = JLlama(jt).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jdp = JLlama(jd).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]

    def port(tree, cfg):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")

    return dict(jt=jt, jd=jd, t=t, d=d, jtp=jtp, jdp=jdp, tp=port(jtp, t), dp=port(jdp, d))


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(1, VOCAB, size=shape).astype(np.int32)


def _plain(t, tp, prompts, n_new, max_len=128, eos_id=None):
    gen = make_generator(Llama(t), max_new_tokens=n_new, max_len=max_len, eos_id=eos_id)
    return gen(tp, prompts).tolist()


def _verify_and_steps(cfg, params, device, prompt_len=32):
    """One speculative round's two sides over 8 slots with their own fills
    (below ``prompt_len``): the target's multi-token verify of k + 1
    tokens, and the same tokens fed one at a time as a draft's decode steps
    (the engine's masks). Returns (verify logits, step logits), each [8,
    k + 1, vocab]."""
    from unionml_tpu_torch.models.llama import init_cache

    module = Llama(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    b, k = 8, 4
    length = prompt_len + 2 * k
    cache = init_cache(cfg, b, length, device=device)
    prompt = torch.randint(1, cfg.vocab_size, (b, prompt_len), generator=gen, device=device)
    with torch.inference_mode():
        _, cache = module(params, prompt, cache=cache, cache_index=0)
        fills = torch.tensor([prompt_len * f // 20 for f in (2, 11, 6, 19, 3, 8, 13, 5)],
                             dtype=torch.int32, device=device)
        rows = torch.arange(length, device=device)[None, :]
        kv_mask = rows < fills[:, None]
        tokens = torch.randint(1, cfg.vocab_size, (b, k + 1), generator=gen, device=device)

        def copy(c):
            return tuple(tuple(buf.clone() for buf in layer) for layer in c)

        def vis(last):
            return kv_mask | ((rows >= fills[:, None]) & (rows <= (fills + last)[:, None]))

        verify, _ = module(params, tokens, cache=copy(cache), cache_index=fills, kv_mask=vis(k))
        steps, c = [], copy(cache)
        for i in range(k + 1):
            logits, c = module(params, tokens[:, i:i + 1], cache=c, cache_index=fills + i,
                               kv_mask=vis(i))
            steps.append(logits[:, -1])
    return verify, torch.stack(steps, dim=1)


def _jax_plain(jt, jtp, prompt, n_new, max_len):
    gen = jmake_generator(JLlama(jt), max_new_tokens=n_new, max_len=max_len)
    return np.asarray(gen(jtp, jnp.asarray([prompt], jnp.int32)))[0].tolist()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_rows_match_one_token_steps(kv_quant):
    """A speculative verify over 8 slots gives, row for row, the bits of
    the one-token decode steps of the same tokens (each verify row attends
    at a decode step's shapes), so a draft equal to the target has every
    proposal accepted whatever the batch."""
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, dtype="float32", kv_quant=kv_quant)
    from unionml_tpu_torch.models import init_params

    verify, steps = _verify_and_steps(cfg, init_params(cfg, device="cpu"), "cpu")
    assert torch.equal(verify, steps)


def test_greedy_acceptance_rule_matches_jax():
    from unionml_tpu.models.speculative import greedy_acceptance as jgreedy_acceptance

    props = np.array([[1, 2, 3], [1, 9, 3], [7, 2, 3], [1, 2, 5]], np.int32)
    greedy = np.array([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]], np.int32)
    got = greedy_acceptance(torch.from_numpy(props).long(), torch.from_numpy(greedy).long())
    want = jgreedy_acceptance(jnp.asarray(props), jnp.asarray(greedy))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    assert got[0].tolist() == [3, 1, 0, 2]


@pytest.mark.parametrize("k,self_draft", [(1, False), (3, False), (5, False), (4, True)])
def test_generator_matches_jax(pair, k, self_draft):
    """Tokens and per-row rounds/acceptance equal the JAX generator's for
    an unrelated draft and for self-speculation (full acceptance, no
    draft-cache hole across rounds)."""
    p = pair
    d, dp, jd_params = (p["t"], p["tp"], p["jtp"]) if self_draft else (p["d"], p["dp"], p["jdp"])
    jd = p["jt"] if self_draft else p["jd"]
    prompts = _prompts(k, (2, 6 + k))
    kw = dict(max_new_tokens=10, speculate_k=k, max_len=64, with_stats=True)
    got, stats = make_speculative_generator(Llama(p["t"]), Llama(d), **kw)(p["tp"], dp, prompts)
    jtoks, jstats = jmake_spec(JLlama(p["jt"]), JLlama(jd), **kw)(
        p["jtp"], jd_params, jnp.asarray(prompts)
    )
    assert got.tolist() == np.asarray(jtoks).tolist() == _plain(p["t"], p["tp"], prompts, 10)
    assert stats["rounds"].tolist() == np.asarray(jstats["rounds"]).tolist()
    assert stats["accepted"].tolist() == np.asarray(jstats["accepted"]).tolist()
    if self_draft:
        assert stats["rounds"].tolist() == [2, 2] and stats["accepted"].tolist() == [8, 8]


def test_eos_and_validation(pair):
    p = pair
    prompt = np.arange(1, 9, dtype=np.int32)[None]
    eos = _plain(p["t"], p["tp"], prompt, 8)[0][2]
    spec = make_speculative_generator(
        Llama(p["t"]), Llama(p["d"]), max_new_tokens=8, speculate_k=3, max_len=64,
        eos_id=eos, pad_id=0,
    )
    assert spec(p["tp"], p["dp"], prompt).tolist() == _plain(
        p["t"], p["tp"], prompt, 8, eos_id=eos
    )
    with pytest.raises(ValueError, match="vocabularies differ"):
        make_speculative_generator(Llama(p["t"]), Llama(LlamaConfig.tiny(vocab_size=64)),
                                   max_new_tokens=4)
    with pytest.raises(ValueError, match="speculate_k"):
        make_speculative_generator(Llama(p["t"]), Llama(p["d"]), max_new_tokens=4, speculate_k=0)


def test_predictor_buckets_pads_and_trims(pair):
    p = pair
    pred = make_speculative_predictor(
        Llama(p["t"]), Llama(p["d"]), max_new_tokens=6, bucket_lens=(8, 16), speculate_k=2
    )
    state = {"target": p["tp"], "draft": p["dp"]}
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 6, 7, 8]]
    out = pred(state, prompts)
    for prompt, got in zip(prompts, out):
        assert got == _plain(p["t"], p["tp"], np.asarray([prompt], np.int32), 6)[0]
    assert pred.warmup(state, max_batch=4) == 2 * 3
    with pytest.raises(ValueError, match="empty bucket tuple"):
        pred.warmup(state, buckets=())
    with pytest.raises(ValueError, match="mapping"):
        pred(p["tp"], prompts)
    with pytest.raises(ValueError, match="largest bucket"):
        pred(state, [list(range(40))])


def test_kv_quant_caches_match_plain(pair):
    p = pair
    qt = dataclasses.replace(p["t"], kv_quant=True)
    qd = dataclasses.replace(p["d"], kv_quant=True)
    prompts = _prompts(5, (2, 10))
    spec = make_speculative_generator(Llama(qt), Llama(qd), max_new_tokens=10, speculate_k=3,
                                      max_len=64)
    assert spec(p["tp"], p["dp"], prompts).tolist() == _plain(qt, p["tp"], prompts, 10)


# --------------------------------------------------------------------- #
# the speculative engine
# --------------------------------------------------------------------- #


def _engine(target_cfg, draft_cfg, **kw):
    kw.setdefault("registry", telemetry.MetricsRegistry())
    return DecodeEngine(Llama(target_cfg), draft_module=Llama(draft_cfg), device="cpu", **kw)


@pytest.mark.parametrize("knobs", [{}, dict(prefill_impl="flash")])
def test_engine_matches_jax_spec_engine(pair, knobs):
    """Three ragged prompts on three slots, k=3, with the target's cached
    or flash prefill: the JAX speculative engine's tokens (equal to plain
    greedy decoding of the target), and an acceptance rate in [0, 1]."""
    p = pair
    t = dataclasses.replace(p["t"], **knobs)
    jt = dataclasses.replace(p["jt"], **knobs)
    prompts = [_prompts(0, n).tolist() for n in (5, 8, 13)]
    kw = dict(speculate_k=3, slots=3, max_new_tokens=10, prompt_buckets=(8, 16), chunk_steps=2)
    engine = _engine(t, p["d"], **kw)
    try:
        got = engine.generate({"target": p["tp"], "draft": p["dp"]}, prompts)
        stats = engine.stats()
        L = engine.cache_len
    finally:
        engine.close()
    jengine = JEngine(JLlama(jt), draft_module=JLlama(p["jd"]),
                      registry=jtelemetry.MetricsRegistry(), **kw)
    try:
        want = jengine.generate({"target": p["jtp"], "draft": p["jdp"]}, prompts)
    finally:
        jengine.close()
    assert got == want
    assert got == [_plain(t, p["tp"], np.asarray([q], np.int32), 10, max_len=L)[0] for q in prompts]
    assert stats["speculative"]["rounds"] > 0
    assert 0.0 <= stats["speculative"]["acceptance_rate"] <= 1.0


def test_engine_self_speculation_stream_and_eos(pair):
    """Self-speculation accepts every proposal; the stream concatenates to
    the tokens (first chunk = the prefill token); an eos inside a round
    truncates exactly where plain greedy decoding stops."""
    p = pair
    both = {"target": p["tp"], "draft": p["tp"]}
    engine = _engine(p["t"], p["t"], speculate_k=3, slots=2, max_new_tokens=9,
                     prompt_buckets=(8,), chunk_steps=2)
    try:
        out = engine.generate(both, [[7, 3, 9, 2]])[0]
        chunks = list(engine.generate_stream(both, [7, 3, 9, 2]))
        L = engine.cache_len
        assert engine.stats()["speculative"]["acceptance_rate"] == 1.0
    finally:
        engine.close()
    assert out == _plain(p["t"], p["tp"], np.asarray([[7, 3, 9, 2]], np.int32), 9, max_len=L)[0]
    assert len(chunks[0]) == 1 and sum(chunks, []) == out
    plain = _plain(p["t"], p["tp"], np.asarray([[5, 3, 9, 2]], np.int32), 12)[0]
    eos = plain[3]
    engine = _engine(p["t"], p["d"], speculate_k=3, slots=2, max_new_tokens=12,
                     prompt_buckets=(8,), chunk_steps=2, eos_id=eos)
    try:
        got = engine.generate({"target": p["tp"], "draft": p["dp"]}, [[5, 3, 9, 2]])[0]
    finally:
        engine.close()
    assert got == plain[: plain.index(eos) + 1]


def test_engine_mid_decode_join_and_chunked_prefill(pair):
    """A request joining while another is mid-speculation, and buckets
    admitted in prefill_chunk programs through both caches."""
    import threading
    import time

    p = pair
    params = {"target": p["tp"], "draft": p["dp"]}
    engine = _engine(p["t"], p["d"], speculate_k=2, slots=2, max_new_tokens=12,
                     prompt_buckets=(8, 32), prefill_chunk=8, chunk_steps=2, pipeline_depth=2)
    try:
        p1, p2, p3 = (_prompts(4, n).tolist() for n in (8, 5, 20))
        res = {}
        th = threading.Thread(target=lambda: res.update(a=engine.generate(params, [p1])[0]))
        th.start()
        time.sleep(0.05)
        res["b"] = engine.generate(params, [p2, p3], max_new_tokens=8)
        th.join(timeout=60)
        assert not th.is_alive()
        L = engine.cache_len
    finally:
        engine.close()
    assert res["a"] == _jax_plain(p["jt"], p["jtp"], p1, 12, L)
    assert res["b"] == [_jax_plain(p["jt"], p["jtp"], q, 8, L) for q in (p2, p3)]


@pytest.mark.parametrize("group", [0, 64])
def test_int4_target_engine_matches_jax(pair, group):
    """A packed-int4 target quantized by the JAX package (per-channel and
    grouped), the fp draft: the port's speculative engine gives the JAX
    speculative engine's tokens."""
    p = pair
    jt4, t4 = _cfgs(quantized=True, weight_bits=4, int4_group=group)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q4 = jquantize_params(p["jtp"], LLAMA_QUANT_PATTERNS, bits=4, group_size=group)
        tp4 = from_jax_params(jax.tree_util.tree_map(np.asarray, q4), t4, device="cpu")
        prompts = [_prompts(7, n).tolist() for n in (6, 11)]
        kw = dict(speculate_k=4, slots=2, max_new_tokens=8, prompt_buckets=(16,), chunk_steps=2)
        engine = _engine(t4, p["d"], **kw)
        try:
            got = engine.generate({"target": tp4, "draft": p["dp"]}, prompts)
        finally:
            engine.close()
        jengine = JEngine(JLlama(jt4), draft_module=JLlama(p["jd"]),
                          registry=jtelemetry.MetricsRegistry(), **kw)
        try:
            want = jengine.generate({"target": q4, "draft": p["jdp"]}, prompts)
        finally:
            jengine.close()
    assert got == want


def test_engine_validation(pair):
    p = pair
    t, d = Llama(p["t"]), Llama(p["d"])
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeEngine(t, draft_module=d, temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="prefix KV-cache"):
        DecodeEngine(t, draft_module=d, prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="vocabularies differ"):
        DecodeEngine(t, draft_module=Llama(LlamaConfig.tiny(vocab_size=50)), device="cpu")
    with pytest.raises(ValueError, match="speculate_k"):
        DecodeEngine(t, draft_module=d, speculate_k=0, device="cpu")
    with pytest.raises(ValueError, match="smallest prompt bucket"):
        DecodeEngine(t, draft_module=d, speculate_k=8, prompt_buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(t, draft_module=d, paged=True, device="cpu")
    engine = _engine(p["t"], p["d"], prompt_buckets=(8,), max_new_tokens=8, chunk_steps=2,
                     pipeline_depth=1)
    try:
        with pytest.raises(ValueError, match='"target"'):
            engine.generate(p["tp"], [[1, 2, 3]])
    finally:
        engine.close()
