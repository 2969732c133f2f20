"""Parity of the port's Llama, weight bridge and generator with the JAX
package's, at ``LlamaConfig.tiny`` sizes on the CPU.

The JAX model's weights (random, from a JAX key) reach the port through
``from_jax_params``; logits are compared at ``dtype="float32"`` (fp32
tolerance: the same products in another summation order), and greedy
tokens must be identical — in fp32, where no near-tie flips.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JConfig
from unionml_tpu.models import generate as jgen
from unionml_tpu.models.layers import rotary_embedding as jrope
from unionml_tpu.models.llama import init_cache as jinit_cache
from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as JPATTERNS
from unionml_tpu.models.quantization import quantize_params as jquantize

from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    from_jax_params,
    init_cache,
    make_generator,
    make_lm_predictor,
    make_sampler,
    quantize_params,
    serving_params,
)
from unionml_tpu_torch.models.layers import rotary_embedding

import torch_threads

torch_threads.share_cores()

VOCAB = 97
FP32 = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _configs(**overrides):
    kw = dict(vocab_size=VOCAB, dtype="float32", **overrides)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return JLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def test_from_jax_params_fp_tree(jax_params):
    _, cfg = _configs()
    tree = _np_tree(jax_params)
    port = from_jax_params(tree, cfg, device="cpu")
    want = dict(_leaves(tree))
    got = dict(_leaves(port))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=str(path))
    # DenseGeneral 3-D kernels keep their layout
    assert tuple(port["block_0"]["attn"]["q"]["kernel"].shape) == (64, 4, 16)
    assert tuple(port["block_0"]["attn"]["o"]["kernel"].shape) == (4, 16, 64)
    # a bf16 tree keeps its bits
    bf16 = _np_tree(jgen.serving_params(jax_params))
    port16 = from_jax_params(bf16, cfg, device="cpu")
    emb = port16["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy(), bf16["embed"]["embedding"].view(np.int16)
    )


def test_from_jax_params_int8_tree(jax_params):
    """JAX int8 tree bridged = the port's own quantize_params of the
    bridged fp tree, leaf for leaf."""
    _, cfg = _configs(quantized=True)
    jq = _np_tree(jquantize(jax_params, JPATTERNS))
    port = from_jax_params(jq, cfg, device="cpu")
    mine = quantize_params(
        from_jax_params(_np_tree(jax_params), cfg, device="cpu"), LLAMA_QUANT_PATTERNS
    )
    q = port["block_1"]["attn"]["o"]
    assert q["kernel_q"].dtype == torch.int8 and tuple(q["kernel_q"].shape) == (64, 64)
    assert q["scale"].dtype == torch.float32 and tuple(q["scale"].shape) == (64,)
    for (path, a), (path2, b) in zip(_leaves(port), _leaves(mine)):
        assert path == path2
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


def test_from_jax_params_rejects_wrong_geometry(jax_params):
    _, cfg = _configs()
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(_np_tree(jax_params), dataclasses.replace(cfg, num_kv_heads=4), device="cpu")
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(_np_tree(jax_params), dataclasses.replace(cfg, num_layers=3), device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_full_forward_logits_match_jax(jax_params, quantized):
    jcfg, cfg = _configs(quantized=quantized)
    params = jquantize(jax_params, JPATTERNS) if quantized else jax_params
    toks = np.random.default_rng(0).integers(1, VOCAB, size=(2, 12)).astype(np.int32)
    want = np.asarray(JLlama(jcfg).apply({"params": params}, jnp.asarray(toks)))
    port = from_jax_params(_np_tree(params), cfg, device="cpu")
    got = Llama(cfg)(port, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("vector_index", [False, True])
@pytest.mark.parametrize("impls", [
    dict(prefill_impl="cached", norm_impl="xla"),
    dict(prefill_impl="flash", norm_impl="fused"),
])
def test_cached_prefill_and_decode_step_logits_match_jax(jax_params, impls, vector_index):
    """Left-padded prefill into the (bf16) cache, then one decode step
    (with one fill index for the batch, or per-row fill indices)."""
    jcfg, cfg = _configs(**impls)
    jm, tm = JLlama(jcfg), Llama(cfg)
    port = from_jax_params(_np_tree(jax_params), cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(1, VOCAB, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), bool)
    mask[1, :4] = False
    pads = 10 - mask.sum(1)
    pos = np.maximum(np.arange(10)[None] - pads[:, None], 0).astype(np.int32)
    kv_mask = np.concatenate([mask, np.ones((2, 6), bool)], axis=1)
    last = np.full((2,), 9, np.int32)

    jl, jc = jm.apply(
        {"params": jax_params}, jnp.asarray(toks), positions=jnp.asarray(pos),
        cache=jinit_cache(jcfg, 2, 16), cache_index=jnp.int32(0),
        kv_mask=jnp.asarray(kv_mask), logit_index=jnp.asarray(last),
        full_prefill=impls["prefill_impl"] == "flash",
    )
    tc = init_cache(cfg, 2, 16, device="cpu")
    with torch.inference_mode():
        tl, tc = tm(
            port, torch.from_numpy(toks), positions=torch.from_numpy(pos), cache=tc,
            cache_index=0, kv_mask=torch.from_numpy(kv_mask),
            logit_index=torch.from_numpy(last),
            full_prefill=impls["prefill_impl"] == "flash",
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)

    step = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    step_pos = (10 - pads)[:, None].astype(np.int32)
    fills = np.array([10, 10], np.int32)
    jl2, _ = jm.apply(
        {"params": jax_params}, jnp.asarray(step), positions=jnp.asarray(step_pos),
        cache=jc, cache_index=jnp.asarray(fills) if vector_index else jnp.int32(10),
        kv_mask=jnp.asarray(kv_mask),
    )
    with torch.inference_mode():
        tl2, _ = tm(
            port, torch.from_numpy(step), positions=torch.from_numpy(step_pos),
            cache=tc, cache_index=torch.from_numpy(fills) if vector_index else 10,
            kv_mask=torch.from_numpy(kv_mask),
        )
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **FP32)


PROMPTS = [
    [5, 9, 11],
    list(range(3, 14)),
    list(np.random.default_rng(4).integers(1, VOCAB, size=20)),
    list(np.random.default_rng(5).integers(1, VOCAB, size=40)),  # left-truncated
    [7],
]


@pytest.mark.parametrize("gen_kwargs", [{}, {"prefill_chunk": 8}, {"eos_id": 30}])
def test_lm_predictor_greedy_tokens_match_jax(jax_params, gen_kwargs):
    """Ragged left-padded prompts (one longer than the largest bucket)
    through flash prefill, fused norm and int8 weights: identical greedy
    tokens. ``prefill_chunk`` takes the chunked cached prefill instead;
    ``eos_id`` freezes finished rows to ``pad_id``."""
    impls = dict(prefill_impl="flash", norm_impl="fused", quantized=True)
    jcfg, cfg = _configs(**impls)
    jparams = jgen.serving_params(jquantize(jax_params, JPATTERNS), dtype=jnp.float32)
    port = from_jax_params(_np_tree(jparams), cfg, device="cpu")
    prompts = [[int(t) for t in p] for p in PROMPTS]
    kw = dict(max_new_tokens=6, bucket_lens=(8, 16, 32), **gen_kwargs)
    want = jgen.make_lm_predictor(JLlama(jcfg), **kw)(jparams, prompts)
    got = make_lm_predictor(Llama(cfg), **kw)(port, prompts)
    assert got == want


def test_generator_eos_and_sampling(jax_params):
    _, cfg = _configs()
    port = from_jax_params(_np_tree(jax_params), cfg, device="cpu")
    toks = torch.tensor([[5, 9, 11, 2]])
    greedy = make_generator(Llama(cfg), max_new_tokens=5, max_len=16)(port, toks)
    assert greedy.shape == (1, 5)
    # top_k=1 sampling is greedy; seeded generators reproduce draws
    top1 = make_generator(Llama(cfg), max_new_tokens=5, max_len=16, temperature=0.7, top_k=1)
    assert torch.equal(top1(port, toks, torch.Generator().manual_seed(0)), greedy)
    hot = make_generator(Llama(cfg), max_new_tokens=5, max_len=16, temperature=1.0, top_p=0.9)
    a = hot(port, toks, torch.Generator().manual_seed(3))
    b = hot(port, toks, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and int(a.max()) < VOCAB
    with pytest.raises(ValueError, match="Generator"):
        hot(port, toks)
    with pytest.raises(ValueError, match="top_p"):
        make_sampler(temperature=1.0, top_p=1.5)


def test_serving_params_keeps_quant_scales_fp32(jax_params):
    _, cfg = _configs(quantized=True)
    port = quantize_params(
        from_jax_params(_np_tree(jax_params), cfg, device="cpu"), LLAMA_QUANT_PATTERNS
    )
    served = serving_params(port)
    q = served["block_0"]["attn"]["q"]
    assert q["kernel_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    assert served["block_0"]["attn_norm"]["scale"].dtype == torch.bfloat16
    assert served["embed"]["embedding"].dtype == torch.bfloat16


def test_rotary_embedding_with_llama3_scaling_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    scaling = (8.0, 1.0, 4.0, 64)
    want = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), theta=500_000.0, scaling=scaling))
    got = rotary_embedding(
        torch.from_numpy(x), torch.from_numpy(pos), theta=500_000.0, scaling=scaling
    ).numpy()
    np.testing.assert_allclose(got, want, **FP32)
