"""Serving placed MoE and LoRA trees (A8).

Four gloo ranks (:class:`torch_ranks.RankPool`, started once for the
module; rank bodies in ``tests/torch_ranks_a8.py``):

- a tiny MoE Llama (4 experts, top 2), fp and int8 experts, placed by
  ``LLAMA_MOE_PARTITION_RULES`` over ``ShardingConfig(data=-1, expert=2,
  tensor=2)`` — each rank runs its two experts on its half of their
  hidden dim, the router whole, the partial outputs summed over
  ``expert`` then ``tensor`` in rank order — served by the paged
  ``DecodeEngine`` (one engine over the four ranks, rank 0 its controller)
  and ``make_generator``: the solo run's tokens under the same placement
  (the twin of ``tests/unit/test_engine.py:252``), with the guard that a
  leaf really is sharded over ``expert``; the unplaced port's engine gives
  the JAX package's tokens on the same weights;
- a LoRA and a QLoRA state placed by ``LLAMA_LORA_PARTITION_RULES``
  served by ``make_lm_predictor(system_prefix=...)``: the prefix cache is
  built once for the state and the tokens are the unplaced state's and the
  generator's on the merged tree with the prefix prepended (the twin of
  ``tests/unit/test_generate.py:640``).

fp32 on the CPU: tokens exact; logits of the placed forward within
``ATOL`` of the unplaced one. Planted fault: a served MoE block that drops
the sum over ``expert`` must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_ranks import RankPool
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.models.llama import Llama as JLlama
from unionml_tpu.models.llama import LlamaConfig as JLlamaConfig
from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as J_PATTERNS
from unionml_tpu.models.quantization import quantize_params as jquantize_params

import torch_threads

torch_threads.share_cores()

#: fp32 CPU: the placed MoE forward's logits against the unplaced ones (the
#: partial outputs of two experts' halves summed over 2 x 2 ranks)
ATOL = 2e-5
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10]]


def _tiny(**over):
    # the reference's tiny MoE engine config (vocab 97), in fp32
    kw = dict(vocab_size=97, hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
              mlp_dim=128, max_len=256, rope_theta=10_000.0, dtype="float32",
              num_experts=4, num_selected=2)
    kw.update(over)
    return kw


def _plain_dict(tree):
    if hasattr(tree, "items"):
        return {k: _plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4, connect=False)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def moe_weights():
    module = JLlama(JLlamaConfig(**_tiny()))
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    return _plain_dict(params)


def _jax_tokens(params, bits, cache_len):
    module = JLlama(JLlamaConfig(**_tiny(quantized=bool(bits))))
    if bits:
        params = jquantize_params(params, J_PATTERNS)
    gen = jmake_generator(module, max_new_tokens=6, max_len=cache_len)
    return [np.asarray(gen(params, jnp.asarray([p], jnp.int32)))[0].tolist() for p in PROMPTS]


@pytest.mark.parametrize("bits", [0, 8], ids=["fp", "int8"])
def test_placed_moe_engine_and_generator_keep_the_solo_tokens(ranks, moe_weights, bits):
    got = ranks.run("torch_ranks_a8:moe_serving", _tiny(), moe_weights, PROMPTS, bits=bits,
                    max_new_tokens=6, timeout=120)
    want = _jax_tokens(moe_weights, bits, got[0]["cache_len"])
    suffix = "_q" if bits else ""
    for r in got:
        # the reference's guard: the experts really split over `expert`
        assert f"block_0/moe/w_gate{suffix}" in r["expert"], r["expert"]
        assert f"block_0/moe/w_down{suffix}" in r["tensor"], r["tensor"]
        assert r["engine"] == r["solo"] == r["plain_engine"] == want
        assert r["generator"] == [r["solo"][0]]
        np.testing.assert_allclose(r["tp_logits"], r["logits"], atol=ATOL, rtol=0)


def test_planted_fault_dropped_expert_sum_fails(ranks, moe_weights):
    """Each rank keeps its two experts' output instead of the sum over
    ``expert``: the placed logits leave the unplaced ones."""
    got = ranks.run("torch_ranks_a8:moe_serving", _tiny(), moe_weights, PROMPTS, bits=0,
                    max_new_tokens=6, fault="drop_expert_sum", timeout=120)
    for r in got:
        assert np.abs(r["tp_logits"] - r["logits"]).max() > 100 * ATOL


@pytest.fixture(scope="module")
def dense_weights():
    kw = _tiny()
    del kw["num_experts"], kw["num_selected"]
    module = JLlama(JLlamaConfig(**kw))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return kw, _plain_dict(params)


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
def test_placed_lora_state_serves_through_the_prefixed_predictor(ranks, dense_weights,
                                                                 quantized):
    cfg, params = dense_weights
    prompts = [[5, 6], [9, 10, 11]]
    got = ranks.run("torch_ranks_a8:lora_serving", cfg, params, prompts, quantized=quantized,
                    system_prefix=[1, 2, 3], max_new_tokens=3, timeout=120)
    for r in got:
        # adapters follow their base: lora_b of the column-parallel q, lora_a
        # of the row-parallel o and down
        for site in ("attn/q/lora_b", "attn/o/lora_a", "mlp/down/lora_a"):
            assert f"block_0/{site}" in r["lora_tensor"], r["lora_tensor"]
        assert r["prefix_builds"] == 1
        assert r["first"] == r["second"] == r["plain"] == r["generator"]


def test_chip_smoke_placed_moe_lora_rehearsal_on_cpu():
    """chip_smoke.py's phase 10b at tiny widths on a one-rank gloo group
    in this process: the placed int8 MoE engine and generator and the
    placed QLoRA predictor give the unplaced trees' tokens."""
    import sys
    from pathlib import Path

    from unionml_tpu_torch.models import LlamaConfig

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    tiny = LlamaConfig.tiny()
    moe = chip_smoke.serving_config(LlamaConfig.tiny(num_experts=4, num_selected=2))
    qlora = chip_smoke.serving_config(chip_smoke.qlora_config(
        **{k: getattr(tiny, k) for k in ("vocab_size", "hidden_dim", "num_layers", "num_heads",
                                         "num_kv_heads", "mlp_dim", "max_len")},
        lora_rank=2, remat=False))
    out = chip_smoke.placed_moe_lora_phase(moe, qlora, device="cpu", lengths=(5, 20),
                                           buckets=(16, 32), max_new_tokens=4)
    assert out["moe"]["tokens_equal"] and out["qlora"]["tokens_equal"]
    assert out["moe"]["backend"] == "gloo"
