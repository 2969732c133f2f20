"""Collectives over several mesh axes, and serving under tensor parallelism.

Four gloo ranks (:class:`torch_ranks.RankPool`, started once for the
module; rank bodies in ``tests/torch_ranks_a6c.py``) hold:

- ``bucketed_psum``, ``all_gather`` and ``reduce_scatter`` over the tuple
  ``("data", "fsdp")`` on a data 2 x fsdp 2 mesh against the JAX package's
  ``shard_map`` on four of the 8 virtual CPU devices (ROADMAP.md C13), and
  the overlapped accumulation's ``shard_map`` mode over that tuple against
  the serial step and the JAX package's;
- the port's ``make_generator`` and ``DecodeEngine`` on a tree placed by
  the Llama partition rules over ``ShardingConfig(data=-1, tensor=2)``
  (each with the reference's guard that some leaf really is sharded over
  ``tensor``), in fp32, against the JAX package's tokens and the port's
  own solo run under the same placement (the reference's oracle for the
  engine), and the twins of the reference's int4 tensor-parallel tests.

Two planted faults must fail: a collective that reduces over the tuple's
first axis only, and row-parallel sites that keep their rank's partial
product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks_a6c as bodies
import unionml_tpu.parallel as jpar
from torch_ranks import RankPool
from unionml_tpu.models import train as jtrain
from unionml_tpu.models.generate import make_generator as jmake_generator
from unionml_tpu.models.llama import Llama as JLlama
from unionml_tpu.models.llama import LlamaConfig as JLlamaConfig
from unionml_tpu.models.mlp import Mlp as JMlp
from unionml_tpu.models.mlp import MlpConfig as JMlpConfig
from unionml_tpu.models.quantization import LLAMA_QUANT_PATTERNS as J_PATTERNS
from unionml_tpu.models.quantization import quantize_params as jquantize_params
from unionml_tpu_torch.models.train import tree_leaves

import torch_threads

torch_threads.share_cores()

#: fp32 CPU: a rank-ordered sum over 4 ranks against XLA's psum, and the
#: placed Llama's logits against the unplaced ones (measured <= 2.4e-6)
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's torch work on one intra-op thread: its ops are small,
    and under a loaded host (the suite's parallel workers) a pool of
    threads waiting on each other makes each of them far slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4, connect=False)
    yield pool
    pool.close()


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _plain_dict(tree):
    if hasattr(tree, "items"):
        return {k: _plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


# --------------------------------------------------------------------- #
# C13: collectives over ("data", "fsdp")
# --------------------------------------------------------------------- #

AXES = ("data", "fsdp")


@pytest.fixture(scope="module")
def c13_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    tree = {"a": rng.normal(size=(8, 128)).astype(np.float32),
            "b": rng.normal(size=(8, 4)).astype(np.float32),
            "c": rng.normal(size=(8, 513)).astype(np.float32)}
    return x, tree


@pytest.fixture(scope="module")
def c13_jax(c13_inputs):
    """The JAX package's collectives over the same tuple, same layout."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from unionml_tpu.parallel.collectives import all_gather, bucketed_psum, reduce_scatter

    x, tree = c13_inputs
    mesh = jpar.ShardingConfig(data=2, fsdp=2, devices=jax.devices()[:4]).mesh()

    def run(fn, arg, out_spec):
        return _np(shard_map(fn, mesh, in_specs=(P(AXES),), out_specs=out_spec,
                             check_rep=False)(arg))

    return {
        "bucketed": run(lambda t: bucketed_psum(t, AXES, bucket_bytes=600), tree, P()),
        "all_gather": run(lambda b: all_gather(b, AXES, gather_axis=1), x, P()),
        "all_gather_untiled": run(
            lambda b: all_gather(b, AXES, gather_axis=0, tiled=False)[None], x, P(AXES)),
        "reduce_scatter": run(lambda b: reduce_scatter(b, AXES, scatter_axis=1), x, P(AXES)),
    }


def _c13_run(ranks, c13_inputs, fault=""):
    x, tree = c13_inputs
    return ranks.run("torch_ranks_a6c:multi_axis_collectives", x, tree, [1, 600, 1 << 20],
                     fault=fault)


def _c13_worst(got, want):
    worst = max(float(np.abs(got["bucketed"][1][k] - want["bucketed"][k]).max())
                for k in want["bucketed"])
    for name in ("all_gather", "all_gather_untiled", "reduce_scatter"):
        if got[name].shape != want[name].shape:
            return float("inf")
        worst = max(worst, float(np.abs(got[name] - want[name]).max()))
    return worst


def test_collectives_over_two_axes_match_jax(ranks, c13_inputs, c13_jax):
    """bucketed_psum over ("data", "fsdp") at every bucket size is the
    port's own psum over the tuple bit for bit, and within fp32
    reduction-order noise of the JAX package's; all_gather (tiled and
    untiled) and reduce_scatter lay out the product's blocks in lax's
    order, exactly."""
    for got in _c13_run(ranks, c13_inputs):
        for bucketed in got["bucketed"]:
            for k, v in got["psum"].items():
                np.testing.assert_array_equal(bucketed[k], v)
        for k, v in c13_jax["bucketed"].items():
            np.testing.assert_allclose(got["bucketed"][1][k], v, atol=ATOL, rtol=0)
        for name in ("all_gather", "all_gather_untiled", "reduce_scatter"):
            want = c13_jax[name]
            assert got[name].shape == want.shape, name
            tol = 0 if name.startswith("all_gather") else ATOL
            np.testing.assert_allclose(got[name], want, atol=tol, rtol=0, err_msg=name)


def test_planted_fault_one_axis_fails_parity(ranks, c13_inputs, c13_jax):
    """A tuple reduced, gathered and scattered over its first axis only:
    far outside the tolerance the true collectives meet."""
    got = _c13_run(ranks, c13_inputs, fault="one_axis")[0]
    assert _c13_worst(got, c13_jax) > 100 * ATOL


def _mlp_problem(n=256, seed=5):
    cfg = JMlpConfig(num_classes=4, hidden_dims=(32,), dtype="float32")
    params = jax.jit(JMlp(cfg).init)(jax.random.PRNGKey(4), jnp.zeros((1, 8)))["params"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(n,)).astype(np.int32)
    return dict(num_classes=4, hidden_dims=(32,), dtype="float32"), params, x, y


def test_shard_map_mode_over_data_and_fsdp(ranks):
    """The twin of the reference's shard_map bucketed-psum step on a data
    2 x fsdp 2 mesh, reduce axes ("data", "fsdp") (which raised before
    C13's repair): params within fp32 reduction-order noise of the port's
    serial step's (whose backward runs on fsdp-sharded params, so its
    products sum in another order: not bit for bit, as the reference
    claims bit identity on the pure data mesh only) and of the JAX
    package's same step."""
    cfg, jparams, x, y = _mlp_problem()
    batches = [(x[i * 32:(i + 1) * 32].reshape(4, 8, -1), y[i * 32:(i + 1) * 32].reshape(4, 8))
               for i in range(3)]
    kw = dict(sharding={"data": 2, "fsdp": 2}, accumulate_steps=4, lr=0.5)
    pending = ranks.submit("bridged_steps", "mlp", cfg, _np(jparams), batches,
                           overlap="shard_map", overlap_axes=AXES, **kw)
    module = JMlp(JMlpConfig(**cfg))
    state = jtrain.TrainState.create(apply_fn=module.apply, params=jparams, tx=optax.sgd(0.5))
    scfg = jpar.ShardingConfig(data=2, fsdp=2, devices=jax.devices()[:4]).microbatched()
    overlap = jtrain.GradOverlap(mode="shard_map", mesh=scfg.mesh(), axes=AXES)
    with jtrain.grad_overlap_scope(overlap):
        compiled, state = jpar.compile_step(
            jtrain.classification_step(module, accumulate_steps=4), state, sharding=scfg,
            donate_state=False)
        for batch in batches:
            state, _ = compiled(state, jax.device_put(batch, scfg.batch_sharding()))
    mapped = pending.collect()
    serial = ranks.run("bridged_steps", "mlp", cfg, _np(jparams), batches, **kw)
    want = jax.tree_util.tree_leaves(_np(state.params))
    for s, m in zip(serial, mapped):
        np.testing.assert_allclose(m["losses"], s["losses"], rtol=1e-6)
        for a, b in zip(tree_leaves(m["params"]), tree_leaves(s["params"])):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        for a, b in zip(tree_leaves(m["params"]), want):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# A6c: serving a placed tree
# --------------------------------------------------------------------- #


def _tiny(**over):
    # the reference's tiny_llama (vocab 97: the embedding and LM head stay
    # whole, the blocks shard), in fp32 for token parity
    kw = dict(vocab_size=97, hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
              mlp_dim=128, max_len=256, rope_theta=10_000.0, dtype="float32")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def tiny_llama():
    module = JLlama(JLlamaConfig(**_tiny()))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return module, _plain_dict(params)


@pytest.fixture(scope="module")
def jax_solo():
    """The JAX package's greedy tokens for each prompt alone, at a given
    cache length (the reference's engine oracle: ``max_len=engine
    .cache_len``); one generator per (case, length) for the module."""
    gens = {}

    def tokens(case, module, params, prompts, max_new_tokens, max_len):
        key = (case, max_new_tokens, max_len)
        if key not in gens:
            gens[key] = jmake_generator(module, max_new_tokens=max_new_tokens, max_len=max_len)
        return [np.asarray(gens[key](params, jnp.asarray([p], jnp.int32)))[0].tolist()
                for p in prompts]

    return tokens


def _engine_run(ranks, cfg, params, prompts, *, paged, max_new_tokens=6, pipeline_depth=1,
                **kw):
    """Start ``tp_engine`` on the ranks; returns the pending call and the
    engine's cache length (computed here, checked against the ranks')."""
    cache_len = bodies.engine_cache_len(
        dict(cfg, kv_quant=kw.get("kv_quant", False)),
        **bodies.engine_kwargs(max_new_tokens, paged, pipeline_depth))
    pending = ranks.submit("torch_ranks_a6c:tp_engine", cfg, params, prompts,
                           max_new_tokens=max_new_tokens, paged=paged,
                           pipeline_depth=pipeline_depth, **kw)
    return pending, cache_len


def _assert_sharded(got):
    # the reference's guard: REAL tensor sharding, not a replication fallback
    assert any("block_0/attn/q" in p for p in got["sharded"]), got["sharded"]


def test_generation_under_tensor_parallel_sharding(ranks, tiny_llama):
    """Twin of the reference's generator under tensor=2: the placed tree's
    tokens equal the unplaced run's and the JAX package's; the placed
    forward's logits within fp32 reduction-order noise."""
    module, params = tiny_llama
    prompt = np.asarray([[7, 3, 9, 2]], np.int32)
    pending = ranks.submit("torch_ranks_a6c:tp_generate", _tiny(), params, prompt,
                           max_new_tokens=4, max_len=32)
    ref = np.asarray(jmake_generator(module, max_new_tokens=4, max_len=32)(params, prompt))
    for got in pending.collect():
        _assert_sharded(got)
        np.testing.assert_array_equal(got["tp"], ref)
        np.testing.assert_array_equal(got["plain"], ref)
        np.testing.assert_allclose(got["tp_logits"], got["logits"], atol=ATOL, rtol=0)
        assert got["collectives"] > 0
        tp_rows, plain_rows = got["predictor"]
        assert tp_rows == plain_rows        # make_lm_predictor on the placed tree


def test_flash_prefill_under_tensor_parallel_sharding(ranks, tiny_llama):
    """Twin of the reference's flash prefill under tensor=2: the padded
    flash kernel's plain version on each rank's heads, tokens equal to the
    unplaced run's and the JAX package's (its Pallas kernel in interpret
    mode)."""
    module, params = tiny_llama
    prompt = np.asarray([[7, 3, 9, 2, 11, 5]], np.int32)
    pending = ranks.submit("torch_ranks_a6c:tp_generate", _tiny(prefill_impl="flash"), params,
                           prompt, max_new_tokens=4, max_len=32)
    fmod = JLlama(dataclasses.replace(module.config, prefill_impl="flash"))
    ref = np.asarray(jmake_generator(fmod, max_new_tokens=4, max_len=32)(params, prompt))
    for got in pending.collect():
        _assert_sharded(got)
        np.testing.assert_array_equal(got["tp"], ref)
        np.testing.assert_array_equal(got["plain"], ref)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_under_tensor_parallel_sharding(ranks, tiny_llama, jax_solo, paged):
    """Twin of the reference's engine under tensor=2: continuous batching
    on the placed tree, each slot token-identical to the solo run under
    the same placement at the engine's cache length (the reference's
    oracle) and to the JAX package's solo run at that length, on every
    rank; the paged pool's blocks hold the rank's kv heads (half the
    bytes)."""
    module, params = tiny_llama
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
    pending, cache_len = _engine_run(ranks, _tiny(), params, prompts, paged=paged)
    want = jax_solo("fp", module, params, prompts, 6, cache_len)
    for got in pending.collect():
        _assert_sharded(got)
        assert got["cache_len"] == cache_len
        assert got["engine"] == want
        assert got["engine"] == got["solo"]
        assert got["engine"] == got["plain_engine"]
        if paged:
            whole, local = got["block_nbytes"]
            assert local * 2 == whole
            assert got["pool_heads"] == 1


def test_int8_kv_engine_under_tensor_parallel_sharding(ranks, tiny_llama, jax_solo):
    """The int8 weights and int8 KV cache under tensor=2 through the paged
    engine: rows 7-8's int8 sibling and the quantized cache on local kv
    heads, tokens equal to the solo run under the same placement and to
    the JAX package's int8-KV generator on its own int8 tree."""
    _, params = tiny_llama
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
    pending, cache_len = _engine_run(ranks, _tiny(quantized=True), params, prompts, paged=True,
                                     bits=8, kv_quant=True, rules="LLAMA_QUANT_PARTITION_RULES")
    jmod = JLlama(JLlamaConfig(**_tiny(quantized=True, kv_quant=True)))
    want = jax_solo("int8_kv", jmod, jquantize_params(params, J_PATTERNS), prompts, 6, cache_len)
    for got in pending.collect():
        _assert_sharded(got)
        assert got["cache_len"] == cache_len
        assert got["engine"] == got["solo"] == got["plain_engine"] == want


def test_planted_fault_dropped_row_parallel_sum_fails_parity(ranks, tiny_llama):
    """Row-parallel sites (o, down) that keep their rank's partial product:
    the placed logits leave the unplaced ones far outside ATOL."""
    _, params = tiny_llama
    got = ranks.run("torch_ranks_a6c:tp_generate", _tiny(), params,
                    np.asarray([[7, 3, 9, 2]], np.int32), max_new_tokens=4, max_len=32,
                    fault="drop_row_sum")[0]
    assert float(np.abs(got["tp_logits"] - got["logits"]).max()) > 1000 * ATOL


# --------------------------------------------------------------------- #
# int4 under tensor parallelism (the reference's test_int4.py twins)
# --------------------------------------------------------------------- #


def _int4_cfg(**over):
    kw = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
              mlp_dim=128, max_len=256, rope_theta=10_000.0, quantized=True, weight_bits=4)
    kw.update(over)
    return kw


def test_int4_tp_compatibility_guard():
    """Twin of the reference's guard test (no ranks: a rule check)."""
    from unionml_tpu_torch.models.llama import LlamaConfig, assert_int4_tp_compatible

    cfg8b = LlamaConfig(quantized=True, weight_bits=4)
    assert_int4_tp_compatible(cfg8b, 2)
    with pytest.raises(ValueError, match="packing tile"):
        assert_int4_tp_compatible(cfg8b, 4)
    assert_int4_tp_compatible(LlamaConfig(quantized=True), 8)


def test_tile_selection_with_tp_shards():
    """Twin of the reference's shard-aware tile rule (no ranks)."""
    from unionml_tpu.ops.int4_matmul import tile_for as jtile_for
    from unionml_tpu_torch.ops.int4_matmul import tile_for

    cases = [(1024, 4096, 4, 256), (1024, 4096, 8, 128), (14336, 4096, 8, 256),
             (4096, 4096, 8, 512), (96, 64, 2, 0)]
    for n, k, shards, want in cases:
        assert tile_for(n, k, shards=shards) == jtile_for(n, k, shards=shards) == want


def test_int4_partition_rules_match_reference():
    """LLAMA_INT4_PARTITION_RULES: the reference's rules, first-match
    overrides of the LM head first."""
    from unionml_tpu.models.llama import LLAMA_INT4_PARTITION_RULES as JRULES
    from unionml_tpu_torch.models import LLAMA_INT4_PARTITION_RULES

    got = [(r.pattern, tuple(r.spec)) for r in LLAMA_INT4_PARTITION_RULES]
    want = [(r.pattern, tuple(r.spec)) for r in JRULES]
    assert got == want
    assert got[0] == (r"lm_head/scale$", ())


@pytest.mark.parametrize("group", [0, 32], ids=["per_channel", "grouped"])
def test_int4_tp_packed_tree_passes_guard_and_generates(ranks, group):
    """Twin of the reference's tensor=2-packed int4 test on 4 ranks: the
    JAX package's tree quantized with tensor=2 passes the guard at tp=2,
    is placed by LLAMA_INT4_PARTITION_RULES (the LM head K-sharded, its
    partial logits summed) and generates finitely, tokens equal to the
    unplaced tree's, logits within fp32 noise of the JAX package's; the
    8B geometry packed for int4_tp=8 passes at 2, 4 and 8."""
    from unionml_tpu_torch.models.llama import LlamaConfig, assert_int4_tp_compatible

    cfg = _int4_cfg(int4_tp=2, hidden_dim=128, mlp_dim=256, int4_group=group,
                    dtype="float32")
    fp_cfg = JLlamaConfig(**{**cfg, "quantized": False, "weight_bits": 8, "int4_tp": 1,
                             "int4_group": 0})
    params = JLlama(fp_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    q4 = jquantize_params(params, J_PATTERNS, bits=4, tensor=2, group_size=group)
    prompt = np.asarray([[5, 3, 9, 2]], np.int32)
    pending = ranks.submit("torch_ranks_a6c:tp_generate", cfg, _plain_dict(q4), prompt,
                           max_new_tokens=4, max_len=32, rules="LLAMA_INT4_PARTITION_RULES")
    jlogits = np.asarray(JLlama(JLlamaConfig(**cfg)).apply({"params": q4}, prompt))
    assert_int4_tp_compatible(LlamaConfig(**cfg), 2)
    for tp in (2, 4, 8):
        assert_int4_tp_compatible(LlamaConfig(quantized=True, weight_bits=4, int4_tp=8), tp)
    for got in pending.collect():
        assert "lm_head/kernel_p" in got["sharded"], got["sharded"]
        assert np.isfinite(got["tp_logits"]).all()
        np.testing.assert_array_equal(got["tp"], got["plain"])
        np.testing.assert_allclose(got["tp_logits"], jlogits, atol=1e-4, rtol=0)


def test_encdec_generation_under_tensor_parallel_sharding(ranks):
    """Twin of the reference's encoder-decoder under tensor=2: the tree
    placed by ENCDEC_PARTITION_RULES generates the unplaced tree's tokens
    and the JAX package's."""
    from unionml_tpu.models import encdec as jencdec

    jcfg = jencdec.EncDecConfig.tiny(vocab_size=97, dtype="float32")
    jmod = jencdec.EncoderDecoder(jcfg)
    params = _plain_dict(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                   jnp.zeros((1, 4), jnp.int32))["params"])
    src = np.random.default_rng(4).integers(1, 97, size=(2, 8)).astype(np.int32)
    cfg = dict(vocab_size=97, hidden_dim=64, num_encoder_layers=2, num_decoder_layers=2,
               num_heads=4, mlp_dim=128, max_len=64, dtype="float32")
    pending = ranks.submit("torch_ranks_a6c:tp_encdec", cfg, params, src, max_new_tokens=4)
    ref = np.asarray(jencdec.make_seq2seq_generator(jmod, max_new_tokens=4)(
        params, jnp.asarray(src), None, jnp.asarray(src != 0)))
    for got in pending.collect():
        assert any("attn/q/kernel" in p for p in got["sharded"]), got["sharded"]
        np.testing.assert_array_equal(got["tp"], ref)
        np.testing.assert_array_equal(got["plain"], ref)


def _chip_smoke():
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(repo))
    return chip_smoke


def test_chip_smoke_placed_serving_rehearsal_on_cpu():
    """chip_smoke.py's phase 9a at a tiny config on the CPU: an int8 and a
    grouped int4 tree placed on a one-rank gloo group, the paged engine
    and the generator on each bit for bit the plain tree's; the int4
    guard's checks at Llama-3-8B width."""
    import dataclasses

    from unionml_tpu_torch.models import (LLAMA_INT4_PARTITION_RULES,
                                          LLAMA_QUANT_PARTITION_RULES, LlamaConfig)

    smoke = _chip_smoke()
    cfg = smoke.serving_config(LlamaConfig.tiny(hidden_dim=128, mlp_dim=256))
    kw = dict(device="cpu", lengths=(5, 20, 9, 30), buckets=(32, 64), max_new_tokens=4)
    out = smoke.tp_serve_check(cfg, smoke.random_quantized_params(cfg, 0, device="cpu"),
                               LLAMA_QUANT_PARTITION_RULES, **kw)
    assert out["tokens_equal"] and out["backend"] == "gloo"
    cfg4 = dataclasses.replace(cfg, weight_bits=4, int4_group=64)
    out = smoke.tp_serve_check(cfg4, smoke.random_quantized_params(cfg4, 0, device="cpu"),
                               LLAMA_INT4_PARTITION_RULES, **kw)
    assert set(out["launches"]) >= {"int4_matmul_grouped"}
    assert smoke.int4_tp_guard_check()["passes"] == [2, 4, 8]


def test_speculative_engine_with_a_placed_int4_target(ranks, jax_solo):
    """The speculative engine as far as its int4 target runs on a placed
    tree (packed for tensor=2, LLAMA_INT4_PARTITION_RULES) beside an
    unplaced int8 draft: the unplaced target's tokens on every rank, and
    the JAX package's greedy tokens of its own int4 target (packed for
    tensor=2) at the engine's cache length."""
    cfg = _int4_cfg(hidden_dim=128, mlp_dim=256, dtype="float32")
    fp = {k: v for k, v in cfg.items() if k not in ("quantized", "weight_bits")}
    jparams = JLlama(JLlamaConfig(**fp)).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 4), jnp.int32))["params"]
    prompts = [[5, 3, 9, 2, 7], [1, 4, 8]]
    target = dict(fp, quantized=True, weight_bits=4, int4_tp=2)
    cache_len = bodies.engine_cache_len(target, dict(fp, quantized=True),
                                        **bodies.spec_engine_kwargs(6))
    pending = ranks.submit("torch_ranks_a6c:tp_spec_engine", fp, _plain_dict(jparams), prompts,
                           max_new_tokens=6)
    q4 = jquantize_params(jparams, J_PATTERNS, bits=4, tensor=2)
    want = jax_solo("int4_target", JLlama(JLlamaConfig(**target)), q4, prompts, 6, cache_len)
    for got in pending.collect():
        assert any("attn/o/kernel_p" in p for p in got["sharded"]), got["sharded"]
        assert got["cache_len"] == cache_len
        assert got["tp"] == got["plain"] == want


def test_engine_when_tensor_does_not_divide_the_kv_heads(ranks, jax_solo):
    """GQA with one kv head under tensor=2: the q heads shard, the k / v
    projections stay whole, each rank's cache holds one kv head per local
    q head (head ``h`` reads kv head ``(h0 + h) // group``); the paged
    engine and the generator give the unplaced tree's tokens and the JAX
    package's."""
    over = dict(num_kv_heads=1)
    jmod = JLlama(JLlamaConfig(**_tiny(**over)))
    params = _plain_dict(jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"])
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
    pending, cache_len = _engine_run(ranks, _tiny(**over), params, prompts, paged=True)
    want = jax_solo("gqa1", jmod, params, prompts, 6, cache_len)
    for got in pending.collect():
        assert "block_0/attn/q/kernel" in got["sharded"]
        assert "block_0/attn/k/kernel" not in got["sharded"]
        assert got["engine"] == got["solo"] == got["plain_engine"] == want
        assert got["pool_heads"] == 2


def test_prefix_cached_engine_under_tensor_parallel_sharding(ranks, tiny_llama, jax_solo):
    """The paged engine with a system prefix held in a prefix cache, on the
    placed tree: the prefix's blocks are the rank's local blocks, spliced
    into every admission; tokens and tokens saved equal the unplaced
    engine's, and the tokens the JAX package's for the prefix and prompt
    alone at the engine's cache length."""
    module, params = tiny_llama
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
    prefix = [9, 3, 7, 5, 11, 2, 4, 8]
    pending, cache_len = _engine_run(ranks, _tiny(), params, prompts, paged=True,
                                     system_prefix=prefix)
    want = jax_solo("fp", module, params, [prefix + p for p in prompts], 6, cache_len)
    for got in pending.collect():
        _assert_sharded(got)
        assert got["engine"] == got["plain_engine"] == want
        assert got["saved"] == got["plain_saved"] > 0


def test_engine_with_more_requests_than_slots_under_tensor_parallel(ranks, tiny_llama,
                                                                   jax_solo):
    """Five requests on two slots under tensor=2: admissions wait for
    retirements, which the harvester makes on its own clock; the ranks'
    dispatchers decide each pass on a drained pipeline (lockstep), so they
    admit and decode in one order (ROADMAP.md C14) and every slot keeps its
    solo tokens under the same placement, and the JAX package's."""
    module, params = tiny_llama
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 14], [15, 16, 17, 18, 19, 20]]
    pending, cache_len = _engine_run(ranks, _tiny(), params, prompts, paged=True)
    want = jax_solo("fp", module, params, prompts, 6, cache_len)
    for got in pending.collect():
        assert got["engine"] == got["solo"] == got["plain_engine"] == want


def test_staggered_calls_at_the_default_pipeline_depth_under_tensor_parallel(ranks, tiny_llama,
                                                                            jax_solo):
    """Two generate() calls from two threads at the engine's default
    pipeline depth, the second reaching the controller mid-decode (after 3
    decode steps): the controller's plans carry each arrival to its tensor
    group's follower at the same pass, so every slot keeps the JAX
    package's solo tokens and the placed solo run's; a deadline, a stream
    and a queue bound, which read the controller's clock alone, now serve
    the same tokens (ROADMAP.md C14)."""
    module, params = tiny_llama
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8]]
    pending, cache_len = _engine_run(ranks, _tiny(), params, prompts, paged=True,
                                     max_new_tokens=12, pipeline_depth=None, stagger=3)
    want = jax_solo("fp", module, params, prompts, 12, cache_len)
    for got in pending.collect():
        assert got["engine"] == got["solo"] == got["plain_engine"] == want
        assert got["lifted"] == [want[:1], want[0], want[:1]]
