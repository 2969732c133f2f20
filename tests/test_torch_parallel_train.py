"""The port's sharded training step against the JAX package's.

The same reference params (a JAX init, bridged into the port in each
rank) and the same numpy batches go through the JAX package's
``compile_step`` over four of the 8 virtual CPU devices and through the
port's ``compile_step`` in four gloo ranks (:class:`torch_ranks.RankPool`,
started once for the module), on the same mesh shape, in fp32. Parity
steps use SGD: Adam's ``m / sqrt(v)`` turns near-zero gradients into
``+-lr`` coin flips that say nothing about the sharding. The port's own
sharded-vs-unsharded and overlapped-vs-serial comparisons are held bit
for bit where the arithmetic is the same. Two planted faults (a step that
skips the data all-reduce, a GQA local call that drops its rank's head
offset) must fail the parity they would break.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import unionml_tpu.parallel as jpar
from torch_ranks import RankPool
from unionml_tpu.models import llama as jllama
from unionml_tpu.models import train as jtrain
from unionml_tpu.models import vit as jvit
from unionml_tpu.models.mlp import Mlp as JMlp
from unionml_tpu.models.mlp import MlpConfig as JMlpConfig
from unionml_tpu_torch.models.llama import LlamaConfig
from unionml_tpu_torch.models.train import tree_leaves

import torch_threads

torch_threads.share_cores()

#: fp32 CPU, sharded port vs sharded reference after a few SGD steps:
#: the two differ only in reduction order (measured <= 2e-6 here)
PARAM_ATOL = 2e-5
#: the same bound for the step losses
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_close(port_params, jax_params, atol=PARAM_ATOL):
    """Every param of the port's tree within ``atol`` of the reference's
    leaf at the same path (the trees carry the same names)."""
    got, want = _flat(port_params), _flat(_np(jax_params))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    assert worst <= atol, worst
    return worst


def _jax_sharded_steps(module, params, batches, step_fn, rules, lr, **axes):
    state = jtrain.TrainState.create(apply_fn=module.apply, params=params, tx=optax.sgd(lr))
    cfg = jpar.ShardingConfig(**axes, rules=rules, devices=jax.devices()[:4])
    compiled, state = jpar.compile_step(step_fn, state, sharding=cfg, donate_state=False)
    losses = []
    for batch in batches:
        state, metrics = compiled(state, jax.device_put(batch, cfg.batch_sharding()))
        losses.append(float(metrics["loss"]))
    return losses, state.params


# --------------------------------------------------------------------- #
# the reference's train-step app: single device, dp, fsdp
# --------------------------------------------------------------------- #


_APP_RUNS = {}


def _app(ranks, sharding, epochs):
    key = (str(sharding), epochs)
    if key not in _APP_RUNS:
        if sharding is None:
            # one device needs no ranks: the app runs here
            import torch_ranks

            _APP_RUNS[key] = [torch_ranks.app_train(None, epochs, 64, 256)]
        else:
            _APP_RUNS[key] = ranks.run("app_train", sharding, epochs, 64, 256)
    return _APP_RUNS[key]


@pytest.mark.parametrize("sharding,epochs", [(None, 2), ({"data": -1}, 2),
                                             ({"data": 2, "fsdp": 2}, 2)],
                         ids=["single_device", "dp_mesh", "fsdp_mesh"])
def test_train_step_app(ranks, sharding, epochs):
    """The reference's test_train_step app through the port's Model in
    each rank: the blobs are learned (test accuracy > 0.95 as there), and
    the sharded runs end at the unsharded run's params within fp32
    reduction-order noise (1e-4 after 6 AdamW steps)."""
    out = _app(ranks, sharding, epochs)
    for got in out:
        assert got["metrics"]["train"] > 0.95 and got["metrics"]["test"] > 0.95
    if sharding is not None:
        single = _app(ranks, None, epochs)[0]
        for a, b in zip(tree_leaves(out[0]["params"]), tree_leaves(single["params"])):
            np.testing.assert_allclose(a, b, atol=1e-4)


# --------------------------------------------------------------------- #
# ViT and Llama under tensor parallelism
# --------------------------------------------------------------------- #


VIT = dict(image_size=16, patch_size=8, num_classes=10, hidden_dim=32, num_layers=1,
           num_heads=4, mlp_dim=64, dtype="float32")


def test_vit_sharded_train_step(ranks):
    """ViT-tiny, data 2 x tensor 2 under VIT_PARTITION_RULES: the port's
    fused norms and fused attention (their plain versions here, reached
    through local shards) against the reference's xla path, 3 SGD steps."""
    jcfg = jvit.ViTConfig(**VIT)
    module = jvit.ViT(jcfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(3)]
    ranks.submit("bridged_steps", "vit", dict(VIT, norm_impl="fused", attn_impl="fused"),
                 _np(params), batches, sharding={"data": 2, "tensor": 2},
                 rules="VIT_PARTITION_RULES", lr=0.1)
    losses, jparams = _jax_sharded_steps(module, params, batches,
                                         jtrain.classification_step(module),
                                         jvit.VIT_PARTITION_RULES, 0.1, data=2, tensor=2)
    for got in ranks.collect():
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        _assert_close(got["params"], jparams)


def _llama_cfgs(num_heads, num_kv_heads, **port):
    over = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, hidden_dim=48, num_layers=1,
                dtype="float32")
    jcfg = jllama.LlamaConfig.tiny(vocab_size=64, **over)
    pcfg = dataclasses.asdict(LlamaConfig.tiny(vocab_size=64, **over))
    pcfg.update(port)
    return jcfg, pcfg


_LLAMA_REFERENCE = {}


def _llama_case(ranks, num_heads, num_kv_heads, *, fault=""):
    """The port's 2 sharded steps in the ranks (started first) and the
    reference's, computed once per head geometry meanwhile."""
    jcfg, pcfg = _llama_cfgs(num_heads, num_kv_heads, attn_impl="flash", norm_impl="fused")
    module = jllama.Llama(jcfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 64, size=(8, 16)).astype(np.int32) for _ in range(2)]
    ranks.submit("bridged_steps", "llama", pcfg, _np(params), batches,
                 sharding={"data": 2, "tensor": 2}, rules="LLAMA_PARTITION_RULES",
                 lr=0.1, fault=fault)
    key = (num_heads, num_kv_heads)
    if key not in _LLAMA_REFERENCE:
        _LLAMA_REFERENCE[key] = _jax_sharded_steps(
            module, params, batches, jtrain.lm_step(module), jllama.LLAMA_PARTITION_RULES,
            0.1, data=2, tensor=2)
    losses, jparams = _LLAMA_REFERENCE[key]
    return ranks.collect(), losses, jparams


@pytest.mark.parametrize("heads", [(4, 2), (6, 3)], ids=["gqa_divides", "gqa_kv_whole"])
def test_llama_tp_sharded_lm_step(ranks, heads):
    """Llama lm_step under LLAMA_PARTITION_RULES over data 2 x tensor 2:
    q heads split over `tensor`; with 6 q / 3 kv heads the kv heads stay
    whole (sanitize drops `tensor`) and each rank's local flash call maps
    its q heads to kv heads through its head offset. 2 SGD steps against
    the reference's sharded step."""
    port, losses, jparams = _llama_case(ranks, *heads)
    for got in port:
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        _assert_close(got["params"], jparams)


def test_planted_fault_dropped_gqa_offset_fails_parity(ranks):
    """A local call that maps each rank's q heads as if they started at
    head 0 attends the wrong kv heads on rank 1: the parity check above
    must fail (the error is orders above PARAM_ATOL)."""
    port, losses, jparams = _llama_case(ranks, 6, 3, fault="drop_gqa_offset")
    with pytest.raises(AssertionError):
        _assert_close(port[0]["params"], jparams)
    assert not np.allclose(port[0]["losses"][1], losses[1], rtol=LOSS_RTOL)


def test_planted_fault_skipped_data_allreduce_fails_parity(ranks):
    """A step that keeps each rank's own rows' gradient instead of the sum
    over `data` updates every rank differently: parity must fail."""
    port, _, jparams = _llama_case(ranks, 4, 2, fault="skip_allreduce")
    with pytest.raises(AssertionError):
        _assert_close(port[0]["params"], jparams)


def test_lora_sharded_step_matches_serial(ranks):
    """dp2 x tp2 under LLAMA_LORA_PARTITION_RULES (adapters follow their
    base kernel's layout): 3 SGD steps at lr 0.5 against the reference's
    SERIAL step, as the reference's own test holds its sharded run. In
    fp32 the port holds PARAM_ATOL where the reference (bf16) allows
    2e-2."""
    from unionml_tpu.models.lora import create_lora_train_state, merge_param_trees

    jcfg, pcfg = _llama_cfgs(4, 2, lora_rank=4)
    model = jllama.Llama(dataclasses.replace(jcfg, lora_rank=4))
    tokens = jnp.zeros((2, 16), jnp.int32)
    base = jax.jit(jllama.Llama(jcfg).init)(jax.random.PRNGKey(0), tokens)["params"]
    state = create_lora_train_state(model, tokens, base_params=base, optimizer=optax.sgd(0.5))
    # lora_b off zero, so both adapter factors train from step 1
    state = state.replace(params=jax.tree_util.tree_map(lambda p: p + 0.01, state.params))
    start = merge_param_trees(_np(state.frozen_params), _np(state.params))
    batch = np.random.default_rng(0).integers(1, 64, (4, 17)).astype(np.int32)
    ranks.submit("bridged_steps", "llama", pcfg, start, [batch] * 3,
                 sharding={"data": 2, "tensor": 2}, rules="LLAMA_LORA_PARTITION_RULES", lr=0.5)
    step = jax.jit(jtrain.lm_step(model))
    losses = []
    for _ in range(3):
        state, metrics = step(state, jnp.asarray(batch))
        losses.append(float(metrics["loss"]))
    port = ranks.collect()
    for got in port:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-2)   # the reference's bound
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        _assert_close(got["params"], state.params)


# --------------------------------------------------------------------- #
# gradient accumulation and overlap
# --------------------------------------------------------------------- #


def _mlp_problem(n=256, seed=5):
    cfg = JMlpConfig(num_classes=4, hidden_dims=(32,), dtype="float32")
    params = jax.jit(JMlp(cfg).init)(jax.random.PRNGKey(4), jnp.zeros((1, 8)))["params"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(n,)).astype(np.int32)
    return dict(num_classes=4, hidden_dims=(32,), dtype="float32"), _np(params), x, y


def _equal(a, b):
    return all(np.array_equal(p, q) for p, q in zip(tree_leaves(a), tree_leaves(b)))


def test_defer_mode_bit_identical_on_2x2_mesh(ranks):
    """The deferred consumption on data 2 x fsdp 2: losses and params bit
    for bit the serial accumulation's (the same adds in the same order)."""
    cfg, params, x, y = _mlp_problem()
    batches = [(x[i * 32:(i + 1) * 32].reshape(4, 8, -1), y[i * 32:(i + 1) * 32].reshape(4, 8))
               for i in range(3)]
    kw = dict(sharding={"data": 2, "fsdp": 2}, accumulate_steps=4, lr=0.5)
    serial = ranks.run("bridged_steps", "mlp", cfg, params, batches, **kw)
    defer = ranks.run("bridged_steps", "mlp", cfg, params, batches, overlap="defer", **kw)
    for s, d in zip(serial, defer):
        assert s["losses"] == d["losses"]
        assert _equal(s["params"], d["params"])


def test_shard_map_mode_bit_identical_on_dp_mesh(ranks):
    """The explicit shard_map step with deferred bucketed psums on data=4:
    params bit for bit the serial step's (sums in rank order, exact
    power-of-two scales). The loss metric is a pmean per microbatch there
    and one reduction per step in the serial step: within 1 ulp-scale."""
    cfg, params, x, y = _mlp_problem()
    batches = [(x[i * 32:(i + 1) * 32].reshape(4, 8, -1), y[i * 32:(i + 1) * 32].reshape(4, 8))
               for i in range(3)]
    kw = dict(sharding={"data": 4}, accumulate_steps=4, lr=0.5)
    serial = ranks.run("bridged_steps", "mlp", cfg, params, batches, **kw)
    mapped = ranks.run("bridged_steps", "mlp", cfg, params, batches, overlap="shard_map", **kw)
    for s, m in zip(serial, mapped):
        assert _equal(s["params"], m["params"])
        np.testing.assert_allclose(m["losses"], s["losses"], rtol=1e-6)


@pytest.mark.parametrize("sharding", [{"data": 4}, {"data": 2, "fsdp": 2}],
                         ids=["dp4", "dp2xfsdp2"])
def test_trainer_accumulation_under_mesh(ranks, sharding):
    """run_step_trainer(accumulate_steps=4) on a mesh reaches the
    batch-32 run's params (the reference's bound, 5e-4 / 1e-5)."""
    cfg, params, x, y = _mlp_problem(n=128)
    base = ranks.run("trainer_run", cfg, params, x, y, sharding=sharding, num_epochs=1)
    acc = ranks.run("trainer_run", cfg, params, x, y, sharding=sharding, accumulate_steps=4,
                    batch_size=8, num_epochs=1)
    for a, b in zip(base, acc):
        assert a["step"] == b["step"] == 4
        for p, q in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            np.testing.assert_allclose(p, q, rtol=5e-4, atol=1e-5)


def test_trainer_overlap_grads_end_to_end(ranks):
    """run_step_trainer(overlap_grads=True) on data=4 (the shard_map mode,
    resolve_grad_overlap's pick there) reaches the serial run's final
    params bit for bit: the ambient grad_overlap_scope reaches the zoo
    factory's loop. (The defer mode's bits: the 2 x 2 case above.)"""
    cfg, params, x, y = _mlp_problem(n=128)
    kw = dict(sharding={"data": 4}, accumulate_steps=4, batch_size=8, num_epochs=1)
    serial = ranks.run("trainer_run", cfg, params, x, y, **kw)
    overlapped = ranks.run("trainer_run", cfg, params, x, y, overlap_grads=True, **kw)
    for s, o in zip(serial, overlapped):
        assert _equal(s["params"], o["params"])


def test_resolve_grad_overlap_selection(ranks):
    for got in ranks.run("overlap_choice"):
        assert got["dp"] == ("shard_map", ("data",))
        assert got["mixed"] == got["ruled"] == got["none"] == "defer"
        assert got["single"] is None


def test_grad_overlap_scope_is_ambient_and_modes_are_checked():
    import torch

    from unionml_tpu_torch.models.train import (
        GradOverlap, accumulated_value_and_grad, current_grad_overlap, grad_overlap_scope)

    with grad_overlap_scope(GradOverlap(mode="defer")):
        assert current_grad_overlap().mode == "defer"
    assert current_grad_overlap() is None

    def loss_fn(p, mb):
        return (p["w"] * mb).sum(), {}

    params, micro = {"w": torch.ones(3)}, torch.ones(2, 4, 3)
    with pytest.raises(ValueError, match="GradOverlap mode"):
        accumulated_value_and_grad(loss_fn, params, micro, overlap=GradOverlap(mode="wat"))
    with pytest.raises(ValueError, match="mesh"):
        accumulated_value_and_grad(loss_fn, params, micro, overlap=GradOverlap(mode="shard_map"))
