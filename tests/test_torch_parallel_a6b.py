"""The port's sequence, pipeline and expert parallelism (A6b) against the
JAX package's.

Inputs and weights are made from seeds with numpy or the JAX package and
go through both packages in fp32. The sharded ops and steps run in four
gloo ranks (:class:`torch_ranks.RankPool`, started once for the module
and joined lazily, so the ranks boot while the single-process cases run;
bodies in ``tests/torch_ranks_a6b.py``) on the reference tests' mesh
shapes over four ranks: (sequence 4), (sequence 2, data 2), (data 2,
sequence 2), (pipeline 4), (pipeline 2, data 2), (expert 2, data 2),
(expert 4) and (data 1, expert 2, tensor 2). As the reference's own
tests do, each is held against the JAX package's serial counterpart: the
full-score ``mha_reference`` (forward, and a cotangent's gradients by
``jax.vjp``), the serial ``lm_step`` (loss, aux loss, params after SGD),
the serial stages, the dense MoE reference, at the reference's
tolerances. The port's ring flash takes the plain versions of rows 9-11
and of the delta pass; in bf16, with the reference's ``output_delta``,
it is held to the JAX ring flash's own rounding points (on the same mesh
shape over four of the 8 virtual CPU devices, its Pallas kernels in
interpret mode), and C11's test shows what the delta pass changes.
Routing, dispatch, the MoE block, its int8 form, the MoE Llama's
``lm_step`` and generation run in this process. Planted faults must fail
their parity: a rotation whose backward turns the wrong way, a ring
backward on each step's own lse, a pipeline psum handing every stage the
stages' summed cotangent, a top-k breaking ties toward the higher index.
Phase 3i of ``chip_smoke.py`` is rehearsed on the CPU.
"""

import dataclasses
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import unionml_tpu.parallel as jpar
from torch_ranks import RankPool
from unionml_tpu.models import LLAMA_QUANT_PATTERNS as JPATTERNS
from unionml_tpu.models import llama as jllama
from unionml_tpu.models import make_generator as jmake_generator
from unionml_tpu.models import pipeline_lm as jpipeline_lm
from unionml_tpu.models import quantize_params as jquantize
from unionml_tpu.models import train as jtrain
from unionml_tpu.ops import moe as jmoe
from unionml_tpu.ops import ring_attention as jring

from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    from_jax_params,
    make_generator,
    quantize_params,
)
from unionml_tpu_torch.ops import attention as tatt
from unionml_tpu_torch.ops import moe

import torch_threads

torch_threads.share_cores()

# the module (the JAX package's ``attention`` name is the dispatcher function)
jatt = importlib.import_module("unionml_tpu.ops.attention")

FWD_ATOL = 2e-5      # the reference's forward tolerance (tests/unit/test_ops.py)
RING_FLASH_ATOL = 3e-5
GRAD_ATOL = 3e-4     # the reference's gradient tolerance
# bf16 with the JAX ring's rounding points: fp32 sums in another order can
# land an element on the other side of a bf16 rounding boundary, one ulp
# (2**-8 relative) of the element or of its larger neighbours' partial sums
BF16_TOL = dict(rtol=2**-6, atol=2**-6)
# the reference's own tolerances (tests/unit/test_sequence_parallel.py,
# tests/unit/test_pipeline.py)
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5
PIPE_FWD = dict(rtol=1e-5, atol=1e-5)
PIPE_GRAD = dict(rtol=1e-4, atol=1e-5)
PIPE_LOGITS = dict(rtol=2e-4, atol=2e-4)
N_STAGES = 4
DIM = 8
FP32 = dict(rtol=1e-5, atol=2e-5)   # the reference's dense-vs-EP tolerance
EP_GRAD_ATOL = 1e-4                  # the reference's EP gradient tolerance
MOE_PARAM_ATOL = 2e-5                # fp32 SGD steps, reduction order only


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process while the module runs: its
    tensors are tiny, and the suite runs several workers beside four gloo
    ranks a module, where more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def _pool():
    pool = RankPool(4, connect=False)   # the ranks boot while the first cases run
    yield pool
    pool.close()


_EARLY = {}


@pytest.fixture(scope="module", autouse=True)
def _expert_parallel_step_early(_pool):
    """As the module starts, a thread waits for the ranks to boot and
    submits the MoE Llama's expert-parallel step: the boot and DTensor's
    first sharding propagation over the (data, expert, tensor) mesh, most
    of that call, run while this process computes the single-process
    cases (:func:`ranks` collects it)."""
    ref = _jax_moe_init()
    cfg_dict = {f.name: getattr(ref["cfg"], f.name) for f in dataclasses.fields(LlamaConfig)}

    def submit():
        try:
            _pool.submit("bridged_steps", "llama", cfg_dict, ref["init"], [ref["tokens"]],
                         sharding={"data": -1, "expert": 2, "tensor": 2},
                         rules="LLAMA_MOE_PARTITION_RULES", lr=ref["lr"])
        except BaseException as e:   # raised again where the result is collected
            _EARLY["error"] = e

    _EARLY["thread"] = threading.Thread(target=submit, daemon=True)
    _EARLY["thread"].start()
    yield


@pytest.fixture
def ranks(_pool):
    """The ranks, the early call's result collected first."""
    thread = _EARLY.pop("thread", None)
    if thread is not None:
        thread.join(timeout=180)
        if "error" in _EARLY:
            raise _EARLY.pop("error")
        _EARLY["result"] = _pool.collect(timeout=180)[0]
    return _pool


def make_qkv(batch=2, seq=64, q_heads=4, kv_heads=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, q_heads, dim)).astype(np.float32)
    k = rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32)
    v = rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32)
    do = rng.standard_normal((batch, seq, q_heads, dim)).astype(np.float32)
    return q, k, v, do

def _jmesh(axes):
    return jpar.make_mesh(axes, devices=jax.devices()[:4])

_REF = {}

def _reference(q, k, v, do, *, causal):
    """The JAX package's ``mha_reference`` output and its vjp of ``do``
    (memoized per input: the fault tests reuse their parity test's)."""
    key = tuple((x.shape, x.tobytes()) for x in (q, k, v, do)) + (causal,)
    if key not in _REF:
        _REF[key] = _jax(lambda a, b, c: jatt.mha_reference(a, b, c, causal=causal),
                         q, k, v, do)
    return _REF[key]

def _jax(fn, q, k, v, do=None, dtype=jnp.float32):
    """``fn``'s output and, with ``do``, its vjp (numpy fp32)."""
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    grads = None if do is None else [np.asarray(g, np.float32)
                                     for g in vjp(jnp.asarray(do).astype(dtype))]
    return np.asarray(out, np.float32), grads

def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)

def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}

def _assert_params_close(port, ref, atol=PARAM_ATOL):
    got, want = _flat(port), _flat(_np(ref))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    assert worst <= atol, worst

def _llama(**overrides):
    jcfg = jllama.LlamaConfig.tiny(**{"vocab_size": 64, "dtype": "float32", **overrides})
    cfg = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig)
           if hasattr(jcfg, f.name)}
    return jcfg, cfg

def _setup(seq=32, batch=4, **overrides):
    """The reference's setup: the tiny config, tokens from PRNGKey(0),
    params from PRNGKey(1)."""
    jcfg, cfg = _llama(**overrides)
    module = jllama.Llama(jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(0), (batch, seq), 0, jcfg.vocab_size)
    params = module.init(jax.random.PRNGKey(1), tokens[:1])["params"]
    return jcfg, cfg, module, np.asarray(tokens), params

def _serial(module, params, batches, lr):
    """The JAX package's serial lm_step, SGD: losses, aux losses, params."""
    state = jtrain.TrainState.create(apply_fn=module.apply, params=params, tx=optax.sgd(lr))
    step = jax.jit(jtrain.lm_step(module))
    losses, auxes = [], []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux_loss"]))
    return losses, auxes, state.params

def _shifted(tokens):
    """The serial step's batch with the sequence-parallel loss convention
    (the last position's target ignore_id)."""
    targets = np.concatenate([tokens[:, 1:], np.full((tokens.shape[0], 1), -100)], axis=1)
    return (jnp.asarray(tokens), jnp.asarray(targets.astype(np.int32)))


def _t(a):
    return torch.from_numpy(np.array(a))

def _moe_weights(tokens=32, d=16, hidden=32, experts=8, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    x = jax.random.normal(ks[0], (tokens, d))
    router = jax.random.normal(ks[1], (d, experts)) * 0.5
    w_gate = jax.random.normal(ks[2], (experts, d, hidden)) * (d**-0.5)
    w_up = jax.random.normal(ks[3], (experts, d, hidden)) * (d**-0.5)
    w_down = jax.random.normal(ks[4], (experts, hidden, d)) * (hidden**-0.5)
    return [np.asarray(a) for a in (x, router, w_gate, w_up, w_down)]

@jax.jit
def _dense_moe_reference(x, router_kernel, w_gate, w_up, w_down):
    """The reference tests' dense reference: every routed token processed
    (``num_selected`` from the router's width: 2, or 1 for two experts)."""
    num_selected = 1 if router_kernel.shape[-1] == 2 else 2
    gate_logits = (x @ router_kernel).astype(jnp.float32)
    weights, indices, aux = jmoe.top_k_routing(gate_logits, num_selected)
    onehot = jax.nn.one_hot(indices, w_gate.shape[0], dtype=x.dtype)
    combine = jnp.einsum("tke,tk->te", onehot, weights.astype(x.dtype))
    gated = jax.nn.silu(jnp.einsum("td,edh->eth", x, w_gate))
    up = jnp.einsum("td,edh->eth", x, w_up)
    expert_out = jnp.einsum("eth,ehd->etd", gated * up, w_down)
    return jnp.einsum("etd,te->td", expert_out, combine), aux

def _llama_pair(**overrides):
    jcfg = jllama.LlamaConfig.tiny(**{"vocab_size": 64, "num_experts": 4, "num_selected": 2,
                                      "dtype": "float32", **overrides})
    cfg = LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig)
                         if hasattr(jcfg, f.name)})
    return jcfg, cfg

_JAX_STEPS = {}

def _jax_moe_init():
    """The JAX package's MoE Llama: its config, its init (numpy) and the
    tokens (made once for the module's tests)."""
    if "init" not in _JAX_STEPS:
        jcfg, cfg = _llama_pair()
        tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 16), 0, 64))
        jparams = jllama.Llama(jcfg).init(jax.random.PRNGKey(1), tokens[:1])["params"]
        _JAX_STEPS.update(jcfg=jcfg, cfg=cfg, tokens=tokens, jparams=jparams,
                          init=_np(jparams), lr=0.1)
    return _JAX_STEPS

def _jax_moe_steps(steps=2):
    """:func:`_jax_moe_init` and ``steps`` SGD lm_steps of it: losses, aux
    losses and the params after each step."""
    ref = _jax_moe_init()
    if "losses" not in ref:
        import optax

        jmodule = jllama.Llama(ref["jcfg"])
        state = jtrain.TrainState.create(apply_fn=jmodule.apply, params=ref["jparams"],
                                         tx=optax.sgd(ref["lr"]))
        step = jax.jit(jtrain.lm_step(jmodule))
        losses, auxes, params = [], [], []
        for _ in range(steps):
            state, m = step(state, jnp.asarray(ref["tokens"]))
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux_loss"]))
            params.append(_np(state.params))
        ref.update(losses=losses, aux=auxes, params=params)
    return ref

def _max_leaf_diff(port_params, jax_params):
    want = jax.tree_util.tree_leaves(jax_params)
    got = [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)
           for x in jax.tree_util.tree_leaves(port_params)]
    assert len(got) == len(want)
    return max(float(np.abs(a - b).max()) for a, b in zip(got, want))

def _tied_logits():
    """Gate logits with planted ties: rows of equal logits, and rows whose
    second and third experts tie (bf16 logits tie often)."""
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((16, 8)).astype(np.float32)
    rows[:4] = 0.25
    rows[4:8, 2] = rows[4:8, 5] = 3.0
    rows[8:12, 1] = 4.0
    rows[8:12, 6] = rows[8:12, 3] = 1.5
    return rows

def _generation_pair(quantized):
    jcfg, cfg = _llama_pair()
    jmodule = jllama.Llama(jcfg)
    params = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    if quantized:
        jcfg, cfg = _llama_pair(quantized=True)
        params = jquantize(params, JPATTERNS)
    return jcfg, cfg, params

# --------------------------------------------------------------------- #
# one process: attention
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_blockwise_matches_reference(causal, kv_heads):
    q, k, v, _ = make_qkv(kv_heads=kv_heads)
    want = jatt.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                    block_size=16)
    got = tatt.blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                   block_size=16)
    _close(got.numpy(), np.asarray(want), FWD_ATOL)
    ref = tatt.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    _close(got.numpy(), ref.numpy(), FWD_ATOL)

def test_blockwise_ragged_kv():
    """kv length not a multiple of the block size."""
    q, k, v, _ = make_qkv(seq=50)
    want = jatt.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                                    block_size=16)
    got = tatt.blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                   block_size=16)
    _close(got.numpy(), np.asarray(want), FWD_ATOL)

@pytest.mark.parametrize("impl", ["xla", "blockwise", "flash", "fused", "auto"])
def test_attention_dispatcher_matches_jax(impl):
    q, k, v, _ = make_qkv(seq=32, kv_heads=2, dim=32)
    want = jatt.attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True, impl=impl)
    got = tatt.attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl=impl)
    _close(got.numpy(), np.asarray(want), RING_FLASH_ATOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="ring")

def test_chip_smoke_virtual_ring_rehearsal():
    """Phase 3i (a) of ``chip_smoke.py`` on CPU tensors (the plain versions
    of rows 9-11 and the delta pass): four virtual shards of a causal GQA
    sequence through the ring's per-step functions against the unsharded
    op row by row, the two planted faults failing (the check raises
    otherwise)."""
    import chip_smoke

    out = chip_smoke.ring_kernel_check(device="cpu", shape=dict(b=1, s=64, h=4, kvh=2, d=16))
    assert out["checks"]["out"]["fault_rows_over_limit"] > 0
    assert out["checks"]["dq"]["fault_rows_over_limit"] > 0
    # the plain versions of the same per-step functions, at fp32: the ring
    # equals the unsharded op to fp32 noise
    assert out["checks"]["dq"]["max_row_rel_err"] < 1e-5

# --------------------------------------------------------------------- #
# one process: pipelined Llama, the smoke's rehearsal
# --------------------------------------------------------------------- #


def test_pipelined_rejects_moe_and_bad_split():
    from unionml_tpu_torch.models import create_pipelined_lm_state

    with pytest.raises(ValueError, match="not divisible"):
        create_pipelined_lm_state(LlamaConfig.tiny(num_layers=3), 2,
                                  torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="pipelined MoE"):
        create_pipelined_lm_state(LlamaConfig.tiny(num_experts=4), 2,
                                  torch.zeros(1, 4, dtype=torch.long))

def test_to_pipeline_params_validates_divisibility():
    from unionml_tpu_torch.models import to_pipeline_params

    with pytest.raises(ValueError, match="not divisible"):
        to_pipeline_params({}, LlamaConfig.tiny(num_layers=3), 2)
    with pytest.raises(NotImplementedError, match="quantization"):
        to_pipeline_params({}, LlamaConfig.tiny(quantized=True), 2)

def test_pipeline_from_jax_params_carries_the_stacked_tree():
    """The reference's pipelined tree bridges to the port's stacked tree
    leaf for leaf (and a tree stacked for another stage count is
    refused)."""
    from unionml_tpu_torch.models import from_jax_params, pipeline_from_jax_params
    from unionml_tpu_torch.models import to_pipeline_params
    from unionml_tpu_torch.models.train import tree_leaves

    jcfg, cfg, module, tokens, flat = _pp_setup(layers=4)
    config = LlamaConfig(**cfg)
    jtree = _np(jpipeline_lm.to_pipeline_params(flat, jcfg, 2))
    got = pipeline_from_jax_params(jtree, config, 2, device="cpu")
    want = to_pipeline_params(from_jax_params(_np(flat), config, device="cpu"), config, 2)
    assert jax.tree_util.tree_structure(_flat(got)) == jax.tree_util.tree_structure(_flat(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="stage"):
        pipeline_from_jax_params(jtree, config, 4, device="cpu")

def test_chip_smoke_parallel_rehearsal():
    """Phase 3i (b)-(d) of ``chip_smoke.py`` at tiny widths on CPU tensors
    over a one-rank gloo group: the sequence-parallel and MoE steps bit
    for bit against the plain steps, the pipelined step's update within
    the phase's bound, the int8 MoE block and generation."""
    import torch.distributed as dist

    import chip_smoke
    from unionml_tpu_torch.parallel import multihost_initialize

    cfg = LlamaConfig.tiny(vocab_size=64, dtype="float32", attn_impl="flash")
    moe = LlamaConfig.tiny(vocab_size=64, num_experts=4, num_selected=2, norm_impl="fused",
                           attn_impl="flash", dtype="float32")
    assert multihost_initialize(f"127.0.0.1:{chip_smoke.free_port()}", 1, 0, device="cpu")
    try:
        sp = chip_smoke.sequence_parallel_check(cfg, device="cpu", batch=2, seq=32, steps=1)
        pipe = chip_smoke.pipeline_check(cfg, device="cpu", batch=4, seq=32, steps=1)
        train = chip_smoke.moe_train_check(moe, device="cpu", seq=32, steps=1)
    finally:
        dist.destroy_process_group()
    serve = chip_smoke.moe_serve_check(
        dataclasses.replace(moe, quantized=True, prefill_impl="flash", dtype="bfloat16"),
        device="cpu", prompts=2, prompt_len=16, new_tokens=4)
    assert all(sp["bit_equal_per_step"]) and all(train["bit_equal_per_step"])
    assert max(pipe["update_rel_err"]) < 1e-4   # fp32 here: only the sum order differs
    assert all(a > 0 for a in train["aux_loss"])
    assert serve["int8_block_rel_err"] < chip_smoke.MOE_INT8_REL_MAX
    assert serve["tokens_shape"] == [2, 4]

# --------------------------------------------------------------------- #
# one process: routing, dispatch, the MoE block and Llama (the ranks run
# the early expert-parallel step meanwhile)
# --------------------------------------------------------------------- #


def test_make_dispatch_matches_jax_and_respects_capacity():
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 4)))
    want = jmoe.make_dispatch(jnp.asarray(logits), num_selected=2, capacity=5)
    got = moe.make_dispatch(_t(logits), num_selected=2, capacity=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **FP32)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    dispatch, combine = got[0], got[1]
    assert float(dispatch.sum(dim=(0, 2)).max()) <= 5
    assert float(dispatch.sum(dim=0).max()) <= 1.0
    assert float((combine * (1 - dispatch)).abs().max()) == 0.0

def test_make_dispatch_first_choices_win_slots():
    logits = np.array([[5.0, 1.0, -5.0]] * 3, np.float32)
    dispatch, _, _ = moe.make_dispatch(_t(logits), num_selected=2, capacity=2)
    per_expert = dispatch.sum(dim=2).numpy()
    np.testing.assert_array_equal(per_expert[:, 0], [1, 1, 0])
    np.testing.assert_array_equal(per_expert[:, 1], [1, 1, 0])

def test_top_k_routing_breaks_ties_toward_the_lower_index():
    logits = _tied_logits()
    want = jmoe.top_k_routing(jnp.asarray(logits), 2)
    got = moe.top_k_routing(_t(logits), 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **FP32)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)

def test_top_k_tie_break_toward_the_higher_index_fails(monkeypatch):
    """Planted fault: a top-k that orders equal probabilities by descending
    index must fail the routing parity on the tied rows."""
    def high_ties(probs, k):
        flipped = torch.flip(probs, dims=[-1])
        idx = torch.sort(flipped.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
        idx = probs.shape[-1] - 1 - idx
        return torch.gather(probs, -1, idx), idx

    monkeypatch.setattr(moe, "_top_k", high_ties)
    logits = _tied_logits()
    want = np.asarray(jmoe.top_k_routing(jnp.asarray(logits), 2)[1])
    got = moe.top_k_routing(_t(logits), 2)[1].numpy()
    assert (got != want).any()
    # the untied rows still agree: the fault is in the tie rule alone
    np.testing.assert_array_equal(got[12:], want[12:])

def test_moe_mlp_module_matches_jax():
    jm = jmoe.MoEMlp(num_experts=4, num_selected=2, hidden_dim=32, model_dim=16,
                     dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 16))
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    want, aux = jm.apply({"params": params}, x)
    block = moe.MoEMlp(4, 2, 32, 16, dtype=torch.float32)
    got, got_aux = block(jax.tree_util.tree_map(_t, _np(params)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-6)
    assert not np.allclose(got.numpy(), np.asarray(x))

def test_quantized_moe_matches_jax_and_fp_module():
    """``quantize_params`` writes the reference's int8 experts bit for bit;
    the int8 block matches the JAX int8 block and stays within the
    reference's 2% of the fp block."""
    fp = jmoe.MoEMlp(num_experts=4, num_selected=2, hidden_dim=32, model_dim=16,
                     dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 16))
    params = fp.init(jax.random.PRNGKey(1), x)["params"]
    ref, aux_ref = fp.apply({"params": params}, x)
    jq = jquantize({"moe": params}, JPATTERNS)["moe"]
    tq = quantize_params({"moe": jax.tree_util.tree_map(_t, _np(params))},
                         LLAMA_QUANT_PATTERNS)["moe"]
    assert tq["w_gate_q"].dtype == torch.int8 and tuple(tq["w_gate_scale"].shape) == (4, 32)
    for name in ("w_gate_q", "w_up_q", "w_down_q", "w_gate_scale", "w_up_scale",
                 "w_down_scale"):
        np.testing.assert_array_equal(tq[name].numpy(), np.asarray(jq[name]))
    qmod = jmoe.MoEMlp(num_experts=4, num_selected=2, hidden_dim=32, model_dim=16,
                       dtype=jnp.float32, quantized=True)
    want, _ = qmod.apply({"params": jq}, x)
    got, aux = moe.MoEMlp(4, 2, 32, 16, dtype=torch.float32, quantized=True)(tq, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    rel = float(np.linalg.norm(got.numpy() - np.asarray(ref)) / np.linalg.norm(ref))
    assert rel < 0.02, rel
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)

def test_quantized_moe_bf16_error_bounded():
    """bf16 compute: fp32 accumulation and the fp32 scale before one cast
    keep the int8 block within the reference's 5% of the fp32 block."""
    fp = jmoe.MoEMlp(num_experts=4, num_selected=2, hidden_dim=64, model_dim=32,
                     dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 32))
    params = fp.init(jax.random.PRNGKey(1), x)["params"]
    ref = np.asarray(fp.apply({"params": params}, x)[0])
    tq = quantize_params({"moe": jax.tree_util.tree_map(_t, _np(params))},
                         LLAMA_QUANT_PATTERNS)["moe"]
    out, _ = moe.MoEMlp(4, 2, 64, 32, dtype=torch.bfloat16, quantized=True)(
        tq, _t(x).to(torch.bfloat16))
    rel = float(np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref))
    assert rel < 0.05, rel

def test_migrate_moe_router_params_old_layout_restores():
    block = moe.MoEMlp(4, 2, 8, 8, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = {"router_kernel": torch.randn(8, 4, generator=gen),
              **{f"w_{n}": torch.randn(4, 8, 8, generator=gen) * 0.3
                 for n in ("gate", "up", "down")}}
    old = {k: v for k, v in params.items() if k != "router_kernel"}
    old["router"] = {"kernel": params["router_kernel"].to(torch.bfloat16),
                     "bias": torch.zeros(4, dtype=torch.bfloat16)}
    migrated = moe.migrate_moe_router_params({"block_0": {"moe": old},
                                              "head": {"kernel": torch.ones(8, 2)}})
    new = migrated["block_0"]["moe"]
    assert "router" not in new and new["router_kernel"].dtype == torch.float32
    assert torch.equal(migrated["head"]["kernel"], torch.ones(8, 2))
    out, aux = block(new, torch.ones(1, 3, 8))
    assert out.shape == (1, 3, 8) and np.isfinite(float(aux))

def test_moe_llama_lm_step_matches_jax():
    """Two SGD lm_steps of the MoE Llama from one JAX init: the loss, the
    aux loss (the layer mean of the blocks' load-balance losses) and the
    params match the JAX package's."""
    import torch_ranks

    from unionml_tpu_torch.models.train import TrainState, lm_step

    ref = _jax_moe_steps()
    cfg = ref["cfg"]
    module = Llama(cfg)
    state = TrainState.create(apply_fn=module, params=from_jax_params(ref["init"], cfg,
                                                                      device="cpu"),
                              tx=torch_ranks.sgd(ref["lr"]))
    step = lm_step(module)
    for loss, aux in zip(ref["losses"], ref["aux"]):
        state, m = step(state, _t(ref["tokens"]))
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(m["aux_loss"]), aux, rtol=1e-5)
        assert float(m["aux_loss"]) > 0
    assert _max_leaf_diff(state.params, ref["params"][-1]) <= MOE_PARAM_ATOL

def test_moe_llama_remat_gives_the_same_gradients():
    """``remat`` recomputes each block in the backward: the MoE block's
    sown aux loss still reaches the loss, with the same gradients."""
    from unionml_tpu_torch.models.llama import init_params
    from unionml_tpu_torch.models.train import value_and_grad

    _, cfg = _llama_pair(num_layers=1)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, 64, (2, 12), generator=torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        module = Llama(dataclasses.replace(cfg, remat=remat))
        sown = {}

        def loss(p, batch):
            logits = module(p, batch[:, :-1], sow=sown)
            return logits.float().logsumexp(-1).mean() + sum(sown["aux_losses"]), {}

        grads.append(value_and_grad(loss, params, tokens)[1])
        sown.clear()
    for a, b in zip(jax.tree_util.tree_leaves(grads[0]), jax.tree_util.tree_leaves(grads[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

def test_dense_llama_aux_loss_metric_is_zero():
    from unionml_tpu_torch.models import create_train_state, lm_step

    module = Llama(LlamaConfig.tiny(vocab_size=64, dtype="float32"))
    tokens = torch.randint(0, 64, (2, 8))
    state = create_train_state(module, tokens[:1])
    _, metrics = lm_step(module)(state, tokens)
    assert float(metrics["aux_loss"]) == 0.0

def test_moe_config_validation():
    with pytest.raises(ValueError, match="num_selected"):
        LlamaConfig.tiny(num_experts=1)
    with pytest.raises(ValueError, match="num_selected"):
        LlamaConfig.tiny(num_experts=4, num_selected=0)
    mixtral = LlamaConfig.mixtral_8x7b()
    jmixtral = jllama.LlamaConfig.mixtral_8x7b()
    for f in dataclasses.fields(LlamaConfig):
        if hasattr(jmixtral, f.name):
            assert getattr(mixtral, f.name) == getattr(jmixtral, f.name), f.name

def test_moe_lora_config_adapts_attention_only():
    """A ``lora_rank > 0`` MoE config carries adapters on attention only
    (the MoE block has no LoRA path), as in the reference."""
    from unionml_tpu_torch.models.llama import init_params

    _, cfg = _llama_pair(lora_rank=4)
    block = init_params(cfg, seed=0, device="cpu")["block_0"]
    assert "lora_a" in block["attn"]["q"] and "mlp" not in block
    assert set(block["moe"]) == {"router_kernel", "w_gate", "w_up", "w_down"}

def test_quantized_moe_llama_generation_matches_jax():
    """Greedy generation of the int8 MoE Llama: the JAX package's tokens."""
    jcfg, cfg, params = _generation_pair(quantized=True)
    prompt = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
    want = jmake_generator(jllama.Llama(jcfg), max_new_tokens=4)(params, jnp.asarray(prompt))
    got = make_generator(Llama(cfg), max_new_tokens=4)(
        from_jax_params(_np(params), cfg, device="cpu"), _t(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

def test_moe_llama_generation_logits_match_jax():
    """The fp MoE Llama: its logits match the JAX package's, and greedy
    generation gives tokens of the expected shape."""
    jcfg, cfg, params = _generation_pair(quantized=False)
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    want = np.asarray(jllama.Llama(jcfg).apply({"params": params}, jnp.asarray(prompt)))
    tparams = from_jax_params(_np(params), cfg, device="cpu")
    np.testing.assert_allclose(Llama(cfg)(tparams, _t(prompt)).detach().numpy(), want, **FP32)
    out = make_generator(Llama(cfg), max_new_tokens=4)(tparams, _t(prompt))
    assert tuple(out.shape) == (1, 4) and bool(((out >= 0) & (out < 64)).all())

# --------------------------------------------------------------------- #
# expert parallelism (ranks)
# --------------------------------------------------------------------- #


def test_moe_llama_expert_parallel_step_matches_serial(ranks):
    """The MoE Llama's lm_step through compile_step under
    ShardingConfig(data=-1, expert=2, tensor=2,
    rules=LLAMA_MOE_PARTITION_RULES): the expert weights shard over
    `expert` and their hidden dim over `tensor`, each rank runs its experts'
    slice and the partial outputs sum in rank order; an SGD step matches
    the JAX package's serial step."""
    got = _EARLY["result"]   # submitted as the module started
    ref = _jax_moe_steps()
    np.testing.assert_allclose(got["losses"], ref["losses"][:1], rtol=1e-5)
    assert _max_leaf_diff(got["params"], ref["params"][0]) <= MOE_PARAM_ATOL

@pytest.mark.parametrize("ep,axes", [(2, {"expert": 2, "data": 2}), (4, {"expert": 4})],
                         ids=["ep2", "ep4"])
def test_expert_parallel_matches_dense(ranks, ep, axes):
    x, router, w_gate, w_up, w_down = _moe_weights()
    ranks.submit("torch_ranks_a6b:ep_moe", x, router, w_gate, w_up, w_down, axes=axes,
                 num_selected=2, capacity=x.shape[0] // ep)
    ref, _ = _dense_moe_reference(*(jnp.asarray(a) for a in (x, router, w_gate, w_up, w_down)))
    got = ranks.collect()[0]
    np.testing.assert_allclose(got["out"], np.asarray(ref), rtol=0, atol=2e-5)
    assert np.isfinite(got["aux"])

def test_expert_parallel_gradients_match_dense(ranks):
    x, router, w_gate, w_up, w_down = _moe_weights(tokens=16, experts=4)
    do = np.asarray(jax.random.normal(jax.random.PRNGKey(9), x.shape))
    ranks.submit("torch_ranks_a6b:ep_moe", x, router, w_gate, w_up, w_down,
                 axes={"expert": 2, "data": 2}, num_selected=2, capacity=x.shape[0] // 2, do=do)

    def dense(x, w_gate, w_down):
        return _dense_moe_reference(x, jnp.asarray(router), w_gate, jnp.asarray(w_up),
                                    w_down)[0]

    _, vjp = jax.vjp(dense, *(jnp.asarray(a) for a in (x, w_gate, w_down)))
    want = vjp(jnp.asarray(do))
    for a, b in zip(ranks.collect()[0]["grads"], want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=EP_GRAD_ATOL)

def test_expert_parallel_capacity_drops_tokens(ranks):
    """Capacity 1 per expert: overflow tokens lose (part of) their MLP
    contribution, so the output differs from the uncapped reference."""
    x, router, w_gate, w_up, w_down = _moe_weights(tokens=32, experts=2)
    got = ranks.run("torch_ranks_a6b:ep_moe", x, router, w_gate, w_up, w_down,
                    axes={"expert": 2, "data": 2}, num_selected=1, capacity=1)[0]
    ref, _ = _dense_moe_reference(*(jnp.asarray(a) for a in (x, router, w_gate, w_up, w_down)))
    assert not np.allclose(got["out"], np.asarray(ref))

# --------------------------------------------------------------------- #
# ring, ring flash, Ulysses (ranks)
# --------------------------------------------------------------------- #


def _case(ranks, impl, q, k, v, do, *, axes, causal, grads=False, **kw):
    """The port's ``impl`` in the ranks and the JAX reference of the same
    inputs: (port result, reference output, reference gradients)."""
    ranks.submit("torch_ranks_a6b:attention_case", impl, q, k, v, axes=axes, causal=causal,
                 do=do if grads else None, block_size=8, **kw)
    want, want_g = _reference(q, k, v, do, causal=causal)
    return ranks.collect()[0], want, want_g

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(ranks, causal):
    q, k, v, do = make_qkv()
    got, want, _ = _case(ranks, "ring", q, k, v, do, axes={"sequence": 4}, causal=causal)
    _close(got["out"], want, FWD_ATOL)

def test_ring_attention_gqa(ranks):
    q, k, v, do = make_qkv(q_heads=8, kv_heads=2)
    got, want, _ = _case(ranks, "ring", q, k, v, do, axes={"sequence": 4}, causal=True)
    _close(got["out"], want, FWD_ATOL)

def _ring_grads(ranks, impl, q, k, v, do, axes, fault=""):
    return _case(ranks, impl, q, k, v, do, axes=axes, causal=True, grads=True, fault=fault)

def test_ring_attention_gradients_match_reference(ranks):
    """Sequence-parallel training: the backward differentiates through the
    kv rotation (the rotation's backward turns the other way)."""
    q, k, v, do = make_qkv()
    got, want, want_g = _ring_grads(ranks, "ring", q, k, v, do, {"sequence": 4})
    _close(got["out"], want, FWD_ATOL)
    for a, b in zip(got["grads"], want_g):
        _close(a, b, GRAD_ATOL)

def test_ring_gradients_fail_with_a_rotation_turning_the_wrong_way(ranks):
    """Planted fault: a rotation whose backward shifts the cotangent by
    ``+shift`` (the forward's way) must fail the gradient parity."""
    q, k, v, do = make_qkv()
    got, _, want_g = _ring_grads(ranks, "ring", q, k, v, do, {"sequence": 4},
                                 fault="ppermute_wrong_way")
    assert any(np.abs(a - b).max() > GRAD_ATOL for a, b in zip(got["grads"], want_g))

@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_reference(ranks, causal):
    q, k, v, do = make_qkv(seq=32, q_heads=8, kv_heads=8)
    got, want, _ = _case(ranks, "ulysses", q, k, v, do, axes={"sequence": 4}, causal=causal)
    _close(got["out"], want, FWD_ATOL)

def test_ulysses_gradients_match_reference(ranks):
    q, k, v, do = make_qkv(seq=32, q_heads=8, kv_heads=8)
    got, _, want_g = _ring_grads(ranks, "ulysses", q, k, v, do, {"sequence": 4})
    for a, b in zip(got["grads"], want_g):
        _close(a, b, GRAD_ATOL)

def test_ulysses_checks_head_divisibility_eagerly(ranks):
    assert "divisible by axis size" in ranks.run("torch_ranks_a6b:ulysses_refusal")[0]

@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_reference(ranks, causal):
    q, k, v, do = make_qkv(seq=32)
    got, want, _ = _case(ranks, "ring_flash", q, k, v, do, axes={"sequence": 4},
                         causal=causal)
    _close(got["out"], want, RING_FLASH_ATOL)

def test_ring_flash_gqa(ranks):
    q, k, v, do = make_qkv(seq=32, q_heads=4, kv_heads=2)
    got, want, _ = _case(ranks, "ring_flash", q, k, v, do, axes={"sequence": 2, "data": 2},
                         causal=True)
    _close(got["out"], want, RING_FLASH_ATOL)

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_ring_flash_gradients_match_reference(ranks, kv_heads):
    q, k, v, do = make_qkv(seq=16, q_heads=4, kv_heads=kv_heads, dim=8)
    got, want, want_g = _ring_grads(ranks, "ring_flash", q, k, v, do,
                                    {"sequence": 2, "data": 2})
    _close(got["out"], want, RING_FLASH_ATOL)
    for a, b in zip(got["grads"], want_g):
        _close(a, b, GRAD_ATOL)

def test_ring_flash_gradients_fail_on_each_steps_own_lse(ranks):
    """Planted fault: a ring backward that recomputes p against each
    step's own lse instead of the global one must fail."""
    q, k, v, do = make_qkv(seq=32)
    got, _, want_g = _ring_grads(ranks, "ring_flash", q, k, v, do, {"sequence": 4},
                                 fault="local_lse")
    assert any(np.abs(a - b).max() > GRAD_ATOL for a, b in zip(got["grads"], want_g))

def test_ring_flash_bf16_output_delta_matches_jax_rounding_points(ranks):
    """bf16, the reference's ``delta = rowsum(dO * O)`` (``delta_impl=
    "output_delta"``): the port's ring rounds where the JAX ring rounds
    (each step's partial output and gradients to bf16, fp32 merges and
    sums), so output and gradients agree within bf16 noise."""
    q, k, v, do = make_qkv(seq=64, q_heads=4, kv_heads=2, dim=16, seed=3)
    mesh = _jmesh({"sequence": 4})
    ranks.submit("torch_ranks_a6b:attention_case", "ring_flash", q, k, v,
                 axes={"sequence": 4}, causal=True, do=do, dtype="bfloat16",
                 delta_impl="output_delta")
    want, want_g = _jax(lambda a, b, c: jring.ring_flash_attention(a, b, c, mesh, causal=True,
                                                                    block_size=16),
                        q, k, v, do, dtype=jnp.bfloat16)
    got = ranks.collect()[0]
    np.testing.assert_allclose(got["out"], want, **BF16_TOL)
    for a, b in zip(got["grads"], want_g):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a / scale, b / scale, **BF16_TOL)

def _cancelling_inputs(seed=5, seq=64):
    """A causal GQA case whose value rows are nearly equal (v = 1 + 1e-3
    noise): ``dp - delta`` cancels, so a delta taken from the bf16 output
    loses what the gradients are made of (ROADMAP.md C7, C11)."""
    q, k, v, do = make_qkv(seq=seq, q_heads=4, kv_heads=2, dim=16, seed=seed)
    v = (1.0 + 1e-3 * v).astype(np.float32)
    return q, k, v, do

def test_ring_flash_delta_pass_c11(ranks):
    """C11: in bf16 the port's ring takes delta from the delta pass over
    every visiting shard (fp32 sums of p dp against the global lse), not
    from the bf16 ring output. On value rows that nearly cancel, its dq and
    dk stay close to the exact gradients of the same bf16 inputs, while
    the reference's output delta drifts by O's rounding: the delta pass's
    dq error is under a quarter of the output delta's."""
    q, k, v, do = _cancelling_inputs()
    kw = dict(axes={"sequence": 4}, causal=True, do=do, dtype="bfloat16")
    ranks.submit("torch_ranks_a6b:attention_case", "ring_flash", q, k, v, **kw)
    rounded = [torch.from_numpy(x).to(torch.bfloat16).double().requires_grad_(True)
               for x in (q, k, v)]
    exact = torch.autograd.grad(tatt.mha_reference(*rounded, causal=True), rounded,
                                grad_outputs=torch.from_numpy(do).to(torch.bfloat16).double())
    passed = ranks.collect()[0]["grads"]
    output = ranks.run("torch_ranks_a6b:attention_case", "ring_flash", q, k, v,
                       delta_impl="output_delta", **kw)[0]["grads"]

    def err(g, i):
        want = exact[i].numpy()
        return float(np.abs(g - want).max() / np.abs(want).max())

    assert err(passed[0], 0) < 0.25 * err(output[0], 0), (err(passed[0], 0), err(output[0], 0))
    assert err(passed[1], 1) < err(output[1], 1)
    # dv does not read delta: both forms give it alike
    np.testing.assert_array_equal(passed[2], output[2])

# --------------------------------------------------------------------- #
# sequence parallelism (ranks)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("attn", ["ring", "ring_flash", "ulysses"])
def test_sp_step_matches_serial(ranks, attn):
    jcfg, cfg, module, tokens, params = _setup()
    ranks.submit("torch_ranks_a6b:sp_steps", cfg, _np(params), [tokens],
                 axes={"data": 2, "sequence": 2}, attn=attn)
    losses, _, want = _serial(module, params, [_shifted(tokens)], 1e-2)
    got = ranks.collect()[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _assert_params_close(got["params"], want)

def test_sp_step_on_plain_params_matches_serial(ranks):
    """The step on params every rank holds in full (no compile_step): the
    replicated params' gradients come back whole through the shard_map's
    boundary."""
    jcfg, cfg, module, tokens, params = _setup()
    ranks.submit("torch_ranks_a6b:sp_steps", cfg, _np(params), [tokens],
                 axes={"data": 2, "sequence": 2}, attn="ring", placed=False)
    losses, _, want = _serial(module, params, [_shifted(tokens)], 1e-2)
    got = ranks.collect()[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _assert_params_close(got["params"], want)

def test_sp_loss_decreases_over_steps(ranks):
    _, cfg, _, tokens, params = _setup()
    got = ranks.run("torch_ranks_a6b:sp_steps", cfg, _np(params), [tokens] * 9,
                    axes={"data": 2, "sequence": 2}, attn="ring", lr=1e-1)[0]
    assert got["losses"][-1] < got["losses"][0]

def test_sp_rejects_bad_configs(ranks):
    got = ranks.run("torch_ranks_a6b:sp_refusals")[0]
    assert "ring" in got["attn"]

def test_sp_moe_step_matches_serial(ranks):
    """Long context x MoE: the aux loss re-formed from the pmean-ed
    token-mean fractions equals the serial step's exactly, and so do the
    loss and the updated params."""
    jcfg, cfg, module, tokens, params = _setup(num_experts=4, num_selected=2)
    ranks.submit("torch_ranks_a6b:sp_steps", cfg, _np(params), [tokens],
                 axes={"data": 2, "sequence": 2}, attn="ring")
    losses, auxes, want = _serial(module, params, [_shifted(tokens)], 1e-2)
    got = ranks.collect()[0]
    assert got["aux"][0] > 0
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], auxes, rtol=LOSS_RTOL)
    _assert_params_close(got["params"], want)

def test_sp_ulysses_head_divisibility_checked_eagerly(ranks):
    assert "kv heads" in ranks.run("torch_ranks_a6b:sp_refusals")[0]["ulysses"]

def test_sp_sequence_only_mesh(ranks):
    jcfg, cfg, module, tokens, params = _setup()
    ranks.submit("torch_ranks_a6b:sp_steps", cfg, _np(params), [tokens],
                 axes={"data": 1, "sequence": 4}, attn="ring", data_axis=None)
    losses, _, want = _serial(module, params, [_shifted(tokens)], 1e-2)
    got = ranks.collect()[0]
    assert np.isfinite(got["losses"][0])
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _assert_params_close(got["params"], want)

def test_sp_step_through_model_spec(ranks):
    """Full stack: @dataset.reader -> @model.train_step(sequence-parallel
    step) -> model.train() in every rank."""
    _, cfg = _llama(vocab_size=97)
    got = ranks.run("torch_ranks_a6b:sp_model_train", cfg, 32, 4, 16, timeout=120)
    assert all(np.isfinite(r["train"]) for r in got)

# --------------------------------------------------------------------- #
# pipeline parallelism (ranks)
# --------------------------------------------------------------------- #


def make_stages(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), N_STAGES)
    return [{"w": np.asarray(jax.random.normal(k, (DIM, DIM)) / np.sqrt(DIM)),
             "b": np.zeros((DIM,), np.float32)} for k in ks]

def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])

def _serial_stages(stages, x):
    for p in stages:
        x = _stage_fn(p, x)
    return x

@pytest.mark.parametrize("num_microbatches", [4, 8])
def test_pipeline_matches_serial_forward(ranks, num_microbatches):
    stages = make_stages()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, DIM)))
    got = ranks.run("torch_ranks_a6b:pipeline_case", stages, x,
                    axes={"pipeline": N_STAGES, "data": -1},
                    num_microbatches=num_microbatches)
    want = np.asarray(_serial_stages(stages, x))
    for r in got:   # the outputs replicated on every stage
        np.testing.assert_allclose(r["out"], want, **PIPE_FWD)

def _pipeline_grads(ranks, fault=""):
    stages = make_stages(seed=2)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (8, DIM)))
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (8, DIM)))
    ranks.submit("torch_ranks_a6b:pipeline_case", stages, x,
                 axes={"pipeline": N_STAGES, "data": -1}, num_microbatches=4, y=y,
                 fault=fault)
    stacked = {k: jnp.stack([s[k] for s in stages]) for k in ("w", "b")}

    def serial_loss(p):
        out = jnp.asarray(x)
        for s in range(N_STAGES):
            out = _stage_fn({k: v[s] for k, v in p.items()}, out)
        return jnp.mean((out - y) ** 2)

    want = jax.grad(serial_loss)(stacked)
    return ranks.collect(), want

def test_pipeline_gradients_match_serial(ranks):
    got, want = _pipeline_grads(ranks)
    for r in got:
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(want[k]), **PIPE_GRAD)

def test_pipeline_gradients_fail_when_the_psum_sums_the_stages(ranks):
    """Planted fault: every stage computes the loss from the replicated
    outputs; a final psum whose backward hands each stage the sum of all
    stages' cotangents makes the stage gradients 4x too large."""
    got, want = _pipeline_grads(ranks, fault="psum_sums_stages")
    ratio = np.abs(got[0]["grads"]["w"]).max() / np.abs(np.asarray(want["w"])).max()
    assert ratio == pytest.approx(N_STAGES, rel=1e-4)

def test_pipeline_rejects_bad_microbatching(ranks):
    got = ranks.run("torch_ranks_a6b:pipeline_refusals")[0]
    assert "not divisible" in got["divisible"]
    assert "bubble" in got["bubble"]
    assert "preserve activation shape" in got["shape"]

def _pp_setup(dtype="float32", vocab=64, layers=2):
    jcfg, cfg = _llama(vocab_size=vocab, num_layers=layers, dtype=dtype)
    module = jllama.Llama(jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(0), (8, 16), 0, vocab)
    flat = module.init(jax.random.PRNGKey(1), tokens[:1])["params"]
    return jcfg, cfg, module, np.asarray(tokens), flat

def test_pipelined_llama_logits_match_serial(ranks):
    jcfg, cfg, module, tokens, flat = _pp_setup()
    ranks.submit("torch_ranks_a6b:pipelined_llama", cfg, _np(flat), tokens,
                 axes={"pipeline": 2, "data": -1}, num_stages=2, num_microbatches=2)
    want = np.asarray(module.apply({"params": flat}, jnp.asarray(tokens)))
    for r in ranks.collect():
        np.testing.assert_allclose(r["logits"], want, **PIPE_LOGITS)

def _serial_pp_reference(module, flat, tokens, steps, lr):
    losses, _, params = _serial(module, flat, [jnp.asarray(tokens)] * steps, lr)
    return losses, jpipeline_lm.to_pipeline_params(params, module.config, 2)

def test_pipelined_lm_step_matches_serial_step(ranks):
    jcfg, cfg, module, tokens, flat = _pp_setup()
    ranks.submit("torch_ranks_a6b:pipelined_llama", cfg, _np(flat), tokens,
                 axes={"pipeline": 2, "data": -1}, num_stages=2, num_microbatches=2, steps=2)
    losses, want = _serial_pp_reference(module, flat, tokens, 2, 1e-2)
    got = ranks.collect()[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _assert_params_close(got["params"], want)

def test_pipelined_lm_step_composes_with_dp(ranks):
    """PP x DP through compile_step: ShardingConfig(pipeline=2, data=2,
    rules=PIPELINE_PARTITION_RULES), the microbatch rows sharded over
    data. The loss falls over 5 steps, and the first step's loss and
    params match the serial step's."""
    jcfg, cfg, module, tokens, flat = _pp_setup()
    ranks.submit("torch_ranks_a6b:pipelined_llama", cfg, _np(flat), tokens,
                 axes={"pipeline": 2, "data": 2}, num_stages=2, num_microbatches=2,
                 data_axis="data", steps=5, lr=0.1, compiled=True)
    losses, _ = _serial_pp_reference(module, flat, tokens, 1, 0.1)
    got = ranks.collect()[0]
    assert np.isfinite(got["losses"]).all() and got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["losses"][:1], losses, rtol=1e-4)
    one = ranks.run("torch_ranks_a6b:pipelined_llama", cfg, _np(flat), tokens,
                    axes={"pipeline": 2, "data": 2}, num_stages=2, num_microbatches=2,
                    data_axis="data", steps=1, lr=0.1, compiled=True)[0]
    _, want = _serial_pp_reference(module, flat, tokens, 1, 0.1)
    _assert_params_close(one["params"], want)

def test_pipeline_partition_rules_shard_state_via_compile_step(ranks):
    _, cfg, _, tokens, flat = _pp_setup()
    got = ranks.run("torch_ranks_a6b:pipelined_llama", cfg, _np(flat), tokens,
                    axes={"pipeline": 2, "data": -1}, num_stages=2, num_microbatches=2,
                    data_axis="data", steps=1, compiled=True)[0]
    # stage params shard over the pipeline axis (mesh dim 0), the rest whole
    assert got["placements"]["stage"] == "(Shard(dim=0), Replicate())"
    assert got["placements"]["embed"] == "(Replicate(), Replicate())"
    assert np.isfinite(got["losses"][0])
