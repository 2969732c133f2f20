"""Parity of the port's LoRA / QLoRA fine-tuning with the JAX package's.

``unionml_tpu_torch.models.lora`` against ``unionml_tpu.models.lora`` at
``LlamaConfig.tiny`` sizes in fp32 on the CPU, from the same numbers
(carried over with ``from_jax_params`` / ``lora_from_jax_state``; inputs
from numpy seeds; the JAX flash attention in Pallas interpret mode): the
LoRA forward on fp and int8 bases, three ``lm_step``s with and without
``remat``, xla and flash attention, and with gradient accumulation; the
int8 weight product's input gradient against ``jax.grad``; ``merge_lora``;
then the port's own rules (identity at init, the frozen base, tree
surgery, validation messages, the int4 refusal, the serving surface,
checkpoints) and a CPU rehearsal of ``chip_smoke.py``'s QLoRA phase.
"""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.models import LLAMA_QUANT_PATTERNS as J_QUANT_PATTERNS
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JLlamaConfig
from unionml_tpu.models import create_lora_train_state as jcreate_lora_train_state
from unionml_tpu.models import merge_lora as jmerge_lora
from unionml_tpu.models import quantize_params as jquantize_params
from unionml_tpu.models import train as jtrain
from unionml_tpu.models.quantization import QuantizedDenseGeneral as JQuantizedDenseGeneral

from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    LoRATrainState,
    adamw,
    create_lora_train_state,
    from_jax_params,
    init_params,
    lm_step,
    lora_from_jax_state,
    make_lm_predictor,
    masked_cross_entropy,
    merge_lora,
    merge_param_trees,
    quantize_params,
    split_lora_params,
)
from unionml_tpu_torch.models.lora import LoRADenseGeneral
from unionml_tpu_torch.models.quantization import QuantizedDenseGeneral
from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

import torch_threads

torch_threads.share_cores()

REPO = Path(__file__).resolve().parents[1]
RANK = 4
TOKENS = jnp.zeros((1, 8), jnp.int32)
# fp32 on both sides: the same arithmetic in another summation order
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# adapters after three Adam steps at lr 1e-3 (as tests/test_torch_lm_train.py
# argues: an element whose gradient sits at Adam's eps scale can move by a
# fraction of lr differently under another summation order)
PARAM_TOL = dict(rtol=1e-4, atol=2.5e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _assert_trees_close(torch_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(torch_tree))
    assert len(got) == len(want)
    for path, leaf in want:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key].detach().float().numpy(),
                                   np.asarray(leaf, np.float32), err_msg=key, **tol)


def _jax_base(quantized: bool):
    """A fp32 JAX base tree of LlamaConfig.tiny (quantize_params'd when
    ``quantized``)."""
    params = JLlama(JLlamaConfig.tiny(dtype="float32")).init(
        jax.random.PRNGKey(0), TOKENS)["params"]
    return jquantize_params(params, J_QUANT_PATTERNS) if quantized else params


def _with_random_b(adapters, seed: int):
    """Adapters with ``lora_b`` drawn N(0, 0.05^2) from a numpy seed, so the
    delta is non-zero and both factors get a gradient."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            return jnp.asarray(rng.normal(0, 0.05, leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, adapters)


def _tokens(seed: int, shape=(2, 17)):
    return np.random.default_rng(seed).integers(1, 500, size=shape).astype(np.int32)


# --------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("quantized", [False, True], ids=["fp_base", "int8_base"])
def test_lora_forward_matches_jax(quantized):
    """The LoRA forward of Llama(lora_rank=4) on the bridged tree (a
    non-zero lora_b) against the JAX model's logits, fp and int8 bases."""
    jcfg = JLlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=quantized)
    jstate = jcreate_lora_train_state(JLlama(jcfg), TOKENS, base_params=_jax_base(quantized))
    full = jax.tree_util.tree_map(np.asarray, jstate.full_params())
    full = merge_param_trees(full, _np_tree(_with_random_b(jstate.params, 1)))
    tokens = _tokens(1)
    want = JLlama(jcfg).apply({"params": jax.tree_util.tree_map(jnp.asarray, full)},
                              jnp.asarray(tokens))
    cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=quantized)
    with torch.no_grad():
        got = Llama(cfg)(from_jax_params(full, cfg, device="cpu"), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("remat,attn_impl", [(False, "xla"), (True, "xla"), (False, "flash"),
                                             (True, "flash"), (True, "accumulate")])
def test_qlora_steps_match_jax(remat, attn_impl):
    """Three lm_steps of the QLoRA tiny Llama (int8 base, rank 4) in both
    packages from one bridged state (AdamW lr 1e-3): the loss at every
    step, then the adapters; the port's frozen base keeps its bits and its
    AdamW state is adapter-sized. ``accumulate``: flash attention, batches
    of two microbatches (accumulate_steps=2)."""
    accumulate = 2 if attn_impl == "accumulate" else 1
    impl = "flash" if attn_impl == "accumulate" else attn_impl
    kwargs = dict(dtype="float32", lora_rank=RANK, quantized=True, remat=remat,
                  attn_impl=impl)
    jcfg = JLlamaConfig.tiny(**kwargs)
    jmodule = JLlama(jcfg)
    jstate = jcreate_lora_train_state(jmodule, TOKENS, base_params=_jax_base(True),
                                      optimizer=jtrain.adamw(1e-3))
    cfg = LlamaConfig.tiny(**kwargs)
    tstate = lora_from_jax_state(jstate, cfg, "cpu", learning_rate=1e-3)
    frozen = [t.clone() for t in tree_leaves(tstate.frozen_params)]
    jstep = jax.jit(jtrain.lm_step(jmodule, accumulate_steps=accumulate))
    tstep = lm_step(Llama(cfg), accumulate_steps=accumulate)
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = rng.integers(1, 500, size=(4, 17)).astype(np.int32)
        if accumulate > 1:
            batch = batch.reshape(2, 2, 17)
        jstate, jm = jstep(jstate, jnp.asarray(batch))
        tstate, tm = tstep(tstate, torch.from_numpy(batch).long())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)
    assert all(torch.equal(a, b) for a, b in zip(frozen, tree_leaves(tstate.frozen_params)))
    adapters = sum(t.numel() for t in tree_leaves(tstate.params))
    moments = sum(t.numel() for t in tree_leaves((tstate.opt_state["mu"],
                                                  tstate.opt_state["nu"])))
    assert moments == 2 * adapters
    assert sorted(k for k, v in tstate.opt_state.items() if not isinstance(v, dict)) == ["count"]
    with pytest.raises(ValueError, match="fresh state only"):
        lora_from_jax_state(jstate, cfg, "cpu")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_classification_step_trains_adapters_only(accumulate):
    """classification_step over a LoRATrainState (a LoRA classifier on an
    int8 base), with and without gradient accumulation: the loss falls,
    only the adapters move, the base keeps its bits, and the AdamW state
    is adapter-sized."""
    from unionml_tpu_torch.models import classification_step

    gen = torch.Generator().manual_seed(11)
    layer = LoRADenseGeneral(3, 2, quantized=True, dtype=torch.float32)
    base = {"kernel_q": torch.randint(-127, 128, (8, 3), generator=gen, dtype=torch.int8),
            "scale": torch.full((3,), 0.01)}
    adapters = {"lora_a": torch.randn(8, 2, generator=gen) / 8**0.5, "lora_b": torch.zeros(2, 3)}
    state = LoRATrainState.create(apply_fn=layer, params=adapters, tx=adamw(5e-2),
                                  frozen_params=base)
    frozen = [t.clone() for t in tree_leaves(base)]
    features = torch.randn(8, 8, generator=gen)
    labels = torch.arange(8) % 3
    batch = (features, labels)
    if accumulate > 1:
        batch = (features.reshape(2, 4, 8), labels.reshape(2, 4))
    step = classification_step(layer, accumulate_steps=accumulate)
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert all(torch.equal(a, b) for a, b in zip(frozen, tree_leaves(state.frozen_params)))
    assert not torch.equal(state.params["lora_b"], adapters["lora_b"])
    assert sum(t.numel() for t in tree_leaves((state.opt_state["mu"], state.opt_state["nu"]))) \
        == 2 * (16 + 6)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_int8_product_input_gradient_matches_jax_grad(compute):
    """The int8 weight product's gradient with respect to its input (the
    QLoRA base's only one) against jax.grad of the JAX layer on the same
    numbers. fp32: summation order only. bf16: the port rounds the scaled
    fp32 cotangent to bf16 before its product (the reference's TPU runs
    that fp32 x bf16 product as one bf16 pass; JAX on the CPU keeps fp32),
    then both round dx to bf16: within 2^-7 of dx's largest entry."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    kernel_q = rng.integers(-127, 128, size=(48, 3 * 8)).astype(np.int8)
    scale = (rng.random(24) / 100 + 1e-3).astype(np.float32)
    cot = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    params = {"kernel_q": kernel_q, "scale": scale}

    jlayer = JQuantizedDenseGeneral(features=(3, 8), dtype=jnp.dtype(compute))

    def jloss(xj):
        y = jlayer.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, xj)
        return jnp.sum(y.astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x).astype(compute)), np.float32)
    layer = QuantizedDenseGeneral((3, 8), dtype=compute)
    xt = torch.from_numpy(x).to(getattr(torch, compute)).requires_grad_()
    y = layer({k: torch.from_numpy(v) for k, v in params.items()}, xt)
    (got,) = torch.autograd.grad((y.float() * torch.from_numpy(cot)).sum(), xt)
    assert got.dtype == xt.dtype
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=float(np.abs(want).max()) * 2**-7)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp_base", "int8_base"])
def test_merge_lora_matches_jax(quantized):
    """merge_lora on the same tree (non-zero adapters) in both packages: fp
    kernels within fp32 rounding; int8 kernel_q equal but for 1-LSB flips
    at rounding ties (the delta is a product summed in another order), at
    most one element in 2000, and the scales within fp32 rounding."""
    jcfg = JLlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=quantized)
    jstate = jcreate_lora_train_state(JLlama(jcfg), TOKENS, base_params=_jax_base(quantized))
    full = jax.tree_util.tree_map(np.asarray, jstate.full_params())
    full = merge_param_trees(full, _np_tree(_with_random_b(jstate.params, 4)))
    want = jmerge_lora(jax.tree_util.tree_map(jnp.asarray, full), alpha=jcfg.lora_alpha)
    cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=quantized)
    got = merge_lora(from_jax_params(full, cfg, device="cpu"), alpha=cfg.lora_alpha)
    assert split_lora_params(got)[0] == {}
    want_leaves = dict((jax.tree_util.keystr(p), np.asarray(x))
                       for p, x in jax.tree_util.tree_leaves_with_path(want))
    got_leaves = dict((jax.tree_util.keystr(p), x)
                      for p, x in jax.tree_util.tree_leaves_with_path(got))
    assert got_leaves.keys() == want_leaves.keys()
    flips = total = 0
    for key, w in want_leaves.items():
        g = got_leaves[key].numpy()
        assert g.dtype == w.dtype, key
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, key
            flips += int((diff > 0).sum())
            total += diff.size
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=key)
    assert flips <= total / 2000
    # the merged tree is what the rank-0 model of the same base loads
    serve_cfg = dataclasses.replace(cfg, lora_rank=0)
    from_jax_params(_np_tree(want), serve_cfg, device="cpu")


# --------------------------------------------------------------------- #
# the port's own rules
# --------------------------------------------------------------------- #


def _port_base(quantized: bool):
    cfg = LlamaConfig.tiny(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    return quantize_params(params, LLAMA_QUANT_PATTERNS) if quantized else params


@pytest.mark.parametrize("quantized", [False, True], ids=["fp_base", "int8_base"])
def test_lora_init_is_identity(quantized):
    """lora_b starts at zero: the step-0 forward is the base model's bit
    for bit."""
    base = _port_base(quantized)
    cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=quantized)
    state = create_lora_train_state(Llama(cfg), torch.zeros(1, 8, dtype=torch.long),
                                    base_params=base)
    tokens = torch.from_numpy(_tokens(5)).long()
    with torch.no_grad():
        lora = Llama(cfg)(state.full_params(), tokens)
        plain = Llama(dataclasses.replace(cfg, lora_rank=0))(base, tokens)
    assert torch.equal(lora, plain)
    b_leaves = [x for p, x in jax.tree_util.tree_leaves_with_path(state.params)
                if jax.tree_util.keystr(p).endswith("['lora_b']")]
    assert len(b_leaves) == 7 * cfg.num_layers
    assert all(torch.count_nonzero(b) == 0 for b in b_leaves)


def test_remat_adapters_receive_the_same_gradients():
    """Under remat (non-reentrant checkpointing) the adapters, nested in
    each block's param dict, get gradients, and the same ones as without
    remat; a recomputation that dropped them would give zeros."""
    base = _port_base(True)
    grads = {}
    for remat in (False, True):
        cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=True, remat=remat,
                               attn_impl="flash")
        state = create_lora_train_state(Llama(cfg), torch.zeros(1, 8, dtype=torch.long),
                                        base_params=base, seed=3)
        gen = torch.Generator().manual_seed(4)
        adapters = {blk: {part: {site: {"lora_a": leaves["lora_a"],
                                        "lora_b": 0.05 * torch.randn(leaves["lora_b"].shape,
                                                                     generator=gen)}
                                 for site, leaves in sites.items()}
                          for part, sites in parts.items()}
                    for blk, parts in state.params.items()}
        module = Llama(cfg)

        def loss_fn(p, batch, module=module, frozen=state.frozen_params):
            logits = module(merge_param_trees(frozen, p), batch[:, :-1])
            return masked_cross_entropy(logits, batch[:, 1:]), {}

        _, grads[remat] = value_and_grad(loss_fn, adapters, torch.from_numpy(_tokens(6)).long())
    for a, b in zip(tree_leaves(grads[False]), tree_leaves(grads[True])):
        assert torch.count_nonzero(b) > 0
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_split_merge_roundtrip():
    full = init_params(LlamaConfig.tiny(lora_rank=2), seed=1, device="cpu")
    lora, base = split_lora_params(full)
    assert lora and base
    assert set(lora["block_0"]["attn"]["q"]) == {"lora_a", "lora_b"}
    assert "lora_a" not in base["block_0"]["attn"]["q"]
    assert "lm_head" not in lora and "embed" not in lora
    rebuilt = merge_param_trees(base, lora)
    assert [k for k, _ in jax.tree_util.tree_leaves_with_path(rebuilt)] == \
        [k for k, _ in jax.tree_util.tree_leaves_with_path(full)]
    assert all(a is b for a, b in zip(tree_leaves(rebuilt), tree_leaves(full)))


def test_tree_walkers_accept_any_mapping():
    """Trees may arrive as read-only Mappings: the walkers traverse any
    Mapping, not just dict."""
    tree = types.MappingProxyType({
        "block": types.MappingProxyType({
            "q": {"kernel": torch.zeros(4, 4), "lora_a": torch.ones(4, 2),
                  "lora_b": torch.zeros(2, 4)},
            "norm": {"scale": torch.ones(4)},
        })
    })
    adapters, base = split_lora_params(tree)
    assert set(adapters["block"]["q"]) == {"lora_a", "lora_b"}
    assert set(base["block"]) == {"q", "norm"}
    merged = merge_param_trees(types.MappingProxyType(base), adapters)
    assert set(merged["block"]["q"]) == {"kernel", "lora_a", "lora_b"}
    folded = merge_lora(tree, alpha=4.0)
    assert set(folded["block"]["q"]) == {"kernel"}


def test_create_lora_state_validations():
    example = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="no lora_a/lora_b"):
        create_lora_train_state(Llama(LlamaConfig.tiny()), example)
    module = Llama(LlamaConfig.tiny(lora_rank=RANK))
    good = create_lora_train_state(module, example, base_params=_port_base(False))
    with pytest.raises(ValueError, match="already contain lora"):
        create_lora_train_state(module, example, base_params=good.full_params())
    wrong = init_params(LlamaConfig.tiny(num_layers=1), seed=0, device="cpu")
    with pytest.raises(ValueError, match="structure does not match"):
        create_lora_train_state(module, example, base_params=wrong)
    narrow = init_params(LlamaConfig.tiny(mlp_dim=96), seed=0, device="cpu")
    with pytest.raises(ValueError, match="leaf shape"):
        create_lora_train_state(module, example, base_params=narrow)
    with pytest.raises(ValueError, match="lora_rank >= 1"):
        LoRADenseGeneral(8, 0)
    with pytest.raises(ValueError, match="beside neither"):
        merge_lora({"q": {"lora_a": torch.ones(4, 2), "lora_b": torch.ones(2, 4)}}, alpha=1.0)


def test_bridge_checks_adapter_shapes():
    """from_jax_params takes lora_a / lora_b beside a base site of a
    lora_rank > 0 config, checked against its geometry, and refuses them
    on a rank-0 config or at another rank."""
    full = init_params(LlamaConfig.tiny(lora_rank=RANK), seed=2, device="cpu")
    tree = jax.tree_util.tree_map(lambda t: t.numpy(), full)
    from_jax_params(tree, LlamaConfig.tiny(lora_rank=RANK), device="cpu")
    with pytest.raises(ValueError, match="unexpected leaf"):
        from_jax_params(tree, LlamaConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="lora_a has shape"):
        from_jax_params(tree, LlamaConfig.tiny(lora_rank=2), device="cpu")


def test_lora_with_int4_is_refused():
    with pytest.raises(ValueError, match="LoRA/QLoRA requires weight_bits=8"):
        Llama(LlamaConfig.tiny(lora_rank=RANK, quantized=True, weight_bits=4))


def test_lora_state_through_the_predictor(monkeypatch):
    """A LoRATrainState passed straight to make_lm_predictor (with a
    system_prefix) resolves to its full params: the same tokens as the
    merged tree on the rank-0 model, and its prefix cache built once for
    repeated calls with the same state."""
    from unionml_tpu_torch.models import generate

    calls = []
    real = generate.make_prefix_cache

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(generate, "make_prefix_cache", counting)
    cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=True)
    state = create_lora_train_state(Llama(cfg), torch.zeros(1, 8, dtype=torch.long),
                                    base_params=_port_base(True))
    gen = torch.Generator().manual_seed(7)
    state = dataclasses.replace(state, params=jax.tree_util.tree_map(
        lambda t: 0.05 * torch.randn(t.shape, generator=gen) if t.shape[0] == RANK else t,
        state.params))
    prefix = [11, 12, 13]
    predictor = make_lm_predictor(Llama(cfg), max_new_tokens=4, bucket_lens=(16,),
                                  system_prefix=prefix)
    first = predictor(state, [[5, 6, 7, 8]])
    again = predictor(state, [[5, 6, 7, 8]])
    assert len(calls) == 1
    assert again == first and len(first[0]) == 4
    assert predictor(state.full_params(), [[5, 6, 7, 8]]) == first


def test_lora_state_checkpoint_round_trip(tmp_path):
    """A trained LoRATrainState through the async checkpoint manager into a
    fresh state of the same structure: adapters, AdamW state, counters and
    the frozen base come back with the same bits."""
    from unionml_tpu_torch.checkpoint import AsyncCheckpointManager

    cfg = LlamaConfig.tiny(dtype="float32", lora_rank=RANK, quantized=True)
    module = Llama(cfg)
    example = torch.zeros(1, 8, dtype=torch.long)
    state = create_lora_train_state(module, example, base_params=_port_base(True),
                                    learning_rate=1e-2)
    step = lm_step(module)
    tokens = torch.from_numpy(_tokens(8)).long()
    for _ in range(2):
        state, _ = step(state, tokens)
    fresh = create_lora_train_state(
        module, example, seed=5,
        base_params=quantize_params(init_params(LlamaConfig.tiny(dtype="float32"), seed=9,
                                                device="cpu"), LLAMA_QUANT_PATTERNS))
    with AsyncCheckpointManager(tmp_path / "ckpt") as manager:
        manager.save(2, state)
        manager.wait()
        restored = manager.restore(fresh)
    assert isinstance(restored, LoRATrainState) and restored.step == 2
    assert restored.opt_state["count"] == 2
    for name in ("params", "frozen_params", "opt_state"):
        want, got = tree_leaves(getattr(state, name)), tree_leaves(getattr(restored, name))
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    state, m1 = step(state, tokens)
    restored, m2 = step(restored, tokens)
    assert torch.equal(m1["loss"], m2["loss"])


# --------------------------------------------------------------------- #
# a CPU rehearsal of chip_smoke.py's QLoRA phase
# --------------------------------------------------------------------- #


def test_chip_smoke_qlora_phase_on_cpu():
    """chip_smoke's QLoRA phase and its agreement at tiny width on the CPU
    (the kernels' plain versions): model.train over a LoRA state, the
    base's bits unchanged, adapter-sized AdamW state, the loss falling,
    gradients against the plain path, reruns with the same loss bits, the
    merged tree within its limit and served."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = LlamaConfig.tiny(lora_rank=RANK, quantized=True, remat=True, attn_impl="flash")
    out = chip_smoke.qlora_train_phase(cfg, device="cpu", seq=48, steps=8)
    assert out["adapters"] == chip_smoke.adapter_count(cfg)
    assert out["adamw_moment_elements"] == 2 * out["adapters"]
    assert out["base_bits_unchanged"] and out["last_loss"] < out["first_loss"]
    agreement = chip_smoke.qlora_agreement(cfg, device="cpu", seq=48, layers=2)
    assert agreement["min_grad_cosine"] >= chip_smoke.QLORA_GRAD_COSINE_MIN
    assert agreement["rerun_same_loss_bits"]
    assert agreement["merge_rel_err"] <= chip_smoke.QLORA_MERGE_LIMIT
    assert len(agreement["merged_served"]) == 4
