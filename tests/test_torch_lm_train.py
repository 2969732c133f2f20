"""Parity of the port's Llama LM training path with the JAX package's.

``lm_step`` over ``Llama(attn_impl="flash")`` (the differentiable flash
attention; the JAX side runs its Pallas kernels in interpret mode), from
the same params (carried over with ``from_jax_params``) and the same
batches made with numpy from a seed, in fp32 on both sides; the LM app's
``model.train`` in both packages; per-block recomputation; the ``auto``
routing above the fused limit; and a CPU rehearsal of ``chip_smoke.py``'s
Llama phases at tiny width (the kernels' plain versions).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu import Dataset as JDataset
from unionml_tpu import Model as JModel
from unionml_tpu.models import Llama as JLlama
from unionml_tpu.models import LlamaConfig as JLlamaConfig
from unionml_tpu.models import train as jtrain

from unionml_tpu_torch.models import (
    Llama,
    LlamaConfig,
    TrainState,
    adamw,
    from_jax_params,
    init_params,
    lm_step,
    masked_cross_entropy,
)
from unionml_tpu_torch.models.train import tree_leaves, value_and_grad

REPO = Path(__file__).resolve().parents[1]
TINY = dict(attn_impl="flash", dtype="float32")
# fp32 on both sides: the same arithmetic in another summation order
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# after a few Adam steps of lr 1e-3: each moves a param by up to ~1e-3,
# by lr * g / (|g| + 1e-8) on the first. Where a gradient element lies at
# Adam's eps scale (|g| ~ 1e-8; about one element in 4096 here), an fp32
# summation-order difference of a few 1e-8 in it moves that param by up to
# a quarter of lr differently, so the absolute limit is 2.5e-4; the
# gradients themselves are held tightly by test_lm_grads_match_jax
PARAM_TOL = dict(rtol=1e-4, atol=2.5e-4)
# fp32 gradients of one loss (entries ~1e-3): summation order only
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _assert_trees_close(torch_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(torch_tree))
    assert len(got) == len(want)
    for path, leaf in want:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key].detach().float().numpy(), np.asarray(leaf, np.float32),
                                   err_msg=key, **tol)


def _states(cfg_kwargs):
    jcfg = JLlamaConfig.tiny(**cfg_kwargs)
    jmodule = JLlama(jcfg)
    jstate = jtrain.create_train_state(jmodule, jnp.zeros((1, 8), jnp.int32),
                                       optimizer=jtrain.adamw(1e-3))
    cfg = LlamaConfig.tiny(**cfg_kwargs)
    tstate = TrainState.create(apply_fn=Llama(cfg),
                               params=from_jax_params(_np_tree(jstate.params), cfg, device="cpu"),
                               tx=adamw(1e-3))
    return jmodule, jstate, cfg, tstate


def _batch(form: str, rng):
    """A batch of 4 sequences of 33 tokens in the step's three forms."""
    tokens = rng.integers(0, 512, size=(4, 33)).astype(np.int32)
    if form == "tokens":
        return tokens
    if form == "pairs":
        labels = tokens[:, 1:].copy()
        labels[0, :5] = -100           # unsupervised positions
        labels[2, 20:] = -100
        return (tokens[:, :-1], labels)
    return tokens.reshape(2, 2, 33)    # "accumulate": two microbatches of 2


def _jax_batch(batch):
    return tuple(map(jnp.asarray, batch)) if isinstance(batch, tuple) else jnp.asarray(batch)


def _torch_batch(batch):
    if isinstance(batch, tuple):
        return tuple(torch.from_numpy(x).long() for x in batch)
    return torch.from_numpy(batch).long()


@pytest.mark.parametrize("form", ["tokens", "pairs", "accumulate"])
def test_lm_steps_match_jax(form):
    """Three lm_steps of LlamaConfig.tiny(attn_impl="flash") in fp32 from
    the same params: loss, perplexity and aux_loss at every step, then
    every parameter and the second moments; the trained JAX params go
    through the weight bridge unchanged."""
    accumulate = 2 if form == "accumulate" else 1
    jmodule, jstate, cfg, tstate = _states(TINY)
    jstep = jax.jit(jtrain.lm_step(jmodule, accumulate_steps=accumulate))
    tstep = lm_step(Llama(cfg), accumulate_steps=accumulate)
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = _batch(form, rng)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for key in ("loss", "perplexity"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **LOSS_TOL)
        assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)
    _assert_trees_close(tstate.opt_state["nu"], jstate.opt_state[0].nu, rtol=1e-3, atol=1e-9)
    bridged = from_jax_params(_np_tree(jstate.params), cfg, device="cpu")
    _assert_trees_close(bridged, jstate.params, rtol=0, atol=0)


def test_lm_grads_match_jax():
    """One lm_step loss's gradients, port against JAX, from the same params
    and tokens (flash attention, fp32): every parameter's gradient."""
    jmodule, jstate, cfg, tstate = _states(TINY)
    tokens = np.random.default_rng(7).integers(0, 512, size=(4, 33)).astype(np.int32)

    def jloss(params):
        logits = jmodule.apply({"params": params}, jnp.asarray(tokens[:, :-1]))
        return jtrain.masked_cross_entropy(logits, jnp.asarray(tokens[:, 1:]))

    def tloss(params, batch):
        return masked_cross_entropy(Llama(cfg)(params, batch[:, :-1]), batch[:, 1:]), {}

    jgrads = jax.grad(jloss)(jstate.params)
    (loss, _), tgrads = value_and_grad(tloss, tstate.params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(float(loss), float(jloss(jstate.params)), **LOSS_TOL)
    _assert_trees_close(tgrads, jgrads, **GRAD_TOL)


def test_remat_gives_the_same_loss_and_grads():
    """remat=True recomputes each block in the backward: the same loss and
    gradients as remat=False."""
    cfg = LlamaConfig.tiny(**TINY)
    params = init_params(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 41)))
    out = {}
    for remat in (False, True):
        module = Llama(dataclasses.replace(cfg, remat=remat))

        def loss_fn(p, batch, module=module):
            logits = module(p, batch[:, :-1])
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), batch[:, 1:].reshape(-1)), {}

        out[remat] = value_and_grad(loss_fn, params, tokens)
    (loss_a, _), grads_a = out[False]
    (loss_b, _), grads_b = out[True]
    torch.testing.assert_close(loss_b, loss_a, rtol=0, atol=0)
    for a, b in zip(tree_leaves(grads_a), tree_leaves(grads_b)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_auto_routes_to_flash_above_the_fused_limit(monkeypatch):
    """attn_impl="auto" takes the flash op above MAX_FUSED_SEQ tokens (the
    limit lowered to 16 here rather than running 1k tokens) and the fused
    op up to it; the auto model's logits equal the flash model's above."""
    from unionml_tpu_torch.ops import flash_attention as tflash
    from unionml_tpu_torch.ops import fused_attention as tfused

    monkeypatch.setattr(tfused, "MAX_FUSED_SEQ", 16)
    calls = []
    real = tflash.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_attention", counting)
    cfg = LlamaConfig.tiny(attn_impl="auto", dtype="float32")
    params = init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 512, size=(2, 24)))
    with torch.no_grad():
        Llama(cfg)(params, tokens[:, :12])
        assert calls == []
        auto = Llama(cfg)(params, tokens)
        assert calls == [24] * cfg.num_layers
        flash = Llama(dataclasses.replace(cfg, attn_impl="flash"))(params, tokens)
    torch.testing.assert_close(auto, flash, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# the LM app in both packages
# --------------------------------------------------------------------- #


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _jax_lm_app(jcfg, tokens_fn):
    """The LM app in the JAX package: the same reader, splitter and parser
    as chip_smoke.build_lm_app, ``init=`` a TrainState, ``@model.train_step``
    over the reference's lm_step, an evaluator giving the mean cross
    entropy."""
    module = JLlama(jcfg)
    dataset = JDataset(name="jax_lm_dataset", test_size=0.2)

    @dataset.reader
    def reader(n: int = 64, seq: int = 4096, seed: int = 0) -> dict:
        tokens = tokens_fn(n, seq, jcfg.vocab_size, seed)
        return {"features": tokens[:, :-1], "targets": tokens[:, 1:]}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        idx = np.arange(len(data["features"]))
        if shuffle:
            np.random.default_rng(random_state).shuffle(idx)
        cut = int(len(idx) * (1 - test_size))
        return ({key: val[idx[:cut]] for key, val in data.items()},
                {key: val[idx[cut:]] for key, val in data.items()})

    @dataset.parser
    def parser(data: dict, features, targets):
        return (data["features"], data["targets"])

    def init(learning_rate: float = 1e-3) -> jtrain.TrainState:
        return jtrain.create_train_state(module, jnp.zeros((1, 8), jnp.int32),
                                         learning_rate=learning_rate)

    model = JModel(name="jax_lm", init=init, dataset=dataset)
    step = jtrain.lm_step(module)

    @model.train_step
    def train_step(state, batch):
        return step(state, batch)

    @model.evaluator
    def evaluator(state: jtrain.TrainState, features: np.ndarray, targets: np.ndarray) -> float:
        logits = state.apply_fn({"params": state.params}, jnp.asarray(features))
        return float(jtrain.masked_cross_entropy(logits, jnp.asarray(targets)))

    return model, init


def test_lm_app_trains_to_the_jax_apps_params():
    """The LM app of chip_smoke.py (port) and the same spec in the JAX
    package, from the same initial params (the JAX init's, bridged), the
    same reader seed, split and batch order: model.train ends at the same
    params and evaluation losses."""
    chip_smoke = _chip_smoke()
    jcfg = JLlamaConfig.tiny(**TINY)
    cfg = LlamaConfig.tiny(**TINY)
    jmodel, jinit = _jax_lm_app(jcfg, chip_smoke.lm_tokens)
    model = chip_smoke.build_lm_app(cfg, name="lm_parity")
    jparams0 = _np_tree(jinit().params)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        return TrainState.create(apply_fn=Llama(cfg),
                                 params=from_jax_params(jparams0, cfg, device="cpu"),
                                 tx=adamw(hyperparameters.get("learning_rate", 1e-3)))

    kwargs = dict(hyperparameters={"learning_rate": 1e-3},
                  trainer_kwargs={"num_epochs": 2, "batch_size": 4}, n=20, seq=33, seed=0)
    jstate, jmetrics = jmodel.train(**kwargs)
    tstate, tmetrics = model.train(**kwargs)
    assert tstate.step == int(jstate.step) == 2 * (16 // 4)
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)
    assert set(tmetrics) == set(jmetrics) == {"train", "test"}
    for split in tmetrics:
        np.testing.assert_allclose(tmetrics[split], jmetrics[split], rtol=1e-4)


def test_chip_smoke_llama_phases_rehearsal_on_cpu():
    """chip_smoke.py's Llama training phase (the LM app's model.train) and
    its gradient check at tiny width on the CPU, as the script drives them
    on the card: the loss falls, no kernel launches on the CPU, the flash
    path's gradients match the plain path's and a rerun gives the same
    loss bits."""
    chip_smoke = _chip_smoke()
    cfg = LlamaConfig.tiny(**TINY)
    out = chip_smoke.lm_train_phase(cfg, device="cpu", batch=2, seq=65, batches_per_epoch=4,
                                    epochs=2)
    assert out["steps"] == 8 and out["timed_steps"] == 6
    assert out["last_loss"] < out["first_loss"]
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert out["params"] == sum(p.numel() for p in tree_leaves(init_params(cfg, device="cpu")))
    agree = chip_smoke.lm_grad_agreement(cfg, device="cpu", batch=2, seq=65)
    assert agree["grad_tensors"] == len(tree_leaves(init_params(cfg, device="cpu")))
    assert agree["min_grad_cosine"] > 0.9999
    assert agree["rerun_same_loss_bits"]


def test_llama_lc_geometry():
    """LlamaConfig.llama_lc() is benchmarks/train_throughput.py's
    long-context Llama: the benchmark's fields (train_throughput.py:86-89)
    in both packages, and its params (embedding and LM head 24.6M each, 12
    blocks of 6.29M: 124.67M)."""
    bench = dict(vocab_size=32_000, hidden_dim=768, num_layers=12, num_heads=12,
                 num_kv_heads=4, mlp_dim=2048, max_len=4096, attn_impl="flash")
    cfg, jcfg = LlamaConfig.llama_lc(), JLlamaConfig(**bench)
    for field in (*bench, "rope_theta", "norm_eps", "norm_impl", "dtype", "remat"):
        assert getattr(cfg, field) == getattr(jcfg, field)
    assert cfg.head_dim == 64 and cfg.norm_impl == "xla"
    assert LlamaConfig.llama_lc(num_layers=2).num_layers == 2
    d, v, m = cfg.hidden_dim, cfg.vocab_size, cfg.mlp_dim
    block = 2 * d + d * d * 2 + 2 * d * cfg.num_kv_heads * cfg.head_dim + 3 * d * m
    total = 2 * v * d + d + cfg.num_layers * block
    assert total == 124_668_672


@pytest.mark.parametrize("b,sq,skv,h,kvh,causal", [
    (1, 300, 300, 4, 2, True), (2, 200, 200, 4, 2, False), (2, 40, 200, 4, 2, True),
])
def test_chip_smoke_row_check_rejects_a_dropped_tile(b, sq, skv, h, kvh, causal):
    """chip_smoke.py's check of rows 9-11 on the CPU: the plain versions
    pass against themselves, and the planted fault (each query's last
    visible key tile skipped) fails it in every tensor, in a share of rows
    that the check reports."""
    chip_smoke = _chip_smoke()
    from unionml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.normal(size=(b, sq, h, 64)).astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, skv, kvh, 64)).astype(np.float32)).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, scale=64**-0.5)
    out, lse = fa.flash_fwd_plain(q, k, v, **kw)
    want = dict(zip(("out", "dq", "dk", "dv"),
                    (out, *fa.flash_bwd_plain(q, k, v, do, out, lse, **kw))))
    fault = dict(zip(want, chip_smoke.dropped_tile_fault(q, k, v, do, out, lse, **kw)))
    checks = chip_smoke.check_flash_rows("plain", want, want, fault)
    for name, chk in checks.items():
        assert chk["max_row_rel_err"] == 0 and chk["fault_rows_over_limit"] > 0
        with pytest.raises(AssertionError, match="disagrees"):
            chip_smoke.check_rows(name, fault[name], want[name], chk["limit"])
    # the check passes a fault only by failing: want against itself as the fault
    with pytest.raises(AssertionError, match="planted fault"):
        chip_smoke.check_flash_rows("plain", want, want, want)
