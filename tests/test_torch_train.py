"""The port's training path against the JAX package on the CPU.

The optimizer chain against optax, ``classification_step`` for three
steps from the same bridged params and batches (plain and fused
implementations, gradient accumulation, a bf16 first moment), the batch
loader's order, and the ported ``vision_tpu`` template's ``model.train``
against the JAX template's; then the synthesized trainer's streaming
rules and the options that are not ported yet.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from unionml_tpu.data.native import BatchLoader as JBatchLoader
from unionml_tpu.data.native import epoch_permutation as jepoch_permutation
from unionml_tpu.models import ViT as JViT
from unionml_tpu.models import ViTConfig as JViTConfig
from unionml_tpu.models import train as jtrain

from unionml_tpu_torch import Model, telemetry
from unionml_tpu_torch.data import BatchLoader, epoch_permutation, prefetch_to_device
from unionml_tpu_torch.execution import run_step_trainer
from unionml_tpu_torch.models import (
    TrainState,
    ViT,
    ViTConfig,
    accumulated_value_and_grad,
    adamw,
    classification_step,
    create_train_state,
    make_evaluator,
    make_predictor,
    masked_cross_entropy,
    vit_from_jax_params,
)
from unionml_tpu_torch.models.train import tree_leaves
from unionml_tpu_torch.templates.vision_tpu import app as template

REPO = Path(__file__).resolve().parents[1]
TINY = dict(image_size=32, patch_size=8, num_classes=10, hidden_dim=64, num_layers=2,
            num_heads=4, mlp_dim=128, dtype="float32")
# fp32 on both sides: the same arithmetic in another summation order
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# after a few Adam steps of lr 1e-3 (each moves a param by up to ~1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _assert_trees_close(torch_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(torch_tree))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].detach().float().numpy(),
                                   np.asarray(leaf, np.float32), err_msg=jax.tree_util.keystr(path),
                                   **tol)


# --------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_matches_the_optax_chain(mu_dtype, weight_decay):
    """Five updates of random grads through the port's adamw and the
    reference's chain: updates, moments and the step count."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jtx = jtrain.adamw(1e-2, weight_decay=weight_decay,
                       mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    ttx = adamw(1e-2, weight_decay=weight_decay, mu_dtype=mu_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {"a": torch.tensor(params["a"]), "b": {"c": torch.tensor(params["b"]["c"])}}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(5):
        g = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        tu, tstate = ttx.update({"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}},
                                tstate, tp)
        jp = optax.apply_updates(jp, ju)
        tp = {"a": tp["a"] + tu["a"], "b": {"c": tp["b"]["c"] + tu["b"]["c"]}}
        _assert_trees_close(tu, ju, rtol=1e-5, atol=1e-7)
    adam = jstate[0]
    assert tstate["count"] == int(adam.count) == 5
    _assert_trees_close(tstate["mu"], adam.mu, rtol=1e-5, atol=1e-7)
    _assert_trees_close(tstate["nu"], adam.nu, rtol=1e-5, atol=1e-9)
    want_dtype = torch.bfloat16 if mu_dtype else torch.float32
    assert all(m.dtype == want_dtype for m in tree_leaves(tstate["mu"]))


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    targets = rng.integers(0, 7, size=(2, 5))
    targets[0, :2] = -100
    want = jtrain.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = masked_cross_entropy(torch.tensor(logits), torch.tensor(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------- #
# classification_step
# --------------------------------------------------------------------- #


def _states(cfg_kwargs, optimizer_kwargs):
    jcfg = JViTConfig(**cfg_kwargs)
    jmodule = JViT(jcfg)
    jstate = jtrain.create_train_state(
        jmodule, jnp.zeros((1, 32, 32, 3)),
        optimizer=jtrain.adamw(1e-3, **{
            k: (jnp.bfloat16 if k == "mu_dtype" else v) for k, v in optimizer_kwargs.items()
        }),
    )
    cfg = ViTConfig(**cfg_kwargs)
    tstate = TrainState.create(
        apply_fn=ViT(cfg),
        params=vit_from_jax_params(_np_tree(jstate.params), cfg, device="cpu"),
        tx=adamw(1e-3, **optimizer_kwargs),
    )
    return jmodule, jstate, tstate


@pytest.mark.parametrize("impl,accumulate,opt", [
    ("xla", 1, {"weight_decay": 1e-4}),
    ("fused", 1, {"weight_decay": 1e-4}),
    ("fused", 2, {"weight_decay": 1e-4}),
    ("xla", 1, {"mu_dtype": "bfloat16"}),
])
def test_classification_steps_match_jax(impl, accumulate, opt):
    """Three steps of ViT-tiny (fp32) from the same params and batches:
    losses, accuracies and every parameter (and the moments) after
    step 3. A bf16 first moment rounds to bf16 after each update, where
    fp32-level differences of the gradients can land on either side of a
    rounding boundary (2**-8 relative on that element's update), so that
    case is held to looser limits."""
    cfg = dict(TINY, attn_impl=impl, norm_impl=impl)
    bf16_mu = "mu_dtype" in opt
    loss_tol = dict(rtol=1e-4, atol=1e-6) if bf16_mu else LOSS_TOL
    param_tol = dict(rtol=1e-3, atol=1e-4) if bf16_mu else PARAM_TOL
    jmodule, jstate, tstate = _states(cfg, opt)
    jstep = jax.jit(jtrain.classification_step(jmodule, accumulate_steps=accumulate))
    tstep = classification_step(ViT(ViTConfig(**cfg)), accumulate_steps=accumulate)
    rng = np.random.default_rng(0)
    lead = (accumulate, 8 // accumulate) if accumulate > 1 else (8,)
    for _ in range(3):
        x = rng.normal(size=lead + (32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=lead).astype(np.int32)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **loss_tol)
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tstate.params, jstate.params, **param_tol)
    _assert_trees_close(tstate.opt_state["nu"], jstate.opt_state[0].nu, rtol=1e-3, atol=1e-9)


def test_accumulation_equals_one_big_batch():
    """Two microbatches of 4 give the grads of the batch of 8 (means of
    equal halves) up to fp32 summation order."""
    cfg = ViTConfig(**TINY)
    module = ViT(cfg)
    params = module.init(torch.Generator().manual_seed(0), torch.zeros(1))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=8))

    def loss_fn(p, batch):
        logits = module(p, batch[0])
        return torch.nn.functional.cross_entropy(logits, batch[1]), {}

    from unionml_tpu_torch.models.train import value_and_grad

    (loss, _), grads = value_and_grad(loss_fn, params, (x, y))
    (aloss, _), agrads = accumulated_value_and_grad(
        loss_fn, params, (x.reshape(2, 4, 32, 32, 3), y.reshape(2, 4)))
    torch.testing.assert_close(aloss, loss, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(agrads), tree_leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    with pytest.raises(NotImplementedError, match="A11"):
        accumulated_value_and_grad(loss_fn, params, (x[None], y[None]), overlap=object())


def test_evaluator_and_predictor_factories():
    cfg = ViTConfig(**TINY)
    module = ViT(cfg)
    state = create_train_state(module, torch.zeros(1, 32, 32, 3), seed=3)
    x = np.random.default_rng(2).normal(size=(5, 32, 32, 3)).astype(np.float32)
    preds = make_predictor(module)(state, x)
    assert preds.shape == (5,)
    acc = make_evaluator(module)(state, x, preds.numpy())
    assert acc == 1.0


# --------------------------------------------------------------------- #
# the data feed
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n,batch,seed", [(100, 32, 0), (17, 4, 12345), (64, 64, 7)])
def test_batch_loader_order_matches_jax(n, batch, seed):
    """Same seed, same permutation and batches as the reference loader."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = np.arange(n, dtype=np.int32)
    for epoch in range(3):
        np.testing.assert_array_equal(epoch_permutation(n, seed, epoch),
                                      jepoch_permutation(n, seed, epoch))
    ours = BatchLoader([x, y], batch_size=batch, seed=seed, drop_remainder=True)
    ref = JBatchLoader([x, y], batch_size=batch, seed=seed, drop_remainder=True)
    try:
        got = [b for e in range(2) for b in ours.epoch(e)]
        want = [b for e in range(2) for b in ref.epoch(e)]
    finally:
        ref.close()
    assert len(got) == len(want) == 2 * (n // batch)
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_prefetch_to_device_and_refusals():
    items = [(np.full((2, 3), i, np.float32), np.arange(2)) for i in range(5)]
    out = list(prefetch_to_device(iter(items), device="cpu"))
    assert len(out) == 5 and all(isinstance(t, torch.Tensor) for t in out[4])
    assert float(out[3][0][0, 0]) == 3.0
    with pytest.raises(NotImplementedError, match="double_buffer"):
        next(prefetch_to_device(iter(items), device="cpu", double_buffer=True))
    with pytest.raises(NotImplementedError, match="A11"):
        next(prefetch_to_device(iter(items), device="cpu", sharding=object()))


# --------------------------------------------------------------------- #
# the ported vision_tpu template against the JAX template
# --------------------------------------------------------------------- #


def _jax_template(monkeypatch):
    """The JAX package's vision_tpu template, its module switched to the
    fp32 tiny config (the template's bf16 matmuls round differently in
    XLA's and PyTorch's CPU kernels)."""
    path = REPO / "unionml_tpu" / "templates" / "vision_tpu" / "app.py"
    spec = importlib.util.spec_from_file_location("jax_vision_tpu_app", path)
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    monkeypatch.setattr(app, "module", JViT(JViTConfig(**TINY)))
    return app


def test_vision_template_trains_to_the_jax_templates_params(monkeypatch, tmp_path):
    """Same reader seed, splitter, trainer seed and batch order: the
    ported template's ``model.train`` ends at the JAX template's params
    and metrics; then predict, save and load."""
    japp = _jax_template(monkeypatch)
    jstate0 = japp.init({})
    cfg = ViTConfig(**TINY)
    model = template.build_model(cfg, name="vision_parity", reader_cache=False)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        # the JAX template's initial weights (flax initializers), bridged
        params = vit_from_jax_params(_np_tree(jstate0.params), cfg, device="cpu")
        return TrainState.create(
            apply_fn=ViT(cfg), params=params,
            tx=adamw(hyperparameters.get("learning_rate", 1e-3),
                     weight_decay=hyperparameters.get("weight_decay", 1e-4)),
        )

    kwargs = dict(hyperparameters={"learning_rate": 1e-3},
                  trainer_kwargs={"num_epochs": 2, "batch_size": 32}, n=160, seed=0)
    jstate, jmetrics = japp.model.train(**kwargs)
    tstate, tmetrics = model.train(**kwargs)
    assert tstate.step == int(jstate.step) == 2 * (128 // 32)
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)
    assert tmetrics == pytest.approx(jmetrics)
    x = np.random.default_rng(5).normal(size=(6, 32, 32, 3)).astype(np.float32)
    preds = model.predict(features=x)
    np.testing.assert_array_equal(preds, np.asarray(japp.model.predict(features=x)))
    path = tmp_path / "vit.pt"
    model.save(str(path))
    loaded = model.load(str(path))
    assert isinstance(loaded, TrainState) and loaded.step == tstate.step
    _assert_trees_close(loaded.params, jstate.params, **PARAM_TOL)
    np.testing.assert_array_equal(model.predict(features=x), preds)


def test_vision_template_trains_on_its_own_init():
    """The template as shipped (its own init, bf16 compute) on the CPU:
    the loss falls and the metrics are accuracies."""
    model = template.build_model(name="vision_own", reader_cache=False)
    reg = telemetry.get_registry()
    state, metrics = model.train(hyperparameters={"device": "cpu"},
                                 trainer_kwargs={"num_epochs": 3, "batch_size": 32},
                                 n=160, seed=1)
    assert state.step == 12 and set(metrics) == {"train", "test"}
    assert 0.0 <= metrics["test"] <= 1.0
    text = reg.exposition()
    for family in ("unionml_trainer_step_ms", "unionml_trainer_loss",
                   "unionml_trainer_steps_total", "unionml_trainer_examples_total"):
        assert family in text


# --------------------------------------------------------------------- #
# the synthesized trainer
# --------------------------------------------------------------------- #


def _stream_problem():
    cfg = ViTConfig(**dict(TINY, num_layers=1))
    module = ViT(cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 32, 32, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)
    state = create_train_state(module, torch.zeros(1, 32, 32, 3), learning_rate=0.05)
    return classification_step(module), state, x, y


def test_streaming_trainer_callable_per_epoch():
    step, state, x, y = _stream_problem()

    def epoch_stream():
        for i in range(0, 128, 32):
            yield (torch.from_numpy(x[i:i + 32]), torch.from_numpy(y[i:i + 32]))

    out = run_step_trainer(step_fn=step, state=state, features=epoch_stream, num_epochs=2)
    assert out.step == 8


def test_streaming_trainer_one_shot_iterator():
    step, state, x, y = _stream_problem()
    stream = ((x[i:i + 32], y[i:i + 32]) for i in range(0, 128, 32))
    out = run_step_trainer(step_fn=step, state=state, features=stream)
    assert out.step == 4


def test_streaming_trainer_rejections():
    step, state, x, y = _stream_problem()
    stream = iter([(x[:32], y[:32])])
    with pytest.raises(ValueError, match="cannot be replayed"):
        run_step_trainer(step_fn=step, state=state, features=stream, num_epochs=2)
    with pytest.raises(ValueError, match="streaming trainers"):
        run_step_trainer(step_fn=step, state=state, features=iter([]), targets=np.zeros(4))


def test_streaming_trainer_reiterable_loader_multi_epoch():
    step, state, x, y = _stream_problem()

    class Loader:  # DataLoader-like: __iter__ only, a fresh pass each time
        def __iter__(self):
            for i in range(0, 128, 64):
                yield (x[i:i + 64], y[i:i + 64])

    out = run_step_trainer(step_fn=step, state=state, features=Loader(), num_epochs=3)
    assert out.step == 6


def test_streaming_trainer_exhausted_callable_and_empty_stream_raise():
    step, state, x, y = _stream_problem()
    gen = ((x[i:i + 32], y[i:i + 32]) for i in range(0, 64, 32))
    with pytest.raises(ValueError, match="FRESH iterable"):
        run_step_trainer(step_fn=step, state=state, features=lambda: gen, num_epochs=3)
    with pytest.raises(ValueError, match="no batches in epoch 1"):
        run_step_trainer(step_fn=step, state=state, features=iter([]))


def test_trainer_accumulates_and_traces(tmp_path):
    """``accumulate_steps`` reshapes the fed rows into microbatches (one
    update per 2 x 16 rows), and ``profile_dir`` writes a trace."""
    step, state, x, y = _stream_problem()
    acc_step = classification_step(state.apply_fn, accumulate_steps=2)
    out = run_step_trainer(step_fn=acc_step, state=state, features=x, targets=y,
                           batch_size=16, accumulate_steps=2, profile_dir=str(tmp_path))
    assert out.step == 128 // 32
    assert (tmp_path / "trace.json").exists()
    with pytest.raises(ValueError, match="accumulate_steps must be"):
        run_step_trainer(step_fn=step, state=state, features=x, targets=y, accumulate_steps=0)


@pytest.mark.parametrize("option,match", [
    ({"sharding": object()}, "A11"),
    ({"overlap_grads": True}, "A11"),
    ({"checkpoint_dir": "ckpt"}, "checkpoint"),
    ({"goodput": True}, "GoodputTracker"),
    ({"double_buffer": True}, "threaded feed"),
])
def test_train_step_options_not_ported_raise(option, match):
    model = Model(name="refusals")
    with pytest.raises(NotImplementedError, match=match):
        model.train_step(lambda state, batch: (state, {}), **option)
    if "checkpoint_dir" not in option:
        step, state, x, y = _stream_problem()
        with pytest.raises(NotImplementedError):
            run_step_trainer(step_fn=step, state=state, features=x, targets=y, **option)


def test_train_step_guard_is_wired():
    from unionml_tpu_torch.type_guards import SignatureError

    with pytest.raises(SignatureError, match="step\\(state, batch\\)"):
        Model(name="guarded").train_step(lambda state: (state, {}))


def test_template_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = template.build_model(dataclasses.replace(ViTConfig(**TINY)), name="no_card",
                                 reader_cache=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.train(n=64)


def test_chip_smoke_vit_phases_rehearsal_on_cpu():
    """chip_smoke.py's ViT training phase and its full-width check at
    ViT-tiny on the CPU (the kernels' plain versions), as the script drives
    them on the card: the loss falls over the template's model.train, and
    the fused path's gradients match the plain path's."""
    import sys

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    cfg = dataclasses.replace(ViTConfig(**TINY), attn_impl="fused", norm_impl="fused")
    out = chip_smoke.vit_train_phase(cfg, device="cpu", batch=16, batches_per_epoch=4,
                                     epochs=2)
    assert out["steps"] == 8 and out["timed_steps"] == 6
    assert out["last_loss"] < out["first_loss"]
    assert out["launches"] == dict.fromkeys(chip_smoke.VIT_LAUNCHES_PER_STEP, 0)
    agree = chip_smoke.vit_grad_agreement(cfg, device="cpu", batch=8)
    assert agree["grad_tensors"] == len(tree_leaves(ViT(cfg).init(
        torch.Generator().manual_seed(0), torch.zeros(1, 32, 32, 3))))
    assert agree["min_grad_cosine"] > 0.9999
    assert agree["rerun_same_loss_bits"] and agree["rerun_same_param_bits"]
