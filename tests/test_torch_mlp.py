"""The port's MLP classifier against the JAX package on the CPU.

``Mlp`` with the JAX weights carried over by ``mlp_from_jax_params``:
fp32 and bf16 logits, twenty ``classification_step`` updates from the
same params and batches, the reference's own MLP test mirrored on the
port, dropout from an explicit generator, the bridge's refusals and the
no-CPU-default rule. The MLP runs no kernel.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from unionml_tpu.models import Mlp as JMlp
from unionml_tpu.models import MlpConfig as JMlpConfig
from unionml_tpu.models import train as jtrain

from unionml_tpu_torch.models import (
    Mlp,
    MlpConfig,
    TrainState,
    adamw,
    classification_step,
    create_train_state,
    init_mlp_params,
    make_evaluator,
    make_predictor,
    mlp_from_jax_params,
)

import torch_threads

torch_threads.share_cores()

# fp32 on both sides: the same arithmetic in another summation order
FP32 = dict(rtol=1e-5, atol=1e-5)
# after twenty Adam steps of lr 1e-3 (each moves a param by up to ~1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# bf16: the same rounding points, one or two bf16 ulps (2**-7 relative)
BF16 = dict(rtol=2**-6, atol=2**-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _pair(dtype="float32", hidden=(32, 16), classes=5, features=(4, 6)):
    jcfg = JMlpConfig(num_classes=classes, hidden_dims=hidden, dtype=dtype)
    cfg = MlpConfig(**dataclasses.asdict(jcfg))
    jmodule = JMlp(jcfg)
    jparams = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1,) + features))["params"]
    return jmodule, jparams, Mlp(cfg), mlp_from_jax_params(_np_tree(jparams), cfg, device="cpu")


def _assert_trees_close(torch_tree, jax_tree, **tol):
    want = jax.tree_util.tree_leaves_with_path(jax_tree)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(torch_tree))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].detach().float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", FP32), ("bfloat16", BF16)])
def test_mlp_logits_match_jax(dtype, tol):
    """Logits of ``[B, 4, 6]`` inputs (flattened to 24 features), fp32
    compute within fp32 sum order, bf16 compute (fp32 head) within bf16
    ulps."""
    jmodule, jparams, module, params = _pair(dtype)
    x = np.random.default_rng(0).normal(size=(7, 4, 6)).astype(np.float32)
    want = np.asarray(jmodule.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = module(params, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_mlp_classification_steps_match_jax():
    """Twenty ``classification_step`` updates (AdamW) from the same params
    and batches: losses, accuracies and every param at the end."""
    jmodule, jparams, module, params = _pair()
    jstate = jtrain.TrainState.create(apply_fn=jmodule.apply, params=jparams,
                                      tx=jtrain.adamw(1e-3, weight_decay=1e-4))
    state = TrainState.create(apply_fn=module, params=params, tx=adamw(1e-3, weight_decay=1e-4))
    jstep = jax.jit(jtrain.classification_step(jmodule))
    step = classification_step(module)
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = rng.normal(size=(16, 4, 6)).astype(np.float32)
        y = rng.integers(0, 5, size=16).astype(np.int32)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    assert state.step == int(jstate.step) == 20
    _assert_trees_close(state.params, jstate.params, **PARAM_TOL)


def test_mlp_forward_and_training_converges():
    """tests/unit/test_models.py:32 on the port."""
    cfg = MlpConfig(num_classes=2, hidden_dims=(32,))
    module = Mlp(cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    state = create_train_state(module, torch.from_numpy(x[:2]), learning_rate=1e-2)
    step = classification_step(module)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for _ in range(100):
        state, metrics = step(state, batch)
    assert float(metrics["accuracy"]) > 0.9
    assert make_evaluator(module)(state, x, y) > 0.9
    assert make_predictor(module)(state, x).shape == (64,)


def test_mlp_dropout_draws_from_its_generator():
    """``train=True`` with ``dropout`` keeps ~(1 - rate) of the hidden
    units scaled by 1 / (1 - rate), reproducibly from one generator seed;
    evaluation (and the reference's ``classification_step``, which never
    passes ``train``) runs no dropout; training without a generator
    raises."""
    cfg = MlpConfig(num_classes=3, hidden_dims=(256,), dropout=0.25, dtype="float32")
    module = Mlp(cfg)
    params = module.init(torch.Generator().manual_seed(0), torch.zeros(1, 8))
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    plain = module(params, x)
    a = module(params, x, train=True, generator=torch.Generator().manual_seed(2))
    b = module(params, x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    hidden = torch.relu(x @ params["dense_0"]["kernel"] + params["dense_0"]["bias"])
    from unionml_tpu_torch.models.mlp import dropout

    dropped = dropout(hidden, 0.25, torch.Generator().manual_seed(3))
    kept = dropped != 0
    share = kept[hidden != 0].float().mean().item()
    assert 0.7 < share < 0.8
    torch.testing.assert_close(dropped[kept], hidden[kept] / 0.75)
    with pytest.raises(ValueError, match="generator"):
        module(params, x, train=True)
    assert torch.equal(module(params, x, train=False), plain)


def test_mlp_bridge_refuses_wrong_trees():
    _, jparams, _, _ = _pair()
    tree = _np_tree(jparams)
    cfg = MlpConfig(num_classes=5, hidden_dims=(32, 16), dtype="float32")
    with pytest.raises(ValueError, match="dense_1/kernel has shape"):
        mlp_from_jax_params(tree, dataclasses.replace(cfg, hidden_dims=(32, 8)), device="cpu")
    with pytest.raises(ValueError, match="head/kernel has shape"):
        mlp_from_jax_params(tree, dataclasses.replace(cfg, num_classes=4), device="cpu")
    with pytest.raises(ValueError, match="unexpected leaf dense_0/scale"):
        mlp_from_jax_params(dict(tree, dense_0=dict(tree["dense_0"], scale=np.ones(32))), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="missing param dense_2"):
        mlp_from_jax_params(tree, dataclasses.replace(cfg, hidden_dims=(32, 16, 8)),
                            device="cpu")


def test_mlp_init_params_follow_the_reference_tree():
    jmodule, jparams, module, _ = _pair()
    params = init_mlp_params(module.config, 24, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    want = {jax.tree_util.keystr(p): x.shape
            for p, x in jax.tree_util.tree_leaves_with_path(jparams)}
    got = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want


def test_mlp_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, jparams, module, _ = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mlp_params(module.config, 24)
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp_from_jax_params(_np_tree(jparams), module.config)
