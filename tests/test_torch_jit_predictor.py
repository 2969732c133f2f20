"""``@model.predictor(jit=True)``: the port's captured predictor.

On the card ``jit=True`` runs the predictor body as CUDA graphs
(:func:`unionml_tpu_torch.execution.jit_predictor`, card cases in
``tests/test_torch_cuda.py``); a model object on the CPU runs the body as
called, which is what these tests hold against the JAX package's
``jax.jit``-ed predictors:

- the ported ``basic_tpu`` and ``vision_tpu`` templates (both
  ``jit=True`` again, as the reference's) predict what the JAX templates
  predict on the same weights (the JAX templates' initial states, bridged),
  exactly (argmax of fp32 logits);
- the twin of ``tests/unit/test_train_step.py:84``: an app whose
  ``train_step`` trains and whose ``jit=True`` predictor predicts;
- the bounded per-function cache and ``clear_jit_cache``;
- the call signature: it changes with the features' shapes, dtypes and
  tree structure and with the model object's tensors, not with an
  in-place update of them.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unionml_tpu.model import ModelArtifact as JModelArtifact
from unionml_tpu.models.vit import ViT as JViT
from unionml_tpu.models.vit import ViTConfig as JViTConfig
from unionml_tpu_torch import Dataset, Model, ModelArtifact, execution
from unionml_tpu_torch.models import TrainState, ViT, ViTConfig, adamw, create_train_state
from unionml_tpu_torch.models.convert import vit_from_jax_params
from unionml_tpu_torch.models.train import value_and_grad
from unionml_tpu_torch.templates.vision_tpu import app as vision_template

import torch_threads

torch_threads.share_cores()

REPO = Path(__file__).resolve().parents[1]
TINY = dict(image_size=32, patch_size=8, num_classes=10, hidden_dim=64, num_layers=2,
            num_heads=4, mlp_dim=128, dtype="float32")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def test_basic_tpu_template_jit_predictor_matches_the_jax_template():
    japp = _load(REPO / "unionml_tpu" / "templates" / "basic_tpu" / "app.py", "jax_basic_jit")
    app = _load(REPO / "unionml_tpu_torch" / "templates" / "basic_tpu" / "app.py",
                "port_basic_jit")
    assert app.model._predict_step_options["jit"] is True
    jstate = japp.init({"hidden": 64, "learning_rate": 1e-3})
    params = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                                    jstate.params)
    state = TrainState.create(apply_fn=app.MLP(hidden=64), params=params, tx=adamw(1e-3))
    japp.model.artifact = JModelArtifact(jstate)
    app.model.artifact = ModelArtifact(state)
    x = np.random.default_rng(5).random((9, 64)).astype(np.float32)
    preds = app.model.predict(features=x)
    assert isinstance(preds, torch.Tensor)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(japp.model.predict(features=x)))


def test_vision_tpu_template_jit_predictor_matches_the_jax_template(monkeypatch):
    path = REPO / "unionml_tpu" / "templates" / "vision_tpu" / "app.py"
    japp = _load(path, "jax_vision_jit")
    monkeypatch.setattr(japp, "module", JViT(JViTConfig(**TINY)))
    jstate = japp.init({})
    cfg = ViTConfig(**TINY)
    model = vision_template.build_model(cfg, name="vision_jit", reader_cache=False)
    assert model._predict_step_options["jit"] is True
    params = vit_from_jax_params(_np_tree(jstate.params), cfg, device="cpu")
    model.artifact = ModelArtifact(TrainState.create(apply_fn=ViT(cfg), params=params,
                                                     tx=adamw(1e-3)))
    japp.model.artifact = JModelArtifact(jstate)
    x = np.random.default_rng(5).normal(size=(6, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(model.predict(features=x).numpy(),
                                  np.asarray(japp.model.predict(features=x)))


class _Mlp(torch.nn.Module):
    def init(self, generator, example):
        return {"w": torch.randn(example.shape[-1], 3, generator=generator) * 0.1,
                "b": torch.zeros(3)}

    def forward(self, params, x):
        return x @ params["w"] + params["b"]


def _app():
    # the twin of tests/unit/test_train_step.py:76-95 (make_app)
    dataset = Dataset(name="jit_ds", test_size=0.2, shuffle=True, random_state=0)
    model = Model(name="jit_model", dataset=dataset)

    @dataset.reader
    def reader(n: int = 256, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, 8)).astype(np.float32)
        return {"features": x, "targets": (x[:, 0] > 0).astype(np.int32)}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        k = int(len(data["features"]) * (1 - test_size))
        return ({key: v[:k] for key, v in data.items()}, {key: v[k:] for key, v in data.items()})

    @dataset.parser
    def parser(data: dict, features, targets):
        return data["features"], data["targets"]

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        return create_train_state(_Mlp(), torch.zeros(1, 8),
                                  optimizer=adamw(hyperparameters.get("learning_rate", 0.05)))

    @model.train_step
    def train_step(state, batch):
        x, y = batch

        def loss_fn(params, batch):
            return F.cross_entropy(state.apply_fn(params, x), y.long()), {}

        (loss, _), grads = value_and_grad(loss_fn, state.params, batch)
        return state.apply_gradients(grads=grads), {"loss": loss}

    @model.predictor(jit=True)
    def predictor(state: TrainState, features: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return state.apply_fn(state.params, torch.as_tensor(features)).argmax(dim=-1)

    @model.evaluator
    def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
        return float((predictor(state, features).numpy() == np.asarray(targets)).mean())

    return model, predictor


def test_train_step_single_device_with_a_jit_predictor():
    model, predictor = _app()
    state, metrics = model.train(hyperparameters={"learning_rate": 0.05},
                                 trainer_kwargs={"num_epochs": 3, "batch_size": 32})
    assert metrics["test"] > 0.8
    x = np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32)
    preds = model.predict(features=x)
    assert preds.shape == (5,)
    np.testing.assert_array_equal(preds.numpy(), predictor(state, x).numpy())


def test_clear_jit_cache_empties_the_cache():
    def body(state: dict, features: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(features) * state["w"]

    execution.clear_jit_cache()
    graphed = execution.jit_predictor(body)
    assert execution.jit_predictor(body) is graphed
    assert execution._graphed.cache_info().currsize == 1
    assert len(graphed) == 0   # a CPU model object captures nothing
    state = {"w": torch.full((3,), 2.0)}
    np.testing.assert_array_equal(graphed(state, np.ones(3, np.float32)).numpy(), [2, 2, 2])
    execution.clear_jit_cache()
    assert execution._graphed.cache_info().currsize == 0
    assert execution.jit_predictor(body) is not graphed


def test_the_signature_follows_shapes_dtypes_structure_and_model_tensors():
    graphed = execution.jit_predictor(lambda state, features: features)
    state = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
    x = np.zeros((2, 4), np.float32)
    key = graphed.signature(state, x)
    assert graphed.signature(state, np.ones((2, 4), np.float32)) == key   # values are inputs
    assert graphed.signature(state, np.zeros((3, 4), np.float32)) != key  # shape
    assert graphed.signature(state, np.zeros((2, 4), np.float64)) != key  # dtype
    assert graphed.signature(state, [x]) != key                          # tree structure
    assert graphed.signature(state, {"x": x}) != graphed.signature(state, {"y": x})
    assert graphed.signature(state, torch.zeros(2, 4)) != key            # tensor vs array
    other = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
    assert graphed.signature(other, x) != key                           # other tensors
    with torch.no_grad():
        state["w"].add_(1.0)                                             # in place
    assert graphed.signature(state, x) == key
    module = _Mlp()
    module.register_buffer("scale", torch.ones(2))
    assert graphed.signature(module, x) != graphed.signature(_Mlp(), x)


@pytest.mark.parametrize("jit", [False, True])
def test_jit_predictor_on_cpu_runs_the_body_as_called(jit):
    calls = []

    def body(state: dict, features: np.ndarray) -> torch.Tensor:
        calls.append(1)
        return torch.as_tensor(features).sum(-1) + state["b"]

    dataset = Dataset(name=f"jit_cpu_ds_{jit}")

    @dataset.reader
    def reader() -> np.ndarray:
        return np.ones((2, 3), np.float32)

    model = Model(name=f"jit_cpu_{jit}", dataset=dataset)
    model.predictor(body, jit=jit)
    state = {"b": torch.tensor(1.0)}
    out = [model._call_predictor(state, np.ones((2, 3), np.float32)) for _ in range(2)]
    assert len(calls) == 2
    for o in out:
        np.testing.assert_array_equal(o.numpy(), [4.0, 4.0])


def _chip_smoke():
    import sys

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_jit_phase_rehearsal_on_cpu():
    """chip_smoke.py's phase 10a at ViT-tiny on the CPU (the body runs as
    called there: the replay and swap checks hold trivially, the launch
    gate is the card's)."""
    smoke = _chip_smoke()
    cfg = ViTConfig(**dict(TINY, dtype="bfloat16"), norm_impl="fused", attn_impl="fused")
    out = smoke.jit_predictor_phase(cfg, device="cpu", batches=(4, 2), calls=1)
    assert sorted(out["batches"]) == [2, 4]
    for row in out["batches"].values():
        assert row["replay_bits_equal"] and row["swap_bits_equal"] and row["swap_differs"]
        assert row["graphs"] == 0
