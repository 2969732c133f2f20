"""The port's templates on the CPU: their own scaffolded tests, and the
``basic`` and ``basic_tpu`` templates against the JAX package's.

Tier-1 collects ``tests/`` only, so the scaffolded
``unionml_tpu_torch/templates/*/tests/test_app.py`` files run here, each
loaded by path. ``basic`` (scikit-learn on the host) must give the JAX
template's metrics and predictions exactly, and survive a joblib round
trip; ``basic_tpu`` (an MLP through ``@model.train_step``) starts from the
JAX template's initial weights and must end at its params, metrics and
predictions, as the ported ``vision_tpu`` template does in
``tests/test_torch_train.py``.
"""

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from unionml_tpu_torch.models import TrainState, adamw

REPO = Path(__file__).resolve().parents[1]
TEMPLATES = ("basic", "basic_tpu", "llm_serving", "serverless", "vision_tpu")
# after Adam steps of lr 1e-3 (each moves a param by up to ~1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_app(template: str):
    return _load(REPO / "unionml_tpu_torch" / "templates" / template / "app.py",
                 f"port_{template}_app")


def _jax_app(template: str):
    return _load(REPO / "unionml_tpu" / "templates" / template / "app.py",
                 f"jax_{template}_app")


@pytest.mark.parametrize("template", TEMPLATES)
def test_scaffolded_template_tests_pass(template, tmp_path):
    """Every ``test_*`` of the template's own ``tests/test_app.py``."""
    tests = _load(REPO / "unionml_tpu_torch" / "templates" / template / "tests" / "test_app.py",
                  f"port_{template}_test_app")
    names = [n for n in dir(tests) if n.startswith("test_") and callable(getattr(tests, n))]
    assert names
    for name in names:
        fn = getattr(tests, name)
        kwargs = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}
        fn(**kwargs)


def test_basic_template_equals_the_jax_template(tmp_path):
    """The same digits split and the same ``LogisticRegression``: equal
    metrics and predictions; then a joblib save and load."""
    japp, app = _jax_app("basic"), _port_app("basic")
    hp = {"max_iter": 300}
    _, jmetrics = japp.model.train(hyperparameters=hp)
    estimator, metrics = app.model.train(hyperparameters=hp)
    assert metrics == jmetrics and metrics["test"] > 0.9
    kwargs = dict(sample_frac=0.05, random_state=1)
    preds = app.model.predict(**kwargs)
    assert preds == japp.model.predict(**kwargs)
    path = tmp_path / "model.joblib"
    app.model.save(str(path))
    loaded = app.model.load(str(path))
    assert type(loaded) is type(estimator)
    np.testing.assert_array_equal(loaded.coef_, estimator.coef_)
    assert app.model.predict(**kwargs) == preds


def test_basic_tpu_template_trains_to_the_jax_templates_params(tmp_path):
    """The JAX template's initial weights bridged into the port's: the
    same split, batch order and Adam updates end at the same params; the
    metrics agree, the predictions are equal; then save and load."""
    japp, app = _jax_app("basic_tpu"), _port_app("basic_tpu")
    hp = {"hidden": 64, "learning_rate": 1e-3}
    jstate0 = japp.init(hp)

    @app.model.init
    def init(hyperparameters: dict) -> TrainState:
        params = jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x, np.float32)), jstate0.params)
        return TrainState.create(apply_fn=app.MLP(hidden=hyperparameters["hidden"]),
                                 params=params, tx=adamw(hyperparameters["learning_rate"]))

    kwargs = dict(hyperparameters=hp, trainer_kwargs={"num_epochs": 2, "batch_size": 64})
    jstate, jmetrics = japp.model.train(**kwargs)
    state, metrics = app.model.train(**kwargs)
    assert state.step == int(jstate.step) == 2 * (1437 // 64)
    want = jax.tree_util.tree_leaves_with_path(jstate.params)
    got = dict((jax.tree_util.keystr(p), x)
               for p, x in jax.tree_util.tree_leaves_with_path(state.params))
    assert len(got) == len(want) == 4
    for path, leaf in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)].numpy(),
                                   np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **PARAM_TOL)
    assert metrics == pytest.approx(jmetrics)
    x = np.random.default_rng(5).random((9, 64)).astype(np.float32)
    preds = app.model.predict(features=x)
    np.testing.assert_array_equal(preds, np.asarray(japp.model.predict(features=x)))
    path = tmp_path / "mlp.pt"
    app.model.save(str(path))
    loaded = app.model.load(str(path))
    assert isinstance(loaded, TrainState) and loaded.step == state.step
    np.testing.assert_array_equal(app.model.predict(features=x), preds)


def test_basic_tpu_template_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = _port_app("basic_tpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.model.train(trainer_kwargs={"num_epochs": 1, "batch_size": 64})
