"""Scaffolded smoke test: the spec trains and predicts end to end."""

import importlib.util
from pathlib import Path


def _load_app():
    # by path, under a name of its own: every template has an ``app``
    path = Path(__file__).resolve().parent.parent / "app.py"
    spec = importlib.util.spec_from_file_location("basic_template_app", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


app = _load_app()


def test_train_and_predict():
    estimator, metrics = app.model.train(hyperparameters={"max_iter": 200})
    assert metrics["test"] > 0.8
    preds = app.model.predict(sample_frac=0.05, random_state=1)
    assert isinstance(preds, list) and preds
