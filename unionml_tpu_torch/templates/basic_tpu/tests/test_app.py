"""Scaffolded smoke test: the train_step trains and predicts (on the CPU
here; drop ``device`` to train on the card)."""

import importlib.util
from pathlib import Path

import numpy as np


def _load_app():
    # by path, under a name of its own: every template has an ``app``
    path = Path(__file__).resolve().parent.parent / "app.py"
    spec = importlib.util.spec_from_file_location("basic_tpu_template_app", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


app = _load_app()


def test_train_step_and_predictor():
    state, metrics = app.model.train(
        hyperparameters={"hidden": 128, "learning_rate": 1e-3, "device": "cpu"},
        trainer_kwargs={"num_epochs": 5, "batch_size": 64},
    )
    assert metrics["test"] > 0.7
    preds = app.model.predict(features=np.zeros((2, 64), np.float32))
    assert np.asarray(preds).shape == (2,)
