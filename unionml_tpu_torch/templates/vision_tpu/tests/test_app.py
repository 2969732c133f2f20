"""Scaffolded smoke test: cached reader + ViT train_step + file-loader
prediction path (on the CPU here; drop ``device`` to train on the card)."""

import importlib.util
from pathlib import Path

import numpy as np


def _load_app():
    # by path, under a name of its own: every template has an ``app``
    path = Path(__file__).resolve().parent.parent / "app.py"
    spec = importlib.util.spec_from_file_location("vision_tpu_template_app", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


app = _load_app()


def test_train_and_predict_array_and_file(tmp_path):
    state, metrics = app.model.train(
        hyperparameters={"learning_rate": 1e-3, "device": "cpu"},
        trainer_kwargs={"num_epochs": 1, "batch_size": 64},
        n=256,
    )
    assert "test" in metrics
    image = np.zeros((app.IMAGE_SIZE, app.IMAGE_SIZE, 3), np.float32)
    preds = app.model.predict(features=image[None])
    assert np.asarray(preds).shape == (1,)
    npy = tmp_path / "img.npy"
    np.save(npy, image)
    preds2 = app.model.predict(features=str(npy))
    assert np.asarray(preds2).shape == (1,)
