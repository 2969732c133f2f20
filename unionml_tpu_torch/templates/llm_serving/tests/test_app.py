"""Scaffolded smoke test: quantized weights materialize, ragged prompts
generate the configured number of tokens (on the CPU here; drop
``device`` to serve from the card)."""

import importlib.util
from pathlib import Path

import numpy as np


def _load_app():
    # by path, under a name of its own: every template has an ``app``
    path = Path(__file__).resolve().parent.parent / "app.py"
    spec = importlib.util.spec_from_file_location("llm_serving_template_app", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


app = _load_app()


def test_generate_ragged_prompts():
    params, _ = app.model.train(hyperparameters={"device": "cpu"})
    out = app.model.predict(features=[[1, 5, 9], [2, 4, 6, 8]])
    arr = np.asarray(out)
    assert arr.shape == (2, app.MAX_NEW_TOKENS)
