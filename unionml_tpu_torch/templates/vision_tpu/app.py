"""{{app_name}}: a computer-vision app (ViT on image batches) on the card.

The PyTorch port of the ``vision_tpu`` template: the framework's ViT
behind the standard Dataset/Model spec, trained through
``@model.train_step`` (the synthesized trainer feeds shuffled batches to
``classification_step``), with a cached reader, a custom splitter and a
``feature_loader`` that accepts image files. ``build_model(config, ...)``
builds the same app for another :class:`ViTConfig` (``ViTConfig.base16()``
for ViT-B/16 at 224x224). Tensors live on the device named by the
``device`` hyperparameter (``None`` = CUDA; pass ``"cpu"`` to train on the
CPU explicitly). Without a mesh the step takes no sharding config.

Run: ``python app.py`` (train + save model.pt).
"""

from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models import (
    TrainState,
    ViT,
    ViTConfig,
    classification_step,
    create_train_state,
)

IMAGE_SIZE = 32
NUM_CLASSES = 10
CONFIG = ViTConfig.tiny(image_size=IMAGE_SIZE, num_classes=NUM_CLASSES)


def build_model(
    config: ViTConfig = CONFIG,
    *,
    name: str = "{{app_name}}",
    reader_cache: bool = True,
    on_step: Optional[Callable] = None,
) -> Model:
    """The template's Dataset/Model spec for ``config``. ``reader_cache``
    caches the reader's output on disk (the stage cache);
    ``on_step(state, metrics)``, when given, is called after
    every step with the new state and the step's metrics (still on the
    device), e.g. to log losses."""
    module = ViT(config)
    size = config.image_size
    dataset = Dataset(name=f"{name}_dataset", test_size=0.2)
    model = Model(name=name, dataset=dataset)

    # the reader is the expensive stage (decode/resize a whole corpus), so
    # it is cached on disk: re-runs with the same kwargs hit the cache
    @dataset.reader(cache=reader_cache, cache_version="1")
    def reader(n: int = 512, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        images = rng.normal(size=(n, size, size, 3)).astype(np.float32)
        # synthetic labels with learnable signal (channel-mean threshold)
        targets = (images.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
        return {"features": images, "targets": targets}

    # custom splitter: a seeded shuffle, then a contiguous cut
    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        n = len(data["features"])
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(random_state).shuffle(idx)
        k = int(n * (1 - test_size))
        tr, te = idx[:k], idx[k:]
        return (
            {"features": data["features"][tr], "targets": data["targets"][tr]},
            {"features": data["features"][te], "targets": data["targets"][te]},
        )

    @dataset.parser
    def parser(data: dict, features, targets):
        return (data["features"], data["targets"])

    # custom feature loader: a path to an .npy image file, nested lists, or
    # a ready array
    @dataset.feature_loader
    def feature_loader(raw: Union[str, Path, list, np.ndarray]) -> np.ndarray:
        if isinstance(raw, (str, Path)):
            arr = np.load(raw)
        else:
            arr = np.asarray(raw, dtype=np.float32)
        if arr.ndim == 3:  # single image -> batch of one
            arr = arr[None]
        return arr.astype(np.float32)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        device = resolve_device(hyperparameters.get("device"))
        return create_train_state(
            module,
            torch.zeros(1, size, size, 3, device=device),
            learning_rate=hyperparameters.get("learning_rate", 1e-3),
            weight_decay=hyperparameters.get("weight_decay", 1e-4),
        )

    step = classification_step(module)

    @model.train_step
    def train_step(state, batch) -> tuple:
        state, metrics = step(state, batch)
        if on_step is not None:
            on_step(state, metrics)
        return state, metrics

    @model.predictor
    def predictor(state: TrainState, features: np.ndarray) -> np.ndarray:
        device = state.params["cls"].device
        with torch.no_grad():
            logits = state.apply_fn(state.params, torch.as_tensor(features, device=device))
        return logits.argmax(dim=-1).cpu().numpy()

    @model.evaluator
    def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
        preds = predictor(state, features)
        return float((np.asarray(preds) == np.asarray(targets)).mean())

    return model


model = build_model()


if __name__ == "__main__":
    state, metrics = model.train(
        hyperparameters={"learning_rate": 1e-3},
        trainer_kwargs={"num_epochs": 5, "batch_size": 64},
    )
    print(f"metrics: {metrics}")
    model.save("model.pt")
