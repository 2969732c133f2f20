"""{{app_name}}: a unionml_tpu_torch app trained on the card (an MLP on
MNIST-style digits).

The PyTorch port's ``basic_tpu`` template: a two-layer MLP on scikit-learn's
digits, trained through ``@model.train_step`` (the synthesized trainer
feeds shuffled batches to the per-batch step) with Adam (the port's
``adamw`` without weight decay). Tensors live on the device named by the
``device`` hyperparameter (``None`` = CUDA; pass ``"cpu"`` to train on the
CPU explicitly). Without a mesh the step takes no sharding config. The
predictor is ``jit=True`` as in the reference: on the card its body runs as
a CUDA graph captured once per input shape, tensors in and tensors out;
the evaluator converts.

Run: ``python app.py`` (train + save model.pt).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models import TrainState, adamw, create_train_state
from unionml_tpu_torch.models.train import value_and_grad

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2)
model = Model(name="{{app_name}}", dataset=dataset)


@dataset.reader
def reader() -> dict:
    from sklearn.datasets import load_digits

    digits = load_digits()
    return {
        "features": digits.data.astype(np.float32) / 16.0,
        "targets": digits.target.astype(np.int32),
    }


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


class MLP(nn.Module):
    """``relu(x @ W0 + b0) @ W1 + b1`` in fp32; params ``Dense_0`` /
    ``Dense_1`` (``kernel`` ``[in, out]``, ``bias``), flax's names."""

    def __init__(self, hidden: int = 128, classes: int = 10):
        super().__init__()
        self.hidden = hidden
        self.classes = classes

    def init(self, generator: torch.Generator, example_input: torch.Tensor) -> dict:
        dev = example_input.device
        widths = (example_input.shape[-1], self.hidden, self.classes)
        return {
            f"Dense_{i}": {
                "kernel": torch.randn(widths[i:i + 2], generator=generator, device=dev)
                * widths[i] ** -0.5,
                "bias": torch.zeros(widths[i + 1], device=dev),
            }
            for i in range(2)
        }

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ params["Dense_0"]["kernel"] + params["Dense_0"]["bias"])
        return h @ params["Dense_1"]["kernel"] + params["Dense_1"]["bias"]


@model.init
def init(hyperparameters: dict) -> TrainState:
    device = resolve_device(hyperparameters.get("device"))
    return create_train_state(
        MLP(hidden=hyperparameters.get("hidden", 128)),
        torch.zeros(1, 64, device=device),
        optimizer=adamw(hyperparameters.get("learning_rate", 1e-3)),
    )


@model.train_step
def train_step(state: TrainState, batch) -> tuple:
    def loss_fn(params, batch):
        x, y = batch
        return F.cross_entropy(state.apply_fn(params, x), y.long()), {}

    (loss, _), grads = value_and_grad(loss_fn, state.params, batch)
    return state.apply_gradients(grads=grads), {"loss": loss}


@model.predictor(jit=True)
def predictor(state: TrainState, features: np.ndarray) -> torch.Tensor:
    device = state.params["Dense_0"]["kernel"].device
    with torch.no_grad():
        logits = state.apply_fn(state.params, torch.as_tensor(features, device=device))
    return logits.argmax(dim=-1)


@model.evaluator
def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
    preds = predictor(state, features).cpu().numpy()
    return float((preds == np.asarray(targets)).mean())


if __name__ == "__main__":
    state, metrics = model.train(
        hyperparameters={"hidden": 128, "learning_rate": 1e-3},
        trainer_kwargs={"num_epochs": 10, "batch_size": 128},
    )
    print(f"metrics: {metrics}")
    model.save("model.pt")
