"""{{app_name}}: LLM generation served as a unionml_tpu_torch microservice.

The PyTorch port of the ``llm_serving`` template: a Llama-family causal
LM behind the standard Dataset/Model spec — prompts come in as token-id
lists over HTTP, the predictor buckets and left-pads them and runs one
prefill plus a decode loop on the card. Serving runs int8 weight-only
matmuls, the padded flash prefill kernel (``prefill_impl="flash"``) and
the fused RMSNorm kernel (``norm_impl="fused"``).

Run:
    python app.py                       # init (random weights) + save model.pt
    UNIONML_MODEL_PATH=model.pt python -c \\
        "import app; app.model.serve(batch=True, row_lists=True).serve()"
    curl -X POST localhost:8000/predict \\
         -d '{"features": [[1, 5, 9], [2, 4, 6, 8]]}'

``build_model(LlamaConfig.llama3_8b() ...)`` builds the same app at
Llama-3-8B width. Weights live on the device named by the ``device``
hyperparameter (``None`` = CUDA; pass ``"cpu"`` explicitly to run on the
CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch._device import torch_dtype
from unionml_tpu_torch.models import (
    LLAMA_QUANT_PATTERNS,
    Llama,
    LlamaConfig,
    init_params,
    make_lm_predictor,
    quantize_params,
    serving_params,
)

MAX_NEW_TOKENS = 32
BUCKET_LENS = (16, 32, 64, 128)
CONFIG = LlamaConfig.tiny(
    vocab_size=512, quantized=True, prefill_impl="flash", norm_impl="fused"
)


def build_model(
    config: LlamaConfig = CONFIG,
    *,
    name: str = "{{app_name}}",
    max_new_tokens: int = MAX_NEW_TOKENS,
    bucket_lens: tuple = BUCKET_LENS,
) -> Model:
    """The template's Dataset/Model spec for ``config`` (``quantized``
    selects int8 serving weights)."""
    serving_module = Llama(config)
    dataset = Dataset(name=f"{name}_dataset")

    @dataset.reader
    def reader() -> list:
        # LMs have no training dataset here; the reader exists so the
        # spec compiles
        return [[1, 2, 3]]

    @dataset.feature_loader
    def feature_loader(raw: list) -> list:
        # ragged token-id prompts stay lists; the predictor buckets/pads them
        return raw

    model = Model(name=name, dataset=dataset)

    @model.init
    def init(hyperparameters: dict) -> dict:
        fp_config = dataclasses.replace(config, quantized=False)
        params = init_params(
            fp_config, seed=hyperparameters.get("seed", 0),
            device=hyperparameters.get("device"),
        )
        if config.quantized:
            params = quantize_params(params, LLAMA_QUANT_PATTERNS)
        # one-time cast to the serving dtype: decode re-reads the whole
        # weight tree per token (quant scales stay fp32)
        return serving_params(params, torch_dtype(config.dtype))

    @model.trainer
    def trainer(params: dict, features: list, targets: list) -> dict:
        # serving-only app: "training" materializes the (quantized) weights
        return params

    generate = make_lm_predictor(
        serving_module, max_new_tokens=max_new_tokens, bucket_lens=bucket_lens
    )

    @model.predictor
    def predictor(params: dict, prompts: list) -> list:
        return generate(params, prompts)

    return model


model = build_model()


if __name__ == "__main__":
    params, _ = model.train()
    out = model.predict(features=[[1, 5, 9], [2, 4, 6, 8]])
    print(f"generated: {np.asarray(out).shape}")
    model.save("model.pt")
