"""The port's model zoo: the Llama model (serving, LM training and LoRA /
QLoRA fine-tuning) and the ViT training model with their train-state and
step factories (the reference's zoo is ported one model at a time;
ROADMAP.md)."""

from unionml_tpu_torch.models.convert import (
    from_jax_params,
    lora_from_jax_state,
    vit_from_jax_params,
)
from unionml_tpu_torch.models.generate import (
    make_generator,
    make_lm_predictor,
    make_sampler,
    serving_params,
)
from unionml_tpu_torch.models.llama import Llama, LlamaConfig, init_cache, init_params
from unionml_tpu_torch.models.lora import (
    LoRADenseGeneral,
    LoRATrainState,
    create_lora_train_state,
    merge_lora,
    merge_param_trees,
    split_lora_params,
)
from unionml_tpu_torch.models.quantization import (
    LLAMA_QUANT_PATTERNS,
    Int4DenseGeneral,
    QuantizedDenseGeneral,
    quantize_params,
)
from unionml_tpu_torch.models.speculative import (
    make_speculative_generator,
    make_speculative_predictor,
)
from unionml_tpu_torch.models.train import (
    TrainState,
    accumulated_value_and_grad,
    adamw,
    classification_step,
    create_train_state,
    lm_step,
    make_evaluator,
    make_predictor,
    masked_cross_entropy,
    resolve_params,
)
from unionml_tpu_torch.models.vit import ViT, ViTConfig
from unionml_tpu_torch.models.vit import init_params as init_vit_params

__all__ = [
    "Llama",
    "LlamaConfig",
    "init_cache",
    "init_params",
    "from_jax_params",
    "lora_from_jax_state",
    "LoRADenseGeneral",
    "LoRATrainState",
    "create_lora_train_state",
    "merge_lora",
    "merge_param_trees",
    "split_lora_params",
    "make_generator",
    "make_lm_predictor",
    "make_sampler",
    "make_speculative_generator",
    "make_speculative_predictor",
    "serving_params",
    "LLAMA_QUANT_PATTERNS",
    "Int4DenseGeneral",
    "QuantizedDenseGeneral",
    "quantize_params",
    "resolve_params",
    "TrainState",
    "ViT",
    "ViTConfig",
    "accumulated_value_and_grad",
    "adamw",
    "classification_step",
    "create_train_state",
    "init_vit_params",
    "lm_step",
    "make_evaluator",
    "make_predictor",
    "masked_cross_entropy",
    "vit_from_jax_params",
]
