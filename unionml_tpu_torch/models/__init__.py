"""The Llama serving model of the port (the reference's model zoo is
ported one model at a time; ROADMAP.md)."""

from unionml_tpu_torch.models.convert import from_jax_params
from unionml_tpu_torch.models.generate import (
    make_generator,
    make_lm_predictor,
    make_sampler,
    serving_params,
)
from unionml_tpu_torch.models.llama import Llama, LlamaConfig, init_cache, init_params
from unionml_tpu_torch.models.quantization import (
    LLAMA_QUANT_PATTERNS,
    QuantizedDenseGeneral,
    quantize_params,
)
from unionml_tpu_torch.models.train import resolve_params

__all__ = [
    "Llama",
    "LlamaConfig",
    "init_cache",
    "init_params",
    "from_jax_params",
    "make_generator",
    "make_lm_predictor",
    "make_sampler",
    "serving_params",
    "LLAMA_QUANT_PATTERNS",
    "QuantizedDenseGeneral",
    "quantize_params",
    "resolve_params",
]
