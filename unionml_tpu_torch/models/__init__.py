"""The port's model zoo: the Llama model (serving, LM training, LoRA /
QLoRA fine-tuning, MoE, sequence- and pipeline-parallel training), the
ViT training model, the MLP classifier and the BERT encoder (fine-tune
and masked-LM heads) with their train-state and step factories (the
reference's zoo is ported one model at a time; ROADMAP.md)."""

from unionml_tpu_torch.models.bert import (
    BertClassifier,
    BertConfig,
    BertEncoder,
    BertMlm,
    make_mlm_batch,
    mlm_step,
)
from unionml_tpu_torch.models.bert import init_params as init_bert_params
from unionml_tpu_torch.models.convert import (
    bert_from_jax_params,
    from_jax_params,
    pipeline_from_jax_params,
    lora_from_jax_state,
    mlp_from_jax_params,
    vit_from_jax_params,
)
from unionml_tpu_torch.models.generate import (
    make_generator,
    make_lm_predictor,
    make_sampler,
    serving_params,
)
from unionml_tpu_torch.models.llama import (
    LLAMA_MOE_PARTITION_RULES,
    LLAMA_PARTITION_RULES,
    LLAMA_QUANT_PARTITION_RULES,
    Llama,
    LlamaConfig,
    init_cache,
    init_params,
)
from unionml_tpu_torch.models.mlp import Mlp, MlpConfig
from unionml_tpu_torch.models.mlp import init_params as init_mlp_params
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
from unionml_tpu_torch.models.pipeline_lm import (
    PIPELINE_PARTITION_RULES,
    create_pipelined_lm_state,
    pipelined_lm_apply,
    pipelined_lm_step,
    to_pipeline_params,
)
from unionml_tpu_torch.models.sequence_parallel import (
    sequence_parallel_config,
    sequence_parallel_lm_step,
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
    "Mlp",
    "MlpConfig",
    "init_mlp_params",
    "mlp_from_jax_params",
    "BertEncoder",
    "BertClassifier",
    "BertMlm",
    "BertConfig",
    "init_bert_params",
    "bert_from_jax_params",
    "make_mlm_batch",
    "mlm_step",
    "Llama",
    "LlamaConfig",
    "LLAMA_PARTITION_RULES",
    "LLAMA_QUANT_PARTITION_RULES",
    "LLAMA_MOE_PARTITION_RULES",
    "PIPELINE_PARTITION_RULES",
    "create_pipelined_lm_state",
    "pipelined_lm_apply",
    "pipelined_lm_step",
    "to_pipeline_params",
    "sequence_parallel_config",
    "sequence_parallel_lm_step",
    "init_cache",
    "init_params",
    "from_jax_params",
    "pipeline_from_jax_params",
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
