"""BERT-style encoder, the fine-tune and masked-LM config, in PyTorch.

The port of :mod:`unionml_tpu.models.bert`: learned token / position /
token-type embeddings (each table cast to ``config.dtype`` before the
gather, as flax's ``nn.Embed(dtype=...)`` does, and summed in that dtype
in the reference's order), post-LN blocks with q/k/v/o biases, a GELU
MLP and flax's LayerNorm (fp32 statistics, eps 1e-6), then fp32 heads:
:class:`BertClassifier` (``[CLS]`` pooled, tanh) and :class:`BertMlm`
(dense, tanh-GELU, LayerNorm, vocabulary projection).

Attention follows the reference's routing. A batch with an
``attention_mask`` always takes the full-score reference with the
additive fp32 bias ``where(mask, 0, -1e30)`` ``[B, 1, 1, S]`` (a fully
masked row softmaxes uniformly, as in the reference); without a mask
``config.attn_impl`` picks ``xla``, ``fused`` (kernel rows 12-13),
``flash`` (rows 9-11) or ``auto``. ``blockwise`` waits for sequence
parallelism (ROADMAP.md, A6b) and raises ``NotImplementedError``; the
sequence-parallel impls raise ``ValueError`` as in the reference.

A sequence longer than ``max_len`` raises ``ValueError`` from its shape
(the reference's gather fills the missing positions with NaN rows;
ROADMAP.md C5). :func:`mlm_step` and :func:`make_mlm_batch` are the
reference's MLM step over padded corpora and its host-side masking rule.
:data:`BERT_PARTITION_RULES` are the reference's tensor-parallel layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from unionml_tpu_torch.models.layers import (
    ATTN_IMPLS,
    LayerNorm,
    MlpBlock,
    _run_attention,
    gather_rows,
)
from unionml_tpu_torch.models.quantization import DenseGeneral
from unionml_tpu_torch.ops.attention import NEG_INF, mha_reference
from unionml_tpu_torch.parallel.sharding import PartitionRule

# the reference's impls without a sequence mesh axis, "blockwise" included
SUPPORTED_ATTN_IMPLS = ("auto", "xla", "blockwise", "flash", "fused")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_len: int = 512
    num_types: int = 2
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 2  # classification head width
    attn_impl: str = "xla"  # used only when attention_mask is None
    # HF BERT checkpoints use erf GELU; the default is the tanh form
    gelu_exact: bool = False
    dtype: str = "bfloat16"

    @staticmethod
    def base(num_classes: int = 2) -> "BertConfig":
        return BertConfig(num_classes=num_classes)

    @staticmethod
    def tiny(vocab_size: int = 1024, num_classes: int = 2) -> "BertConfig":
        return BertConfig(
            vocab_size=vocab_size, max_len=128, hidden_dim=64,
            num_layers=2, num_heads=4, mlp_dim=128, num_classes=num_classes,
        )


def _check_attn_impl(impl: str) -> None:
    if impl == "blockwise":
        raise NotImplementedError(
            "attn_impl 'blockwise' is not ported yet (sequence parallelism, A6b); the port's BERT "
            f"takes {tuple(i for i in SUPPORTED_ATTN_IMPLS if i in ATTN_IMPLS)}"
        )
    if impl not in SUPPORTED_ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; use one of {SUPPORTED_ATTN_IMPLS}")


class BertBlock(nn.Module):
    """``forward(params, x, bias)``: post-LN attention and MLP sublayers;
    ``bias`` (fp32 ``[B, 1, 1, S]`` or ``None``) selects the masked
    reference path."""

    def __init__(self, config: BertConfig):
        super().__init__()
        cfg = config
        _check_attn_impl(cfg.attn_impl)
        self.attn_impl = cfg.attn_impl
        dtype = torch_dtype(cfg.dtype)
        head_dim = cfg.hidden_dim // cfg.num_heads
        self.attn_q = DenseGeneral((cfg.num_heads, head_dim), dtype=dtype, use_bias=True)
        self.attn_k = DenseGeneral((cfg.num_heads, head_dim), dtype=dtype, use_bias=True)
        self.attn_v = DenseGeneral((cfg.num_heads, head_dim), dtype=dtype, use_bias=True)
        self.attn_o = DenseGeneral(cfg.hidden_dim, axis=(-2, -1), dtype=dtype, use_bias=True)
        self.ln1 = LayerNorm(dtype=dtype)
        # the port's MlpBlock defaults to the gated form; BERT's is GELU
        self.mlp = MlpBlock(cfg.mlp_dim, cfg.hidden_dim, gated=False,
                            gelu_approximate=not cfg.gelu_exact, dtype=dtype)
        self.ln2 = LayerNorm(dtype=dtype)

    def forward(self, params, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        q = self.attn_q(params["attn_q"], x)
        k = self.attn_k(params["attn_k"], x)
        v = self.attn_v(params["attn_v"], x)
        if bias is not None:
            # only the full-score reference takes the padding bias
            attn = mha_reference(q, k, v, bias=bias)
        else:
            attn = _run_attention(q, k, v, impl=self.attn_impl, causal=False)
        x = self.ln1(params["ln1"], x + self.attn_o(params["attn_o"], attn))
        return self.ln2(params["ln2"], x + self.mlp(params["mlp"], x))


def _embed(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # flax's Embed(dtype=...) casts the table, then gathers
    return gather_rows(table.to(dtype), ids)


class BertEncoder(nn.Module):
    """``forward(params, input_ids, *, attention_mask=None,
    token_type_ids=None)`` over ``[B, S]`` ids returns ``[B, S, D]`` in
    ``config.dtype``."""

    def __init__(self, config: Optional[BertConfig] = None):
        super().__init__()
        self.config = config or BertConfig()
        self.dtype = torch_dtype(self.config.dtype)
        self.ln_embed = LayerNorm(dtype=self.dtype)
        self.blocks = nn.ModuleList(BertBlock(self.config) for _ in range(self.config.num_layers))

    def init(self, generator: torch.Generator, example_input: torch.Tensor, *,
             token_type_ids: Optional[torch.Tensor] = None, **_) -> dict:
        return init_params(self.config, head=None, token_types=token_type_ids is not None,
                           generator=generator, device=example_input.device)

    def forward(
        self,
        params,
        input_ids: torch.Tensor,
        *,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        seq = input_ids.shape[1]
        if seq > cfg.max_len:
            raise ValueError(
                f"sequence of {seq} tokens is longer than max_len {cfg.max_len} "
                "(the position table's rows)"
            )
        x = _embed(params["tok_embed"]["embedding"], input_ids.long(), self.dtype)
        x = x + params["pos_embed"]["embedding"][:seq].to(self.dtype)[None]
        if token_type_ids is not None:
            x = x + _embed(params["type_embed"]["embedding"], token_type_ids.long(), self.dtype)
        x = self.ln_embed(params["ln_embed"], x)
        bias = None
        if attention_mask is not None:
            keep = attention_mask[:, None, None, :].bool()
            bias = torch.where(keep, torch.zeros((), device=x.device),
                               torch.full((), NEG_INF, device=x.device))
        for i, block in enumerate(self.blocks):
            x = block(params[f"block_{i}"], x, bias)
        return x


class BertClassifier(nn.Module):
    """``[CLS]``-pooled sequence classification (the fine-tune config):
    ``forward(params, input_ids, *, attention_mask=None,
    token_type_ids=None)`` returns fp32 logits ``[B, num_classes]``."""

    def __init__(self, config: Optional[BertConfig] = None):
        super().__init__()
        self.config = config or BertConfig()
        self.encoder = BertEncoder(self.config)
        self.pooler = DenseGeneral(self.config.hidden_dim, dtype=torch.float32, use_bias=True)
        self.head = DenseGeneral(self.config.num_classes, dtype=torch.float32, use_bias=True)

    def init(self, generator: torch.Generator, example_input: torch.Tensor, *,
             token_type_ids: Optional[torch.Tensor] = None, **_) -> dict:
        return init_params(self.config, head="classifier",
                           token_types=token_type_ids is not None, generator=generator,
                           device=example_input.device)

    def forward(self, params, input_ids, *, attention_mask=None, token_type_ids=None):
        x = self.encoder(params["encoder"], input_ids, attention_mask=attention_mask,
                         token_type_ids=token_type_ids)
        pooled = torch.tanh(self.pooler(params["pooler"], x[:, 0].float()))
        return self.head(params["head"], pooled)


class BertMlm(nn.Module):
    """Masked-LM head over the encoder: ``forward(params, input_ids, *,
    attention_mask=None)`` returns fp32 logits ``[B, S, vocab_size]``."""

    def __init__(self, config: Optional[BertConfig] = None):
        super().__init__()
        cfg = self.config = config or BertConfig()
        self.encoder = BertEncoder(cfg)
        self.mlm_dense = DenseGeneral(cfg.hidden_dim, dtype=torch.float32, use_bias=True)
        self.mlm_ln = LayerNorm(dtype=torch.float32)
        self.mlm_head = DenseGeneral(cfg.vocab_size, dtype=torch.float32, use_bias=True)

    def init(self, generator: torch.Generator, example_input: torch.Tensor, **_) -> dict:
        return init_params(self.config, head="mlm", generator=generator,
                           device=example_input.device)

    def forward(self, params, input_ids, *, attention_mask=None):
        x = self.encoder(params["encoder"], input_ids, attention_mask=attention_mask)
        x = torch.nn.functional.gelu(self.mlm_dense(params["mlm_dense"], x.float()),
                                     approximate="tanh")
        x = self.mlm_ln(params["mlm_ln"], x)
        return self.mlm_head(params["mlm_head"], x)


def init_params(
    config: BertConfig,
    *,
    head: Optional[str] = "classifier",
    token_types: bool = False,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> dict:
    """A random fp32 param tree in the reference's layout on ``device``
    (``None`` = CUDA, raising without one), drawn from ``generator`` (seed
    0 when omitted): ``head`` ``"classifier"`` (``encoder``, ``pooler``,
    ``head``), ``"mlm"`` (``encoder``, ``mlm_dense``, ``mlm_ln``,
    ``mlm_head``) or ``None`` (the bare encoder's tree); ``token_types``
    adds ``type_embed`` (flax creates it only when the model is first
    called with token types). Embedding tables normal with std 0.02,
    kernels normal with std 1/sqrt(fan_in), biases zero, norm scales one."""
    if head not in ("classifier", "mlm", None):
        raise ValueError(f"unknown head {head!r}; use 'classifier', 'mlm' or None")
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    cfg = config
    d, h, m = cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim
    hd = d // h

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    def norm(width=d):
        return {"scale": torch.ones(width, device=dev, dtype=torch.float32), "bias": zeros(width)}

    def dense(shape, fan_in, bias_shape):
        return {"kernel": normal(shape, fan_in**-0.5), "bias": zeros(*bias_shape)}

    encoder = {
        "tok_embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "pos_embed": {"embedding": normal((cfg.max_len, d), 0.02)},
    }
    if token_types:
        encoder["type_embed"] = {"embedding": normal((cfg.num_types, d), 0.02)}
    encoder["ln_embed"] = norm()
    for i in range(cfg.num_layers):
        encoder[f"block_{i}"] = {
            "attn_q": dense((d, h, hd), d, (h, hd)),
            "attn_k": dense((d, h, hd), d, (h, hd)),
            "attn_v": dense((d, h, hd), d, (h, hd)),
            "attn_o": dense((h, hd, d), d, (d,)),
            "ln1": norm(),
            "mlp": {"up": dense((d, m), d, (m,)), "down": dense((m, d), m, (d,))},
            "ln2": norm(),
        }
    if head is None:
        return encoder
    if head == "classifier":
        return {"encoder": encoder, "pooler": dense((d, d), d, (d,)),
                "head": dense((d, cfg.num_classes), d, (cfg.num_classes,))}
    return {"encoder": encoder, "mlm_dense": dense((d, d), d, (d,)), "mlm_ln": norm(),
            "mlm_head": dense((d, cfg.vocab_size), d, (cfg.vocab_size,))}


def mlm_step(module: nn.Module, *, ignore_id: int = -100, accumulate_steps: int = 1) -> Callable:
    """Masked-LM training step over padded corpora: ``batch = (inputs,
    labels, attention_mask)``; the mask reaches the encoder so real tokens
    never attend pad positions, and the loss is the masked cross entropy
    over labels other than ``ignore_id``. ``accumulate_steps > 1``: the
    batch leaves carry a leading microbatch axis and one optimizer update
    follows the fp32 grad mean over it. Metrics ``loss`` and
    ``perplexity`` stay on the device."""
    from unionml_tpu_torch.models.train import (
        _bind_frozen,
        accumulated_value_and_grad,
        masked_cross_entropy,
        value_and_grad,
    )

    def loss_fn(params, microbatch):
        inputs, labels, attention_mask = microbatch
        logits = module(params, inputs, attention_mask=attention_mask)
        return masked_cross_entropy(logits, labels, ignore_id=ignore_id), {}

    def step(state, batch):
        bound = _bind_frozen(loss_fn, state)
        if accumulate_steps > 1:
            (loss, _), grads = accumulated_value_and_grad(bound, state.params, batch)
        else:
            (loss, _), grads = value_and_grad(bound, state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, {"loss": loss, "perplexity": torch.exp(loss)}

    return step


def make_mlm_batch(
    tokens,
    *,
    mask_id: int,
    vocab_size: int,
    rng,
    mask_prob: float = 0.15,
    special_ids: tuple = (0,),
    ignore_id: int = -100,
):
    """BERT masking rule over a token batch: returns ``(inputs, labels)``
    numpy arrays.

    15% of non-special positions are selected; of those 80% become
    ``mask_id``, 10% a random token, 10% stay unchanged. ``labels`` carry
    the original ids at selected positions and ``ignore_id`` elsewhere
    (the ``(inputs, labels)`` contract of ``lm_step``). Host-side numpy,
    the reference's code draw for draw: the same ``numpy.random.Generator``
    state gives the same arrays."""
    import numpy as np

    # signed: with uint token arrays, ignore_id=-100 would wrap to an
    # in-range positive and every position would be supervised
    tokens = np.asarray(tokens).astype(np.int64)
    maskable = ~np.isin(tokens, np.asarray(special_ids))
    selected = (rng.random(tokens.shape) < mask_prob) & maskable
    labels = np.where(selected, tokens, ignore_id)
    roll = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[selected & (roll < 0.8)] = mask_id
    random_slots = selected & (roll >= 0.8) & (roll < 0.9)
    inputs[random_slots] = rng.integers(0, vocab_size, size=int(random_slots.sum()))
    return inputs, labels


BERT_PARTITION_RULES = (
    PartitionRule(r"attn_(q|k|v)/kernel$", (None, "tensor", None)),
    PartitionRule(r"attn_o/kernel$", ("tensor", None, None)),
    PartitionRule(r"mlp/up/kernel$", (None, "tensor")),
    PartitionRule(r"mlp/down/kernel$", ("tensor", None)),
    PartitionRule(r"tok_embed/embedding$", (None, "tensor")),
    PartitionRule(r"mlm_head/kernel$", (None, "tensor")),
)
