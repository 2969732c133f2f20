"""ViT, the training flagship of the model zoo, in PyTorch.

The port of :mod:`unionml_tpu.models.vit`: patchify as one product over
``[p, p, C]`` patches with the flax Conv kernel ``[p, p, C, D]`` (HWIO;
the same sums as the reference's strided VALID conv), a ``cls`` token and
learned ``pos_embed``, pre-norm blocks, a final LayerNorm and an fp32
``head`` on the ``cls`` position. Compute runs in ``config.dtype``
(bf16 by default) with fp32 norm statistics; params are fp32.

``norm_impl="fused"`` routes ``ln1`` / ``ln_final`` through the fused
LayerNorm kernels and fuses the mid-block residual add into ``ln2``
(``h1 = ln1(x); s, h2 = ln2(x + attn(h1)); s + mlp(h2)``); ``attn_impl``
``"fused"`` (``base16``'s default) runs the fused short-sequence attention
kernels. The param tree is the reference's, so
:func:`~unionml_tpu_torch.models.convert.vit_from_jax_params` carries a JAX
tree over unchanged. The reference's ``VIT_PARTITION_RULES`` wait for
tensor parallelism (ROADMAP.md, A11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from unionml_tpu_torch._device import DeviceLike, resolve_device, torch_dtype
from unionml_tpu_torch.models.layers import Attention, LayerNorm, MlpBlock


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    attn_impl: str = "xla"
    # "fused" = the LayerNorm kernel pair incl. the residual-add fusion;
    # "xla" = flax's plain fp32-statistics LayerNorm
    norm_impl: str = "xla"
    # HF ViT checkpoints carry q/k/v/o biases and use erf GELU; the
    # trained-from-scratch defaults stay bias-free / tanh
    qkv_bias: bool = False
    gelu_exact: bool = False
    dtype: str = "bfloat16"

    @staticmethod
    def base16(num_classes: int = 1000, attn_impl: str = "fused") -> "ViTConfig":
        return ViTConfig(num_classes=num_classes, attn_impl=attn_impl)

    @staticmethod
    def tiny(image_size: int = 32, num_classes: int = 10) -> "ViTConfig":
        return ViTConfig(
            image_size=image_size, patch_size=8, num_classes=num_classes,
            hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
        )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _AddLayerNorm(nn.Module):
    """``s = x + branch; y = LayerNorm(s)`` through the fused kernel,
    parameter-compatible with :class:`LayerNorm` (``scale`` / ``bias``)."""

    def __init__(self, eps: float = 1e-6, dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.dtype = torch_dtype(dtype)

    def forward(self, params, x: torch.Tensor, branch: torch.Tensor):
        from unionml_tpu_torch.ops.fused_norm import fused_add_layer_norm

        s, y = fused_add_layer_norm(x, branch, params["scale"], params["bias"], self.eps)
        return s, y.to(self.dtype)


class ViTBlock(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = config
        dtype = torch_dtype(cfg.dtype)
        self.fused_norm = cfg.norm_impl == "fused"
        self.ln1 = LayerNorm(dtype=dtype, impl=cfg.norm_impl)
        self.ln2 = _AddLayerNorm(dtype=dtype) if self.fused_norm else LayerNorm(dtype=dtype)
        self.attn = Attention(
            cfg.num_heads, features=cfg.hidden_dim, attn_impl=cfg.attn_impl,
            use_bias=cfg.qkv_bias, dtype=dtype,
        )
        self.mlp = MlpBlock(
            cfg.mlp_dim, cfg.hidden_dim, gated=False, gelu_approximate=not cfg.gelu_exact,
            dtype=dtype,
        )

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.fused_norm:
            # the mid-block residual add rides ln2's pass; params unchanged
            h1 = self.ln1(params["ln1"], x)
            s, h2 = self.ln2(params["ln2"], x, self.attn(params["attn"], h1))
            return s + self.mlp(params["mlp"], h2)
        x = x + self.attn(params["attn"], self.ln1(params["ln1"], x))
        return x + self.mlp(params["mlp"], self.ln2(params["ln2"], x))


class ViT(nn.Module):
    """Vision transformer: ``forward(params, images)`` with images
    ``[B, H, W, C]`` (channels last, as the reference) returns fp32 logits
    ``[B, num_classes]``."""

    def __init__(self, config: Optional[ViTConfig] = None):
        super().__init__()
        self.config = config or ViTConfig()
        self.dtype = torch_dtype(self.config.dtype)
        self.blocks = nn.ModuleList(ViTBlock(self.config) for _ in range(self.config.num_layers))
        self.ln_final = LayerNorm(dtype=self.dtype, impl=self.config.norm_impl)

    def init(self, generator: torch.Generator, example_input: torch.Tensor) -> dict:
        """Random params for this config on ``example_input``'s device
        (:func:`init_params`); the example fixes nothing else."""
        return init_params(self.config, generator=generator, device=example_input.device)

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        p, d = cfg.patch_size, cfg.hidden_dim
        x = images.to(self.dtype)
        batch, height, width, chans = x.shape
        # [B, H/p, p, W/p, p, C] -> [B, patches, p * p * C]: the strided
        # VALID conv's windows, in the kernel's (h, w, c) order
        x = x.reshape(batch, height // p, p, width // p, p, chans).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(batch, -1, p * p * chans)
        embed = params["patch_embed"]
        x = x @ embed["kernel"].to(self.dtype).reshape(p * p * chans, d)
        x = x + embed["bias"].to(self.dtype)
        cls = params["cls"].to(self.dtype).expand(batch, 1, d)
        x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = block(params[f"block_{i}"], x)
        x = self.ln_final(params["ln_final"], x)
        head = params["head"]
        return x[:, 0].float() @ head["kernel"].float() + head["bias"].float()


def init_params(
    config: ViTConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> dict:
    """A random fp32 param tree in the reference's layout on ``device``
    (``None`` = CUDA, raising without one), drawn from ``generator`` (a
    :class:`torch.Generator` on that device; seed 0 when omitted): kernels
    normal with std 1/sqrt(fan_in), biases and ``cls`` zero, ``pos_embed``
    normal with std 0.02, norm scales one. (The reference draws flax's
    initializers from a JAX key; parity tests carry JAX weights over with
    :func:`~unionml_tpu_torch.models.convert.vit_from_jax_params`.)"""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    cfg = config
    d, h, m, p = cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim, cfg.patch_size
    hd = d // h

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    def norm():
        return {"scale": torch.ones(d, device=dev, dtype=torch.float32), "bias": zeros(d)}

    def dense(shape, fan_in, bias_shape=None):
        out = {"kernel": normal(shape, fan_in**-0.5)}
        if bias_shape is not None:
            out["bias"] = zeros(*bias_shape)
        return out

    qkv_bias = (h, hd) if cfg.qkv_bias else None
    params = {
        "patch_embed": dense((p, p, 3, d), p * p * 3, (d,)),
        "cls": zeros(1, 1, d),
        "pos_embed": normal((1, cfg.num_patches + 1, d), 0.02),
    }
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = {
            "ln1": norm(),
            "attn": {
                "q": dense((d, h, hd), d, qkv_bias),
                "k": dense((d, h, hd), d, qkv_bias),
                "v": dense((d, h, hd), d, qkv_bias),
                "o": dense((h, hd, d), d, (d,) if cfg.qkv_bias else None),
            },
            "ln2": norm(),
            "mlp": {"up": dense((d, m), d, (m,)), "down": dense((m, d), m, (d,))},
        }
    params["ln_final"] = norm()
    params["head"] = dense((d, cfg.num_classes), d, (cfg.num_classes,))
    return params

