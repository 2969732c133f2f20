"""The weight bridges: a JAX Llama or ViT param tree → the port's state.

:func:`from_jax_params` takes the reference's param tree (nested dicts
of numpy arrays — ``jax.tree_util.tree_map(np.asarray, params)`` of a
``unionml_tpu`` Llama, fp or after its ``quantize_params`` with
``bits=8`` or ``bits=4``) and
returns the same tree of torch tensors on a device, checked leaf by leaf
against the config's geometry. The layout is kept as it is (kernels
``[K, N]`` for ``x @ W``; the DenseGeneral q/k/v kernels ``[D, H, hd]``
and o ``[H, hd, D]``; int8 ``kernel_q`` ``[K, N]`` + ``scale`` ``[N]``;
packed int4 ``kernel_p`` ``[K, N/2]`` + ``scale`` ``[N]`` or ``scale_g``
``[K/g, N]``), so both packages compute the same products on the same
numbers. For a ``weight_bits=4`` config each site must carry the form
the config's layer declares there (int4 where ``tile_for`` gives a tile
and the group divides K, the int8 fallback elsewhere); a tree packed for
another tile or group is refused rather than decoded wrong. The rest
of the reference's converter (HF safetensors import/export) is not
ported yet.

:func:`vit_from_jax_params` does the same for a ``unionml_tpu`` ViT tree
(fp32 params): the flax Conv kernel ``[p, p, C, D]`` (HWIO), Dense kernels
``[in, out]``, q/k/v ``[D, H, hd]`` and o ``[H, hd, D]`` (with their biases
under ``qkv_bias``), LayerNorm ``scale`` / ``bias``, ``cls``, ``pos_embed``
and ``head``, every leaf checked against the shape the
:class:`~unionml_tpu_torch.models.vit.ViTConfig` declares.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.llama import LlamaConfig
from unionml_tpu_torch.models.quantization import INT4_COLUMN_PARALLEL, int4_tile
from unionml_tpu_torch.models.vit import ViTConfig


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy torch may own
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _dense_shapes(config: LlamaConfig) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], Tuple[int, int]]]:
    """Per dense site (path relative to its block or the root): the fp
    kernel shape and the int8 ``[K, N]`` shape."""
    c = config
    d, hd, h, kvh = c.hidden_dim, c.head_dim, c.num_heads, c.num_kv_heads
    return {
        ("attn", "q"): ((d, h, hd), (d, h * hd)),
        ("attn", "k"): ((d, kvh, hd), (d, kvh * hd)),
        ("attn", "v"): ((d, kvh, hd), (d, kvh * hd)),
        ("attn", "o"): ((h, hd, d), (h * hd, d)),
        ("mlp", "gate"): ((d, c.mlp_dim), (d, c.mlp_dim)),
        ("mlp", "up"): ((d, c.mlp_dim), (d, c.mlp_dim)),
        ("mlp", "down"): ((c.mlp_dim, d), (c.mlp_dim, d)),
    }


def _int4_site(config: LlamaConfig, path: Tuple[str, ...], k: int, n: int) -> bool:
    """Whether the config's layer at ``path`` (``[K, N]``) is packed int4
    (else the int8 fallback), as ``Int4DenseGeneral`` decides it."""
    shards = config.int4_tp if path[-1] in INT4_COLUMN_PARALLEL else 1
    return bool(int4_tile(k, n, shards=shards, group_size=config.int4_group))


def _check_dense(config: LlamaConfig, path, node, shapes, leaf_shape, seen) -> None:
    fp_shape, (k, n) = shapes
    if config.quantized and config.weight_bits == 4:
        form = "int4" if _int4_site(config, path, k, n) else "int8"
    else:
        form = "int8" if "kernel_q" in node else "fp"
    if form == "int4":
        if "kernel_p" not in node:
            raise ValueError(
                f"param {'/'.join(path)}: this int4 config packs the site "
                f"(kernel_p), the tree has {sorted(node)}"
            )
        g = config.int4_group
        leaves = {"kernel_p": (k, n // 2), ("scale_g" if g else "scale"): ((k // g, n) if g else (n,))}
    elif form == "int8":
        if "kernel_q" not in node:
            raise ValueError(
                f"param {'/'.join(path)}: expected the int8 form (kernel_q + scale), "
                f"the tree has {sorted(node)}"
            )
        leaves = {"kernel_q": (k, n), "scale": (n,)}
    else:
        leaves = {"kernel": fp_shape}
    for name, want in leaves.items():
        _check(path + (name,), leaf_shape(path + (name,)), want)
        seen.add(path + (name,))


def _expected(config: LlamaConfig) -> Dict[Tuple[str, ...], Any]:
    """Every dense site's path → (fp shape, int8 shape), and every other
    leaf's path → its shape."""
    d, v = config.hidden_dim, config.vocab_size
    out: Dict[Tuple[str, ...], Any] = {
        ("embed", "embedding"): (v, d),
        ("final_norm", "scale"): (d,),
        ("lm_head",): ((d, v), (d, v)),
    }
    for i in range(config.num_layers):
        block = f"block_{i}"
        out[(block, "attn_norm", "scale")] = (d,)
        out[(block, "mlp_norm", "scale")] = (d,)
        for site, shapes in _dense_shapes(config).items():
            out[(block,) + site] = shapes
    return out


def from_jax_params(params: Mapping, config: LlamaConfig, device: DeviceLike = None) -> dict:
    """The reference's Llama param tree (numpy leaves) as torch tensors on
    ``device`` (``None`` = CUDA, raising without one), same nesting and
    layout. Raises ``ValueError`` on a missing or extra leaf or a shape
    that does not match ``config``."""
    dev = resolve_device(device)
    expected = _expected(config)

    def leaf_shape(path):
        return tuple(np.shape(_get(params, path)))

    seen = set()
    for path, shapes in expected.items():
        node = _get(params, path)
        if isinstance(shapes[0], tuple):  # a dense site: fp, int8 or int4
            _check_dense(config, path, node, shapes, leaf_shape, seen)
        else:
            _check(path, tuple(np.shape(node)), shapes)
            seen.add(path)

    def convert(node, path):
        if isinstance(node, Mapping):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if path not in seen:
            raise ValueError(f"unexpected leaf {'/'.join(path)} for this LlamaConfig")
        return _to_tensor(node, dev)

    return convert(params, ())


def _get(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise ValueError(f"missing param {'/'.join(path)}")
        node = node[key]
    return node


def _check(path, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"param {'/'.join(path)} has shape {tuple(got)}, expected {tuple(want)}")


def _vit_shapes(config: ViTConfig, channels: int) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Every leaf of a ViT tree and its shape."""
    c = config
    d, h, m, p = c.hidden_dim, c.num_heads, c.mlp_dim, c.patch_size
    hd = d // h
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {
        ("patch_embed", "kernel"): (p, p, channels, d),
        ("patch_embed", "bias"): (d,),
        ("cls",): (1, 1, d),
        ("pos_embed",): (1, c.num_patches + 1, d),
        ("ln_final", "scale"): (d,),
        ("ln_final", "bias"): (d,),
        ("head", "kernel"): (d, c.num_classes),
        ("head", "bias"): (c.num_classes,),
    }
    for i in range(c.num_layers):
        b = f"block_{i}"
        for ln in ("ln1", "ln2"):
            out[(b, ln, "scale")] = (d,)
            out[(b, ln, "bias")] = (d,)
        for name in ("q", "k", "v"):
            out[(b, "attn", name, "kernel")] = (d, h, hd)
            if c.qkv_bias:
                out[(b, "attn", name, "bias")] = (h, hd)
        out[(b, "attn", "o", "kernel")] = (h, hd, d)
        if c.qkv_bias:
            out[(b, "attn", "o", "bias")] = (d,)
        out[(b, "mlp", "up", "kernel")] = (d, m)
        out[(b, "mlp", "up", "bias")] = (m,)
        out[(b, "mlp", "down", "kernel")] = (m, d)
        out[(b, "mlp", "down", "bias")] = (d,)
    return out


def vit_from_jax_params(params: Mapping, config: ViTConfig, device: DeviceLike = None) -> dict:
    """The reference's ViT param tree (numpy leaves) as torch tensors on
    ``device`` (``None`` = CUDA, raising without one), same nesting and
    layout. The patch kernel's input channels come from the tree; every
    other dimension must match ``config``. Raises ``ValueError`` on a
    missing or extra leaf or a wrong shape."""
    dev = resolve_device(device)
    kernel = np.shape(_get(params, ("patch_embed", "kernel")))
    if len(kernel) != 4:
        raise ValueError(f"param patch_embed/kernel has shape {kernel}, expected [p, p, C, D]")
    expected = _vit_shapes(config, kernel[2])
    for path, shape in expected.items():
        _check(path, tuple(np.shape(_get(params, path))), shape)

    def convert(node, path):
        if isinstance(node, Mapping):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if path not in expected:
            raise ValueError(f"unexpected leaf {'/'.join(path)} for this ViTConfig")
        return _to_tensor(node, dev)

    return convert(params, ())
