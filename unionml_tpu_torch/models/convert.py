"""The weight bridge: a JAX Llama param tree → the port's state.

:func:`from_jax_params` takes the reference's param tree (nested dicts
of numpy arrays — ``jax.tree_util.tree_map(np.asarray, params)`` of a
``unionml_tpu`` Llama, fp or after its int8 ``quantize_params``) and
returns the same tree of torch tensors on a device, checked leaf by leaf
against the config's geometry. The layout is kept as it is (kernels
``[K, N]`` for ``x @ W``; the DenseGeneral q/k/v kernels ``[D, H, hd]``
and o ``[H, hd, D]``; int8 ``kernel_q`` ``[K, N]`` + ``scale`` ``[N]``),
so both packages compute the same products on the same numbers. The rest
of the reference's converter (HF safetensors import/export) is not
ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike, resolve_device
from unionml_tpu_torch.models.llama import LlamaConfig


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
        if isinstance(shapes[0], tuple):  # a dense site: fp or int8
            fp_shape, q_shape = shapes
            if "kernel_q" in node:
                _check(path + ("kernel_q",), leaf_shape(path + ("kernel_q",)), q_shape)
                _check(path + ("scale",), leaf_shape(path + ("scale",)), (q_shape[1],))
                seen.update({path + ("kernel_q",), path + ("scale",)})
            else:
                _check(path + ("kernel",), leaf_shape(path + ("kernel",)), fp_shape)
                seen.add(path + ("kernel",))
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
