"""Device resolution shared by the port's entry points.

Every entry point that creates tensors takes ``device``: ``None`` means
the CUDA card, and a machine without one raises instead of quietly
running on the CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` selects CUDA and
    raises ``RuntimeError`` when no CUDA device is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """The torch dtype for a config dtype name (``"bfloat16"``,
    ``"float32"``) or a dtype passed through."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype
