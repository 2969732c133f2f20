"""Attention and normalization ops of the serving path.

:mod:`~unionml_tpu_torch.ops.fused_norm` and
:mod:`~unionml_tpu_torch.ops.flash_attention` wrap hand-written CUDA
kernels (``csrc/``, built by :mod:`~unionml_tpu_torch.ops._build`) beside
their plain PyTorch versions; :mod:`~unionml_tpu_torch.ops.attention` is
plain PyTorch, as its reference runs outside any Pallas kernel.
"""
