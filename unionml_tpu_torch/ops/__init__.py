"""Attention and normalization ops of the serving path.

:mod:`~unionml_tpu_torch.ops.fused_norm`,
:mod:`~unionml_tpu_torch.ops.flash_attention`,
:mod:`~unionml_tpu_torch.ops.paged_attention` and
:mod:`~unionml_tpu_torch.ops.int4_matmul` wrap hand-written CUDA
kernels (``csrc/``, built by :mod:`~unionml_tpu_torch.ops._build`) beside
their plain PyTorch versions; :mod:`~unionml_tpu_torch.ops.attention` is
plain PyTorch, as its reference runs outside any Pallas kernel.
"""
