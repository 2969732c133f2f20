"""Ring attention: sequence-parallel attention over a ring of ranks.

The port of :mod:`unionml_tpu.ops.ring_attention`. q/k/v are sharded along
the sequence axis of the mesh; each rank holds a [B, S/n, H, D] shard. The
kv shards rotate around the ring with
:func:`~unionml_tpu_torch.parallel.collectives.ppermute_shift` for ``n``
steps; every rank accumulates its local queries against each visiting kv
shard and normalizes once after the last step. Causal masking uses
**global** positions: the shard visiting rank ``r`` at step ``s`` came
from rank ``(r - s) mod n``. GQA kv shards rotate unrepeated.

- :func:`ring_attention_sharded` / :func:`ring_attention`: the blockwise
  online-softmax accumulation of
  :func:`~unionml_tpu_torch.ops.attention._blockwise_accumulate` over the
  rotating shards, differentiated by autograd through the differentiable
  rotation (its backward rotates the cotangents the other way).
- :func:`ring_flash_attention_sharded` / :func:`ring_flash_attention`:
  each ring step runs the flash kernels (rows 9-11 of the kernel table,
  through :mod:`unionml_tpu_torch.ops.flash_attention`; their plain
  versions for CPU tensors) on (local q, visiting kv). A shard entirely in
  the past runs non-causal, the diagonal causal, a future one is skipped.
  Partial outputs merge by their logsumexp in fp32 (:func:`merge_partial`).
  The backward runs the per-step kernels against the **global** lse:
  first the delta pass over every visiting shard (``delta_i = sum_j
  p_ij dp_ij`` in fp32, one kv rotation; the per-shard partials, each
  against the global lse, add up to the whole row's), then the dq and
  dk/dv kernels over a second rotation, dq summed in fp32 here and dk/dv
  in fp32 buffers that rotate with their kv shard and arrive home after
  the loop; each head's dk/dv rounds before its GQA group sum (C3, in the
  dk/dv kernel's wrapper). ``delta_impl="output_delta"`` takes the
  reference's ``delta = rowsum(dO * O)`` from the ring's bf16 output
  instead (ROADMAP.md C11 says why the port does not).

The per-step arithmetic (:func:`ring_step_kind`, :func:`ring_flash_step`,
:func:`merge_partial`, :func:`ring_delta_step`, :func:`ring_grad_step`)
is in functions of local tensors; the collective loop calls them, and a
check can drive them over virtual shards in one process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unionml_tpu_torch.ops._build import charged, checked
from unionml_tpu_torch.ops.attention import NEG_INF, _blockwise_accumulate
from unionml_tpu_torch.parallel import compat
from unionml_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute_shift

__all__ = [
    "merge_partial",
    "ring_attention",
    "ring_attention_sharded",
    "ring_delta_step",
    "ring_flash_attention",
    "ring_flash_attention_sharded",
    "ring_flash_step",
    "ring_grad_step",
    "ring_step_kind",
]

DELTA_IMPLS = ("pass", "output_delta")


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: str = "sequence",
    causal: bool = False,
    block_size: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Per-shard ring attention body (call inside ``shard_map``).

    ``q, k, v``: local shards [B, S_local, H, D] (kv may have fewer GQA
    heads); returns the local output shard. Every rank's shard has the
    same length."""
    n = axis_size(axis)
    me = axis_index(axis)
    batch, s_local, num_q_heads, head_dim = q.shape
    scale_ = scale if scale is not None else head_dim**-0.5
    dev = q.device
    acc = (torch.zeros(batch, s_local, num_q_heads, head_dim, dtype=torch.float32, device=dev),
           torch.full((batch, s_local, num_q_heads), NEG_INF, dtype=torch.float32, device=dev),
           torch.zeros(batch, s_local, num_q_heads, dtype=torch.float32, device=dev))
    k_cur, v_cur = k, v
    for s in range(n):
        kv_offset = ((me - s) % n) * s_local
        acc = _blockwise_accumulate(
            q, k_cur, v_cur, causal=causal, block_size=block_size, scale=scale_,
            q_offset=me * s_local, kv_offset=kv_offset, acc=acc,
        )
        if s < n - 1:
            k_cur = ppermute_shift(k_cur, axis, shift=1)
            v_cur = ppermute_shift(v_cur, axis, shift=1)
    out, _, l = acc
    return (out / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _global(body, q, k, v, mesh, axis):
    from unionml_tpu_torch.parallel.compat import shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    spec = P(None, axis, None, None)
    return shard_map(body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis: str = "sequence",
    causal: bool = False,
    block_size: int = 512,
    scale: Optional[float] = None,
):
    """Ring attention over globally-shaped [B,S,H,D] tensors: shards the
    sequence over ``mesh[axis]``, runs the ring and returns the output as
    a DTensor sharded the same way."""
    return _global(lambda a, b, c: ring_attention_sharded(
        a, b, c, axis=axis, causal=causal, block_size=block_size, scale=scale), q, k, v, mesh, axis)


# --------------------------------------------------------------------- #
# ring flash: the flash kernels as the per-step local compute
# --------------------------------------------------------------------- #


def ring_step_kind(src: int, me: int, causal: bool) -> str:
    """How rank ``me`` attends to the kv shard of rank ``src``: ``"full"``
    (a shard wholly in the past, or any shard without causality),
    ``"diagonal"`` (its own shard, causal) or ``"skip"`` (wholly in the
    future)."""
    if not causal or src < me:
        return "full"
    return "diagonal" if src == me else "skip"


def ring_flash_step(q, k, v, *, kind: str, scale: float):
    """One ring step's forward: ``(out_i, lse_i)`` of the flash forward
    (row 9) on (local q, visiting kv), causal for the diagonal; ``lse_i``
    [B, H, S] fp32. ``None`` for a skipped shard."""
    from unionml_tpu_torch.ops.flash_attention import (
        ROW_LSE,
        _on_card,
        flash_fwd_cost,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    if kind == "skip":
        return None
    causal = kind == "diagonal"
    with charged(flash_fwd_cost, q, k, v, causal=causal):
        if _on_card(q):
            out = flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
        else:
            out = flash_fwd_plain(q, k, v, causal=causal, scale=scale)
        return checked(out, ROW_LSE)


def merge_partial(acc_out, acc_lse, out_i, lse_i) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge NORMALIZED partials by logsumexp, in fp32: the invariant is
    ``acc_out = sum_j out_j * exp(lse_j - acc_lse)``; each update
    reweights both sides by their share of the new total. ``acc_out`` /
    ``out_i`` [B, S, H, D], ``acc_lse`` / ``lse_i`` [B, H, S]."""
    lse_i = lse_i.float()
    both_empty = (acc_lse <= NEG_INF / 2) & (lse_i <= NEG_INF / 2)
    m = torch.maximum(acc_lse, lse_i)
    w_acc = torch.exp(acc_lse - m)
    w_i = torch.exp(lse_i - m)
    total = (w_acc + w_i).clamp_min(1e-30)

    def rows(w):                                   # [B, H, S] -> [B, S, H, 1]
        return w.transpose(1, 2)[..., None]

    out = (acc_out * rows(w_acc) + out_i.float() * rows(w_i)) / rows(total)
    lse = torch.where(both_empty, torch.full_like(m, NEG_INF), m + torch.log(total))
    return out, lse


def ring_delta_step(q, k, v, do, lse, *, kind: str, scale: float) -> Optional[torch.Tensor]:
    """One ring step's share of ``delta`` (the delta pass, the dq kernel
    in its delta mode): ``sum_j p_ij dp_ij`` in fp32 over the visiting
    shard's keys, ``p`` against the GLOBAL ``lse``; [B, H, S]. ``None``
    for a skipped shard."""
    from unionml_tpu_torch.ops.flash_attention import (
        ROW_DELTA,
        _on_card,
        flash_delta,
        flash_delta_cost,
        flash_delta_cuda,
    )

    if kind == "skip":
        return None
    causal = kind == "diagonal"
    with charged(flash_delta_cost, q, k, v, causal=causal):
        if _on_card(q):
            out = flash_delta_cuda(q, k, v, do, lse, causal=causal, scale=scale)
        else:
            out = flash_delta(q, k, v, do, lse, causal=causal, scale=scale)
        return checked(out, ROW_DELTA)


def ring_grad_step(q, k, v, do, lse, delta, *, kind: str, scale: float):
    """One ring step's backward: ``(dq_i, dk_i, dv_i)`` of the dq kernel
    (row 10) and the dk/dv kernel (row 11) on (local q, visiting kv)
    against the global ``lse`` and the whole row's ``delta``; dk_i / dv_i
    at the visiting shard's kv-head width (each q head rounded, then each
    GQA group summed in fp32 and rounded once). ``None`` for a skipped
    shard."""
    from unionml_tpu_torch.ops.flash_attention import (
        ROW_BWD,
        _on_card,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_plain,
        flash_grad_cost,
    )

    if kind == "skip":
        return None
    kw = dict(causal=kind == "diagonal", scale=scale)
    with charged(flash_grad_cost, q, k, v, causal=kw["causal"]):
        if _on_card(q):
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
            grads = (dq, *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw))
        else:
            grads = flash_bwd_plain(q, k, v, do, lse, delta=delta, **kw)
        return checked(grads, ROW_BWD)


def _ring_flash_forward(q, k, v, *, axis, causal, scale):
    n = axis_size(axis)
    me = axis_index(axis)
    b, s_loc, h, d = q.shape
    out = torch.zeros(b, s_loc, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        part = ring_flash_step(q, k_cur, v_cur, kind=ring_step_kind((me - s) % n, me, causal),
                               scale=scale)
        if part is not None:
            out, lse = merge_partial(out, lse, *part)
        if s < n - 1:
            k_cur = ppermute_shift(k_cur, axis, shift=1)
            v_cur = ppermute_shift(v_cur, axis, shift=1)
    return out.to(q.dtype), lse


def _ring_flash_backward(q, k, v, out, lse, do, *, axis, causal, scale, delta_impl):
    n = axis_size(axis)
    me = axis_index(axis)

    def kind(s):
        return ring_step_kind((me - s) % n, me, causal)

    if delta_impl == "output_delta":
        from unionml_tpu_torch.ops.flash_attention import output_delta

        delta = output_delta(do, out)
    else:
        delta = torch.zeros_like(lse)
        k_cur, v_cur = k, v
        for s in range(n):
            part = ring_delta_step(q, k_cur, v_cur, do, lse, kind=kind(s), scale=scale)
            if part is not None:
                delta = delta + part
            if s < n - 1:
                k_cur = ppermute_shift(k_cur, axis, shift=1)
                v_cur = ppermute_shift(v_cur, axis, shift=1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for s in range(n):
        grads = ring_grad_step(q, k_cur, v_cur, do, lse, delta, kind=kind(s), scale=scale)
        if grads is not None:
            dq += grads[0].float()
            dk += grads[1].float()
            dv += grads[2].float()
        # the dk/dv buffers travel with their kv shard: after n rotations
        # they are back at the shard's home rank
        dk = ppermute_shift(dk, axis, shift=1)
        dv = ppermute_shift(dv, axis, shift=1)
        if s < n - 1:
            k_cur = ppermute_shift(k_cur, axis, shift=1)
            v_cur = ppermute_shift(v_cur, axis, shift=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, delta_impl):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _ring_flash_forward(q, k, v, axis=axis, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(axis=axis, causal=causal, scale=scale, delta_impl=delta_impl)
        # the backward runs outside the forward's shard_map: bind its mesh again
        ctx.mesh = compat.bound_mesh()
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with compat._mesh_scope(ctx.mesh):
            grads = _ring_flash_backward(q, k, v, out, lse, do.contiguous(), **ctx.args)
        return (*grads, None, None, None, None)


def ring_flash_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: str = "sequence",
    causal: bool = False,
    block_size: int = 512,
    scale: Optional[float] = None,
    delta_impl: str = "pass",
) -> torch.Tensor:
    """Per-shard ring attention with the flash kernels as the local
    compute (call inside ``shard_map`` with ``axis`` bound); ``q, k, v``
    local [B, S_local, H, D] shards (kv may have fewer GQA heads).
    Differentiable end to end (the module docstring's backward).
    ``block_size`` is the TPU kernels' tile and is accepted for the
    reference's callers only; ``delta_impl``: ``"pass"`` (the delta pass
    over the ring) or ``"output_delta"`` (the reference's ``rowsum(dO *
    O)``)."""
    del block_size
    if delta_impl not in DELTA_IMPLS:
        raise ValueError(f"delta_impl must be one of {DELTA_IMPLS}, got {delta_impl!r}")
    if q.shape[2] % k.shape[2] or k.shape != v.shape:
        raise ValueError(
            f"ring_flash_attention: q heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]}, and k {tuple(k.shape)} must match v {tuple(v.shape)}"
        )
    scale_ = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingFlash.apply(q, k, v, axis, causal, scale_, delta_impl)
    return _ring_flash_forward(q.contiguous(), k.contiguous(), v.contiguous(), axis=axis,
                               causal=causal, scale=scale_)[0]


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis: str = "sequence",
    causal: bool = False,
    block_size: int = 512,
    scale: Optional[float] = None,
    delta_impl: str = "pass",
):
    """Ring flash attention over globally-shaped [B,S,H,D] tensors (the
    output a DTensor sharded over ``mesh[axis]``)."""
    return _global(lambda a, b, c: ring_flash_attention_sharded(
        a, b, c, axis=axis, causal=causal, block_size=block_size, scale=scale,
        delta_impl=delta_impl), q, k, v, mesh, axis)
