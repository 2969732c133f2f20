"""Mixture-of-experts: top-k routing and expert-parallel dispatch.

The port of :mod:`unionml_tpu.ops.moe`. Two dispatch paths, one routing
math:

- **Dense one-hot dispatch** (:class:`MoEMlp`): every token runs through
  every expert (the reference's static-shaped einsums), its output
  weighted by the routing weights; no capacity limit. Under a
  :class:`~unionml_tpu_torch.parallel.ShardingConfig` whose rules shard the
  expert dim over ``expert`` (and the hidden dim over ``tensor``,
  :data:`~unionml_tpu_torch.models.llama.LLAMA_MOE_PARTITION_RULES`),
  where GSPMD inserts the collectives in the reference, the block crosses
  to local shards (:func:`_sharded_moe`): each rank routes the tokens it
  holds, runs its local experts' hidden slice over them, and the partial
  outputs are summed over ``expert`` then ``tensor`` in rank order.
- **Explicit all-to-all dispatch** (:func:`expert_parallel_moe_sharded` /
  :func:`expert_parallel_moe`): the GShard/Switch algorithm inside
  ``shard_map``: tokens bucketed per expert up to a static ``capacity``
  (overflow dropped), the buckets ride one differentiable all-to-all over
  ``expert`` to the expert-owning rank, the expert MLP runs there, and the
  reverse all-to-all brings the results back to be combined.

Routing breaks ties between equal router probabilities toward the lower
expert index, as ``jax.lax.top_k`` does (bf16 gate logits tie often;
``torch.topk`` promises no order). The load-balance loss is the Switch
recipe ``E * sum(routing_fraction * gate_fraction)`` over token means.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import torch_dtype

__all__ = [
    "MoEMlp",
    "expert_capacity",
    "expert_parallel_moe",
    "expert_parallel_moe_sharded",
    "load_balance_stats",
    "make_dispatch",
    "migrate_moe_router_params",
    "top_k_routing",
]


def load_balance_stats(probs: torch.Tensor, indices: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-expert token-MEAN stats behind the load-balance loss: probs
    [T, E] router softmax, indices [T, k]; returns ``(routing_fraction [E],
    gate_fraction [E])`` in fp32. Serial (:func:`top_k_routing`) and
    sequence-parallel training (which averages the fractions over the
    shards first) both form the loss from this function."""
    num_experts = probs.shape[-1]
    routing_fraction = F.one_hot(indices[..., 0], num_experts).float().mean(0)
    gate_fraction = probs.float().mean(0)
    return routing_fraction, gate_fraction


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, in descending order, equal
    values ordered by ascending index (``jax.lax.top_k``'s tie rule): a
    stable descending sort keeps equal entries in index order."""
    indices = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(probs, -1, indices), indices


def top_k_routing(gate_logits: torch.Tensor, num_selected: int, *, return_stats: bool = False):
    """Softmax-normalized top-k routing over gate_logits [T, E]: returns
    ``(weights [T, k] in the logits' dtype, indices [T, k], aux_loss)``,
    plus ``(routing_fraction, gate_fraction)`` when ``return_stats``."""
    num_experts = gate_logits.shape[-1]
    probs = torch.softmax(gate_logits.float(), dim=-1)
    weights, indices = _top_k(probs, num_selected)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    routing_fraction, gate_fraction = load_balance_stats(probs, indices)
    aux_loss = num_experts * (routing_fraction * gate_fraction).sum()
    weights = weights.to(gate_logits.dtype)
    if return_stats:
        return weights, indices, aux_loss, (routing_fraction, gate_fraction)
    return weights, indices, aux_loss


def expert_capacity(tokens: int, num_experts: int, num_selected: int,
                    capacity_factor: float) -> int:
    """Static per-expert token bucket size for capacity-based dispatch."""
    return max(1, int(math.ceil(num_selected * tokens * capacity_factor / num_experts)))


def make_dispatch(gate_logits: torch.Tensor, num_selected: int, capacity: int):
    """Capacity-bucketed dispatch/combine tensors (GShard tokens-choose):
    fp32 ``(dispatch [T, E, C], combine [T, E, C], aux_loss)``;
    ``dispatch[t, e, c] == 1`` iff token t holds slot c of expert e's
    bucket, ``combine`` carries its routing weight there. Priority is
    choice-major (every token's first choice is bucketed before any second
    choice), token order within a choice; overflow beyond ``capacity`` is
    dropped."""
    tokens, num_experts = gate_logits.shape
    weights, indices, aux_loss = top_k_routing(gate_logits, num_selected)
    onehot = F.one_hot(indices, num_experts)                          # [T, k, E]
    flat = onehot.transpose(0, 1).reshape(num_selected * tokens, num_experts)
    position = torch.cumsum(flat, dim=0) - flat                       # slot within expert
    keep = (position < capacity) & (flat > 0)
    slot = F.one_hot(position.clamp_max(capacity - 1), capacity).float()  # [kT, E, C]
    slotted = keep[..., None].float() * slot
    slotted = slotted.reshape(num_selected, tokens, num_experts, capacity).transpose(0, 1)
    dispatch = slotted.sum(dim=1)
    combine = (slotted * weights.float()[:, :, None, None]).sum(dim=1)
    return dispatch, combine, aux_loss


def _swiglu_experts(x, w_gate, w_up, w_down):
    """x [E, C, d]; w_* [E, d, h] / [E, h, d] -> [E, C, d]."""
    gated = F.silu(torch.einsum("ecd,edh->ech", x, w_gate))
    up = torch.einsum("ecd,edh->ech", x, w_up)
    return torch.einsum("ech,ehd->ecd", gated * up, w_down)


def expert_parallel_moe_sharded(
    x: torch.Tensor,
    router_kernel: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    axis: str = "expert",
    num_selected: int = 2,
    capacity_factor: float = 2.0,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard expert-parallel MoE body (call inside ``shard_map``):
    ``x`` the local token shard [T_local, d], ``router_kernel`` replicated
    [d, E_global], ``w_*`` the local expert shards [E_local, ...]. Returns
    the local output shard [T_local, d] and the group-mean aux loss."""
    from unionml_tpu_torch.parallel.collectives import all_to_all, axis_size, pmean

    ep = axis_size(axis)
    t_local, d = x.shape
    e_global = router_kernel.shape[-1]
    assert w_gate.shape[0] * ep == e_global, (
        f"expert weights shard {w_gate.shape[0]} x axis {ep} != {e_global} experts"
    )
    cap = (expert_capacity(t_local, e_global, num_selected, capacity_factor)
           if capacity is None else capacity)
    if cap < 1:
        raise ValueError(f"capacity must be >= 1, got {cap}")
    gate_logits = (x @ router_kernel.to(x.dtype)).float()
    dispatch, combine, aux = make_dispatch(gate_logits, num_selected, cap)
    # bucket the local tokens per global expert: [E_global, C, d]
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    # expert e lives on rank e // E_local: one all-to-all ships every bucket
    # to its owner, the source ranks concatenated along the slot dim
    expert_in = all_to_all(expert_in, axis, split_axis=0, concat_axis=1)
    out = _swiglu_experts(expert_in, w_gate, w_up, w_down)            # [E_local, ep*C, d]
    # the reverse route: slot-dim chunks back to their source ranks
    out = all_to_all(out, axis, split_axis=1, concat_axis=0)
    y = torch.einsum("ecd,tec->td", out, combine.to(x.dtype))
    return y.to(x.dtype), pmean(aux, axis)


def expert_parallel_moe(
    x: torch.Tensor,
    router_kernel: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    mesh,
    *,
    axis: str = "expert",
    num_selected: int = 2,
    capacity_factor: float = 2.0,
    capacity: Optional[int] = None,
):
    """Expert-parallel MoE over globally-shaped tensors: ``x`` [T, d]
    sharded over ``mesh[axis]``, the expert weights [E, ...] sharded the
    same way on their expert dim. Returns ``(out [T, d] sharded like x,
    aux_loss)`` as DTensors."""
    from unionml_tpu_torch.parallel.compat import shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    def body(*args):
        return expert_parallel_moe_sharded(
            *args, axis=axis, num_selected=num_selected, capacity_factor=capacity_factor,
            capacity=capacity)

    tok, ew = P(axis, None), P(axis, None, None)
    return shard_map(body, mesh=mesh, in_specs=(tok, P(None, None), ew, ew, ew),
                     out_specs=(tok, P()))(x, router_kernel, w_gate, w_up, w_down)


# --------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------- #


def _expert_matmul(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """``x`` [E, T, K] by each expert's ``w`` [E, K, N]. Float weights:
    the product in ``dtype``. int8 weights: per expert an fp32-accumulated
    product with an fp32 result, times the fp32 ``scale`` [E, N], then one
    cast to ``dtype`` (the int8 dense layer's recipe, the reference's
    rounding point)."""
    if scale is None:
        return torch.einsum("etd,edh->eth", x, w.to(dtype))
    from unionml_tpu_torch.models.quantization import weight_product

    return torch.stack([weight_product(x[e], w[e], scale[e]).to(dtype)
                        for e in range(w.shape[0])])


def _experts_out(tokens, combine, weights: dict, dtype) -> torch.Tensor:
    """The dense dispatch over the experts ``weights`` holds (all of them,
    or a rank's local ones with their ``combine`` columns): every token
    through every expert, the outputs summed under ``combine`` [T, E]."""
    mask = (combine > 0).to(dtype)
    expert_in = mask.t()[:, :, None] * tokens.to(dtype)[None]         # [E, T, d]
    gated = F.silu(_expert_matmul(expert_in, weights["gate"], weights.get("gate_s"), dtype))
    up = _expert_matmul(expert_in, weights["up"], weights.get("up_s"), dtype)
    expert_out = _expert_matmul(gated * up, weights["down"], weights.get("down_s"), dtype)
    return torch.einsum("etd,te->td", expert_out, combine)


def _combine(weights: torch.Tensor, indices: torch.Tensor, num_experts: int, dtype):
    """[T, E] routing weight of each token at each expert (0 where not
    routed): the reference's ``einsum("tke,tk->te", one_hot, weights)``."""
    dispatch = F.one_hot(indices, num_experts).to(dtype)
    return torch.einsum("tke,tk->te", dispatch, weights.to(dtype))


class MoEMlp(nn.Module):
    """Expert-parallel SwiGLU MLP block (``forward(params, x) -> (out,
    aux_loss)``; x [batch, seq, model_dim]).

    Params: ``router_kernel`` fp32 [d, E] (routing updates are tiny and
    would round to zero in bf16 master weights) and ``w_gate`` / ``w_up``
    [E, d, h], ``w_down`` [E, h, d]; or, ``quantized``, int8 ``w_*_q`` with
    per-(expert, out-channel) fp32 ``w_*_scale`` [E, N] (filled by
    :func:`~unionml_tpu_torch.models.quantization.quantize_params`). The
    dense dispatch runs every expert on every token (the reference's
    arithmetic). ``sow`` (a dict) receives the token-mean routing and gate
    fractions under ``"moe_stats"``, which the sequence-parallel loss
    averages over the shards before re-forming the aux loss."""

    def __init__(self, num_experts: int, num_selected: int, hidden_dim: int, model_dim: int,
                 dtype: Any = torch.bfloat16, quantized: bool = False):
        super().__init__()
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.hidden_dim = hidden_dim
        self.model_dim = model_dim
        self.dtype = torch_dtype(dtype)
        self.quantized = quantized

    def _expert_weights(self, params) -> dict:
        if self.quantized:
            return {name: params[f"w_{name}_q"] for name in ("gate", "up", "down")} | {
                f"{name}_s": params[f"w_{name}_scale"] for name in ("gate", "up", "down")}
        return {name: params[f"w_{name}"] for name in ("gate", "up", "down")}

    def route(self, router_kernel, tokens):
        """``(weights, indices, aux_loss, (routing_fraction,
        gate_fraction))`` of ``tokens`` [T, d]."""
        gate_logits = tokens @ router_kernel.to(tokens.dtype)
        return top_k_routing(gate_logits, self.num_selected, return_stats=True)

    def forward(self, params, x: torch.Tensor, *, sow: Optional[dict] = None):
        from unionml_tpu_torch.parallel.compat import is_dtensor

        if is_dtensor(x):
            return _sharded_moe(self, params, x, sow)
        from unionml_tpu_torch.models.layers import _TP

        tp = _TP.get()
        if tp is not None:
            return _local_moe(self, params, x, tp)
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        weights, indices, aux, (rf, gf) = self.route(params["router_kernel"], tokens)
        if sow is not None:
            sow.setdefault("moe_stats", []).append(torch.stack([rf, gf]))
        combine = _combine(weights, indices, self.num_experts, self.dtype)
        out = _experts_out(tokens, combine, self._expert_weights(params), self.dtype)
        return out.reshape(b, s, d).to(self.dtype), aux


def _sharded_moe(block: MoEMlp, params, x, sow):
    """:class:`MoEMlp` on DTensors (see the module docstring): two local
    calls. The routing runs on each rank's rows with the router whole; its
    fractions are averaged over the mesh dims that split the rows (a
    rank-ordered ``pmean``), so the aux loss is the global one on every
    rank. The experts run on each rank's rows and local experts' hidden
    slice; their partial outputs are summed over the mesh dims that
    split the experts (``expert``, then ``tensor``) in rank order. The
    collectives: the fractions' ``pmean`` over the batch axes, the output's
    ``psum`` over the expert-weight axes, and, in the backward, DTensor's
    sums of the routing weights' and the input's partial gradients over
    those axes and the parameter gradients' sums over the batch axes
    (:func:`~unionml_tpu_torch.parallel.sharding.resolve_grads`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from unionml_tpu_torch.models.layers import _replicated, _row_grads, _whole
    from unionml_tpu_torch.parallel import compat
    from unionml_tpu_torch.parallel.collectives import pmean_invariant, psum_invariant
    from unionml_tpu_torch.parallel.sharding import local_slices

    x = _whole(x, -1)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    experts = block._expert_weights(params)
    first = experts["gate"]
    expert_dims = [names[i] for i, p in enumerate(first.placements) if isinstance(p, Shard)] \
        if compat.is_dtensor(first) else []
    # the rows whole over the expert-weight axes: each of their ranks runs
    # its experts over all the rows its batch shard holds
    want = [Replicate() if names[i] in expert_dims else p for i, p in enumerate(x.placements)]
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    row_axes = tuple(names[i] for i, p in enumerate(x.placements) if isinstance(p, Shard))
    router = _replicated(params["router_kernel"], mesh)
    replicated = [Replicate()] * mesh.ndim

    def route(xl, rk):
        b, s, d = xl.shape
        weights, indices, _, (rf, gf) = block.route(rk, xl.reshape(b * s, d))
        with compat._mesh_scope(mesh):
            if row_axes:
                rf, gf = pmean_invariant(rf, row_axes), pmean_invariant(gf, row_axes)
        aux = block.num_experts * (rf * gf).sum()
        k = weights.shape[-1]
        return weights.reshape(b, s, k), indices.reshape(b, s, k), aux, torch.stack([rf, gf])

    weights, indices, aux, fractions = compat.local_call(
        route, [x, router], [x.placements, _row_grads(x)],
        [x.placements, x.placements, replicated, replicated], mesh)
    if sow is not None:
        sow.setdefault("moe_stats", []).append(fractions)

    e0 = local_slices(first.shape, mesh, first.placements)[0].start \
        if compat.is_dtensor(first) else 0
    # each rank's partial output is a share of a sum over the expert-weight
    # axes: so are its inputs' gradients
    partial_rows = [Partial() if names[i] in expert_dims else p
                    for i, p in enumerate(x.placements)]
    keys = list(experts)

    def grad_placements(t):
        if not compat.is_dtensor(t):
            return None
        return [Partial() if isinstance(p, Replicate) and isinstance(x.placements[i], Shard)
                else p for i, p in enumerate(t.placements)]

    def run(xl, wl, il, *ws):
        b, s, d = xl.shape
        local = dict(zip(keys, ws))
        e_local = local["gate"].shape[0]
        combine = _combine(wl.reshape(b * s, -1), il.reshape(b * s, -1), block.num_experts,
                           block.dtype)[:, e0:e0 + e_local]
        out = _experts_out(xl.reshape(b * s, d), combine, local, block.dtype)
        with compat._mesh_scope(mesh):
            for axis in ("expert", "tensor"):
                if axis in expert_dims:
                    out = psum_invariant(out, axis)
        return out.reshape(b, s, d).to(block.dtype)

    args = [x, weights, indices] + [experts[k] for k in keys]
    grads = [partial_rows, partial_rows, x.placements] + [grad_placements(experts[k])
                                                         for k in keys]
    out = compat.local_call(run, args, grads, x.placements, mesh)
    return out, aux


def _local_moe(block: MoEMlp, params, x, tp):
    """:class:`MoEMlp` on a served tree's local shards (a
    :class:`~unionml_tpu_torch.models.layers.LocalParams` forward): the
    router whole on every rank, each rank's experts on their hidden slice
    over all the rows, the partial outputs summed over ``expert`` then
    ``tensor`` in rank order, as :func:`_sharded_moe` sums them in
    training. The dense dispatch stays the reference's."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    weights, indices, aux, _ = block.route(params["router_kernel"], tokens)
    experts = block._expert_weights(params)
    e_local, h_local = experts["gate"].shape[0], experts["gate"].shape[-1]
    e0 = tp.expert.rank * e_local if e_local < block.num_experts else 0
    combine = _combine(weights, indices, block.num_experts, block.dtype)[:, e0:e0 + e_local]
    out = _experts_out(tokens, combine, experts, block.dtype)
    if e_local < block.num_experts:
        out = _axis_sum(out, tp.expert, "expert")
    if h_local < block.hidden_dim:
        out = _axis_sum(out, tp, "tensor")
    return out.reshape(b, s, d).to(block.dtype), aux


def _axis_sum(out: torch.Tensor, axis, name: str) -> torch.Tensor:
    """The rank-ordered sum of a served MoE block's partial output over
    one mesh axis (``axis``: its :class:`~unionml_tpu_torch.models.layers
    .TensorParallel`; ``name`` says which)."""
    from unionml_tpu_torch.parallel.collectives import ordered_sum

    return ordered_sum(out, axis.group)


def migrate_moe_router_params(params):
    """Rename old-layout MoE router params to the current layout: every
    nested ``{'router': {'kernel': ...}}`` (the router as a Dense
    submodule) becomes a direct fp32 ``router_kernel`` in a copied tree;
    an old ``router/bias`` is dropped (the router is bias-free). Accepts
    any Mapping and returns plain nested dicts; leaves become tensors
    where they were arrays."""
    from collections.abc import Mapping

    if not isinstance(params, Mapping):
        return params
    out = {}
    for k, v in params.items():
        if k == "router" and isinstance(v, Mapping) and set(v) <= {"kernel", "bias"} \
                and "kernel" in v:
            out["router_kernel"] = torch.as_tensor(v["kernel"]).to(torch.float32)
        else:
            out[k] = migrate_moe_router_params(v)
    return out
