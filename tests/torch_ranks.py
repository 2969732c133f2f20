"""A pool of gloo ranks for the port's multi-rank tests, and their bodies.

Tests of ``unionml_tpu_torch.parallel`` need several processes joined by a
``torch.distributed`` group. :class:`RankPool` starts ``world`` worker
processes once (``python tests/torch_ranks.py``), each joining a gloo
group over a local TCP store, and :meth:`RankPool.run` calls one
function of this module in every rank and returns each rank's result.
Every wait is bounded: the group has a collective timeout, and a call
that outlasts its own timeout kills the ranks and raises, so a hung
collective fails one test instead of the suite.

This module imports neither JAX nor the JAX package (the ranks must not):
the rank bodies below return numpy values, which the tests hold against
the JAX package in the pytest process. A body of another module beside
this one (``tests/torch_ranks_a6b.py``) is called as ``"module:function"``.
"""

from __future__ import annotations

import os
import secrets
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Client, Listener
from typing import Any, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: A rank's collectives raise after this many seconds without progress.
GROUP_TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` gloo ranks, started once and reused across calls. With
    ``connect=False`` the constructor returns once the rank processes are
    spawned and the first :meth:`submit` waits for them to join, so their
    start-up overlaps the caller's own work."""

    def __init__(self, world: int, *, start_timeout: float = 120.0, connect: bool = True):
        self.world = world
        self._key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=self._key)
        self._listener._listener._socket.settimeout(start_timeout)
        host, port = self._listener.address
        store = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                   TORCH_CPP_LOG_LEVEL="ERROR")
        env.pop("XLA_FLAGS", None)
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), host, str(port),
                 self._key.hex(), str(rank), str(world), str(store)],
                env=env, cwd=REPO, stdin=subprocess.DEVNULL,
            )
            for rank in range(world)
        ]
        self._conns: List[Any] = [None] * world
        self._connected = False
        if connect:
            self._connect()

    def _connect(self) -> None:
        """Wait (within ``start_timeout``) for every rank to join."""
        if self._connected:
            return
        try:
            for _ in range(self.world):
                conn = self._listener.accept()
                self._conns[conn.recv()] = conn
        except BaseException:
            self.close()
            raise
        self._connected = True

    def submit(self, name: str, *args: Any, **kwargs: Any) -> "RankPool":
        """Start ``name(*args, **kwargs)`` in every rank and return at once
        (collect the results with :meth:`collect`), so the caller can
        compute its reference meanwhile."""
        if self._procs is None:
            raise RuntimeError("the rank pool was closed (an earlier call failed or hung)")
        self._connect()
        self._pending = name
        for conn in self._conns:
            conn.send((name, args, kwargs))
        return self

    def collect(self, timeout: float = 90.0) -> List[Any]:
        """The results of the submitted call by rank. A failure in any rank
        raises with its traceback; a call that outlasts ``timeout`` kills
        the pool and raises ``TimeoutError``."""
        name = self._pending
        deadline = time.monotonic() + timeout
        out: List[Any] = [None] * self.world
        errors = []
        for rank, conn in enumerate(self._conns):
            left = deadline - time.monotonic()
            if left <= 0 or not conn.poll(left):
                self.close()
                raise TimeoutError(f"rank {rank} did not finish {name} within {timeout} s")
            ok, value = conn.recv()
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError(f"{name} failed:\n" + "\n".join(errors))
        return out

    def run(self, name: str, *args: Any, timeout: float = 90.0, **kwargs: Any) -> List[Any]:
        """``name(*args, **kwargs)`` in every rank; the list of results by
        rank (see :meth:`collect`)."""
        return self.submit(name, *args, **kwargs).collect(timeout)

    def close(self) -> None:
        procs, self._procs = self._procs, None
        if procs is None:
            return
        if not self._connected:   # never used: nothing to shut down politely
            for p in procs:
                p.kill()
                p.wait()
            self._listener.close()
            return
        for conn in self._conns:
            try:
                if conn is not None:
                    conn.send(None)
            except OSError:
                pass
        deadline = time.monotonic() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()


def _serve(host: str, port: int, key: bytes, rank: int, world: int, store: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    # the imports every body needs, before joining the pool: with a pool
    # that connects lazily they load while the caller works
    import torch.distributed.tensor  # noqa: F401

    import unionml_tpu_torch.models  # noqa: F401
    import unionml_tpu_torch.parallel  # noqa: F401

    conn = Client((host, port), authkey=key)
    conn.send(rank)
    bodies = sys.modules[__name__]
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            if ":" in name:   # "module:function", a body of another rank module
                import importlib

                mod, _, name = name.partition(":")
                result = getattr(importlib.import_module(mod), name)(*args, **kwargs)
            else:
                result = getattr(bodies, name)(*args, **kwargs)
            assert "jax" not in sys.modules, "a rank imported JAX"
            conn.send((True, result))
        except Exception:
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


# --------------------------------------------------------------------- #
# rank bodies (run in every rank; numpy in, numpy out)
# --------------------------------------------------------------------- #


def _torch_tree(tree: Any) -> Any:
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _numpy_tree(tree: Any) -> Any:
    import torch

    from unionml_tpu_torch.parallel.compat import is_dtensor

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if is_dtensor(tree):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.detach().numpy()
    return tree


def _rules(name: str):
    if not name:
        return ()
    from unionml_tpu_torch.models import bert, lora, mlp, vit
    from unionml_tpu_torch.models import llama

    for mod in (llama, vit, bert, mlp, lora):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def _module(kind: str, cfg: dict):
    from unionml_tpu_torch.models import train

    if kind == "vit":
        from unionml_tpu_torch.models.vit import ViT, ViTConfig

        module = ViT(ViTConfig(**cfg))
        return module, train.classification_step
    if kind == "mlp":
        from unionml_tpu_torch.models.mlp import Mlp, MlpConfig

        module = Mlp(MlpConfig(**cfg))
        return module, train.classification_step
    from unionml_tpu_torch.models.llama import Llama, LlamaConfig

    return Llama(LlamaConfig(**cfg)), train.lm_step


class _Faults:
    """Planted faults the parity tests must catch."""

    def __init__(self, name):
        self.name = name
        self.undo = []

    def __enter__(self):
        import torch

        if self.name == "skip_allreduce":
            from torch.distributed.tensor import DTensor, Partial, Replicate

            from unionml_tpu_torch.models import train
            from unionml_tpu_torch.models.train import tree_map

            pending = train._pending_grads

            def no_data_sum(p, g):
                # each rank takes its own rows' share of the sum over
                # `data` as if it were the whole gradient
                names = g.device_mesh.mesh_dim_names
                pl = [Replicate() if isinstance(x, Partial) and names[i] == "data" else x
                      for i, x in enumerate(g.placements)]
                return DTensor.from_local(g.to_local(), g.device_mesh, pl, run_check=False,
                                          shape=g.shape, stride=g.stride())

            self._patch(train, "_pending_grads",
                        lambda params, grads: pending(params, tree_map(no_data_sum, params, grads)))
        elif self.name == "drop_gqa_offset":
            from unionml_tpu_torch.models import layers

            self._patch(layers, "_local_kv_heads",
                        lambda n, offset, group, device: torch.arange(n, device=device) // group)
        elif self.name:
            raise KeyError(self.name)
        return self

    def _patch(self, mod, attr, value):
        self.undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def __exit__(self, *exc):
        for mod, attr, value in reversed(self.undo):
            setattr(mod, attr, value)


def sgd(learning_rate: float):
    """Plain SGD as an elementwise port optimizer (parity checks use it:
    Adam's m / sqrt(v) turns near-zero gradients into +-lr coin flips)."""
    from unionml_tpu_torch.models.train import Optimizer, tree_leaves, tree_unflatten

    def init(params):
        return {}

    def update(grads, state, params):
        return tree_unflatten(grads, [g * -learning_rate for g in tree_leaves(grads)]), state

    return Optimizer(init, update, elementwise=True)


def bridged_steps(kind: str, cfg: dict, jax_params: Any, batches: List[Any], *,
                  sharding: Any = None, rules: str = "", lr: float = 0.1,
                  accumulate_steps: int = 1, overlap: str = "", fault: str = "",
                  overlap_axes: Any = ("data",)) -> dict:
    """The reference's params (numpy, its layout) bridged into the port,
    then SGD steps of the zoo's step factory, unsharded or sharded:
    the losses and the final params (whole, numpy)."""
    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.train import (
        GradOverlap, TrainState, grad_overlap_scope)
    from unionml_tpu_torch.parallel import ShardingConfig, compile_step

    module, factory = _module(kind, cfg)
    config = module.config
    lora = kind == "llama" and config.lora_rank > 0
    if kind == "vit":
        params = convert.vit_from_jax_params(jax_params, config, device="cpu")
    elif kind == "mlp":
        params = convert.mlp_from_jax_params(jax_params, config, device="cpu")
    else:
        params = convert.from_jax_params(jax_params, config, device="cpu")
    if lora:
        from unionml_tpu_torch.models.lora import LoRATrainState, split_lora_params

        adapters, frozen = split_lora_params(params)
        state = LoRATrainState.create(apply_fn=module, params=adapters, tx=sgd(lr),
                                      frozen_params=frozen)
    else:
        state = TrainState.create(apply_fn=module, params=params, tx=sgd(lr))
    step = factory(module, accumulate_steps=accumulate_steps)
    sc = None
    if sharding is not None:
        sc = ShardingConfig(**sharding, rules=_rules(rules))
        if accumulate_steps > 1:
            sc = sc.microbatched()
        step, state = compile_step(step, state, sharding=sc)
    ov = {"": None, "defer": GradOverlap(mode="defer")}.get(overlap)
    if overlap == "shard_map":
        ov = GradOverlap(mode="shard_map", mesh=sc.mesh(), axes=tuple(overlap_axes))
    losses = []
    with grad_overlap_scope(ov), _Faults(fault):
        for batch in batches:
            state, metrics = step(state, _torch_tree(batch))
            losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": _numpy_tree(state.params)}


def mesh_layout(axes: dict, dcn_axes: Any = None) -> dict:
    """The rank array and axis sizes of a real DeviceMesh."""
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.parallel.mesh import mesh_shape

    mesh = make_mesh(axes, dcn_axes=dcn_axes)
    return {"ranks": mesh.mesh.numpy(), "shape": mesh_shape(mesh),
            "coordinate": list(mesh.get_coordinate())}


def hybrid_psum() -> Any:
    """``psum`` over ``data`` of one element per rank on the hybrid mesh
    (data 2 over two hosts x tensor 2), element ``d * 2 + t`` on (d, t)."""
    import torch

    from unionml_tpu_torch.parallel import make_mesh, shard_map
    from unionml_tpu_torch.parallel.collectives import psum
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = make_mesh({"data": 2, "tensor": 2}, dcn_axes={"data": 2})
    out = shard_map(lambda x: psum(x, "data"), mesh=mesh, in_specs=P(("data", "tensor")),
                    out_specs=P(("data", "tensor")))(torch.arange(4.0))
    return out.full_tensor().numpy()


def collectives(x: Any) -> dict:
    """Each named collective under shard_map over ``data=4`` (x's rows
    split over the ranks), its result whole."""
    import torch

    from unionml_tpu_torch.parallel import collectives as c
    from unionml_tpu_torch.parallel import make_mesh, shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = make_mesh({"data": 4})
    x = torch.from_numpy(x)
    c.COLLECTIVES.reset()

    def run(fn, out_spec):
        return shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=out_spec)(x) \
            .full_tensor().numpy()

    out = {
        "psum": run(lambda b: c.psum(b, "data"), P()),
        "pmean": run(lambda b: c.pmean(b, "data"), P()),
        "all_gather": run(lambda b: c.all_gather(b, "data", gather_axis=1), P()),
        "reduce_scatter": run(lambda b: c.reduce_scatter(b, "data", scatter_axis=1),
                              P("data")),
        "ppermute": run(lambda b: c.ppermute_shift(b, "data", shift=1), P("data")),
        "all_to_all": run(lambda b: c.all_to_all(b, "data", split_axis=1, concat_axis=0),
                          P("data")),
        "axis_index": run(lambda b: b * 0 + c.axis_index("data"), P("data")),
        "axis_size": run(lambda b: b * 0 + c.axis_size("data"), P("data")),
    }
    out["issued"] = dict(c.COLLECTIVES.counts)
    return out


def untiled_all_to_all(x: Any, cases: List[tuple], cotangents: List[Any]) -> List[dict]:
    """``all_to_all(tiled=False)`` under shard_map over ``data=4`` (x's
    rows split over the ranks) for each ``(split_axis, concat_axis)``: the
    result whole and x's gradient for the cotangent (whole)."""
    import torch

    from unionml_tpu_torch.parallel import collectives as c
    from unionml_tpu_torch.parallel import make_mesh, shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = make_mesh({"data": 4})
    out = []
    for (split, concat), ct in zip(cases, cotangents):
        t = torch.from_numpy(x).requires_grad_()
        whole = shard_map(lambda b: c.all_to_all(b, "data", split_axis=split, concat_axis=concat,
                                                 tiled=False),
                          mesh=mesh, in_specs=P("data"), out_specs=P("data"))(t).full_tensor()
        (grad,) = torch.autograd.grad(whole, [t], grad_outputs=torch.from_numpy(ct))
        out.append({"out": whole.detach().numpy(), "grad": grad.numpy()})
    return out


def bucketed(tree: Any, bucket_sizes: List[int]) -> dict:
    """bucketed_psum of ``tree`` (rows split over data=4) at each bucket
    size against the leaf-wise psum: bit equality and the all-reduces
    each issued."""
    import numpy as np
    import torch

    from unionml_tpu_torch.parallel import collectives as c
    from unionml_tpu_torch.parallel import make_mesh, shard_map
    from unionml_tpu_torch.parallel.sharding import PartitionSpec as P

    mesh = make_mesh({"data": 4})
    tree = _torch_tree(tree)
    plain = shard_map(lambda t: {k: c.psum(v, "data") for k, v in t.items()}, mesh=mesh,
                      in_specs=P("data"), out_specs=P())(tree)
    out = {"equal": [], "issued": [],
           "psum": {k: v.full_tensor().numpy() for k, v in plain.items()}}
    for size in bucket_sizes:
        c.COLLECTIVES.reset()
        got = shard_map(lambda t: c.bucketed_psum(t, "data", bucket_bytes=size), mesh=mesh,
                        in_specs=P("data"), out_specs=P())(tree)
        out["issued"].append(c.COLLECTIVES.total)
        out["equal"].append(all(np.array_equal(got[k].full_tensor().numpy(),
                                               out["psum"][k]) for k in tree))
    # the grouping: greedy fill in order, an oversized leaf alone
    c.COLLECTIVES.reset()
    sizes = [100, 100, 100, 1000, 10]
    leaves = [torch.zeros(4 * n) for n in sizes]
    shard_map(lambda t: c.bucketed_psum(t, "data", bucket_bytes=1000), mesh=mesh,
              in_specs=P("data"), out_specs=P())(leaves)
    out["grouped"] = c.COLLECTIVES.total
    return out


def linreg(x: Any, y: Any, steps: int) -> dict:
    """The reference's compile_step linear regression over data=-1."""
    import torch

    from unionml_tpu_torch.parallel import ShardingConfig, compile_step

    def step(state, batch):
        xb, yb = batch
        w = state["w"].detach().requires_grad_(True)
        b = state["b"].detach().requires_grad_(True)
        loss = ((xb @ w + b - yb) ** 2).mean()
        # a user step differentiating by hand: its grads come back as
        # partial sums over data, which DTensor's arithmetic resolves
        gw, gb = torch.autograd.grad(loss, [w, b])
        with torch.no_grad():
            return {"w": state["w"] - 0.1 * gw, "b": state["b"] - 0.1 * gb}, {"loss": loss}

    cfg = ShardingConfig(data=-1)
    compiled, state = compile_step(step, {"w": torch.zeros(4), "b": torch.zeros(())},
                                   sharding=cfg, donate_state=False)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for _ in range(steps):
        state, metrics = compiled(state, batch)
    return {"w": state["w"].full_tensor().numpy(), "b": float(state["b"].full_tensor()),
            "loss": float(metrics["loss"]), "placement": str(tuple(state["w"].placements))}


def fsdp_state() -> dict:
    """compile_step over data 2 x fsdp 2: the param is sharded over fsdp
    before and after a step, and donation updates it in place."""
    import torch

    from unionml_tpu_torch.parallel import ShardingConfig, compile_step

    def step(state, batch):
        return {"w": state["w"] + batch.mean()}, {}

    cfg = ShardingConfig(data=2, fsdp=2)
    compiled, placed = compile_step(step, {"w": torch.ones(8, 4)}, sharding=cfg)
    before = placed["w"].to_local()
    out, _ = compiled(placed, torch.ones(8, 1))
    return {"placed": str(tuple(placed["w"].placements)),
            "out": str(tuple(out["w"].placements)),
            "local": tuple(out["w"].to_local().shape),
            "in_place": out["w"].to_local().data_ptr() == before.data_ptr(),
            "value": out["w"].full_tensor().numpy()}


def placed_cost() -> dict:
    """One product with a column-sharded weight over ``data=4`` under the
    program tracker's counter: its FLOPs and bytes on this rank."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from unionml_tpu_torch.introspection import CostCounter
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": -1})
    x = distribute_tensor(torch.ones(2, 8), mesh, [Replicate()])
    w = distribute_tensor(torch.ones(8, 16), mesh, [Shard(1)])
    with CostCounter() as counter:
        y = x @ w
    return {"cost": counter.cost, "local": tuple(y.to_local().shape)}


def refusals() -> dict:
    """The kernel wrappers refuse DTensors; names of the errors."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from unionml_tpu_torch.ops.flash_attention import flash_attention
    from unionml_tpu_torch.ops.fused_attention import fused_attention
    from unionml_tpu_torch.ops.fused_norm import fused_layer_norm
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.parallel.mesh import multihost_initialize

    mesh = make_mesh({"data": -1})
    x = distribute_tensor(torch.ones(4, 8, 2, 8), mesh, [Replicate()])
    out = {}
    for name, call in (("fused_layer_norm", lambda: fused_layer_norm(x, x[0, 0, 0], None)),
                       ("fused_attention", lambda: fused_attention(x, x, x)),
                       ("flash_attention", lambda: flash_attention(x, x, x))):
        try:
            call()
            out[name] = None
        except TypeError as exc:
            out[name] = str(exc)
    out["initialize_again"] = multihost_initialize("127.0.0.1:1", 4, 0, device="cpu")
    return out



def _mlp_state(cfg: dict, jax_params: Any, lr: float):
    from unionml_tpu_torch.models import convert
    from unionml_tpu_torch.models.mlp import Mlp, MlpConfig
    from unionml_tpu_torch.models.train import TrainState, adamw

    config = MlpConfig(**cfg)
    module = Mlp(config)
    params = convert.mlp_from_jax_params(jax_params, config, device="cpu")
    return module, TrainState.create(apply_fn=module, params=params, tx=adamw(lr))


def trainer_run(cfg: dict, jax_params: Any, x: Any, y: Any, *, sharding: Any = None,
                accumulate_steps: int = 1, batch_size: int = 32, num_epochs: int = 2,
                seed: int = 9, overlap_grads: bool = False, double_buffer: bool = False,
                lr: float = 1e-2, goodput: bool = False, skew_every: int = 50) -> dict:
    """run_step_trainer over the port's Mlp (bridged reference params)."""
    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.execution import run_step_trainer
    from unionml_tpu_torch.goodput import GoodputTracker
    from unionml_tpu_torch.models.train import classification_step
    from unionml_tpu_torch.parallel import ShardingConfig

    module, state = _mlp_state(cfg, jax_params, lr)
    tracker = GoodputTracker(registry=telemetry.MetricsRegistry()) if goodput else None
    out = run_step_trainer(
        step_fn=classification_step(module, accumulate_steps=accumulate_steps), state=state,
        features=x, targets=y, batch_size=batch_size, num_epochs=num_epochs, seed=seed,
        accumulate_steps=accumulate_steps, overlap_grads=overlap_grads,
        double_buffer=double_buffer, goodput=tracker, skew_every=skew_every,
        sharding=ShardingConfig(**sharding) if sharding is not None else None,
    )
    result = {"params": _numpy_tree(out.params), "step": out.step}
    if tracker is not None:
        snap = tracker.registry.snapshot()
        result["skew"] = {k: v for k, v in snap.items() if "skew" in k or "host_step" in k}
    return result


def overlap_choice() -> dict:
    """resolve_grad_overlap's selection on this group's meshes."""
    from unionml_tpu_torch.execution import resolve_grad_overlap
    from unionml_tpu_torch.parallel import ShardingConfig

    dp = ShardingConfig(data=4)
    mixed = ShardingConfig(data=2, fsdp=2)
    ruled = ShardingConfig(data=4, rules=_rules("VIT_PARTITION_RULES"))
    return {
        "dp": (resolve_grad_overlap(dp, 4).mode, resolve_grad_overlap(dp, 4).axes),
        "mixed": resolve_grad_overlap(mixed, 4).mode,
        "ruled": resolve_grad_overlap(ruled, 4).mode,
        "none": resolve_grad_overlap(None, 4).mode,
        "single": resolve_grad_overlap(dp, 1),
    }


def app_train(sharding: Any, num_epochs: int, batch_size: int, n: int) -> dict:
    """The reference's test_train_step app (blobs, a 2-class MLP) through
    the port's Dataset / Model with ``@model.train_step(sharding=...)``."""
    import numpy as np
    import torch

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.models.mlp import Mlp, MlpConfig
    from unionml_tpu_torch.models.train import TrainState, adamw, classification_step
    from unionml_tpu_torch.parallel import ShardingConfig

    dataset = Dataset(name="blobs", test_size=0.25, shuffle=True, random_state=7)

    @dataset.reader
    def reader(n: int = 256) -> dict:
        rng = np.random.default_rng(0)
        half = n // 2
        x = np.concatenate([rng.normal(loc=-2.0, size=(half, 4)),
                            rng.normal(loc=2.0, size=(n - half, 4))]).astype(np.float32)
        y = np.concatenate([np.zeros(half), np.ones(n - half)]).astype(np.int64)
        order = rng.permutation(n)
        return {"features": x[order], "targets": y[order]}

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int):
        k = int(len(data["features"]) * (1 - test_size))
        return ({"features": data["features"][:k], "targets": data["targets"][:k]},
                {"features": data["features"][k:], "targets": data["targets"][k:]})

    @dataset.parser
    def parser(data: dict, features, targets):
        return (data["features"], data["targets"])

    config = MlpConfig(num_classes=2, hidden_dims=(16,), dtype="float32")
    module = Mlp(config)

    def init_state(learning_rate: float = 0.05) -> TrainState:
        params = module.init(torch.Generator().manual_seed(0), torch.zeros(1, 4))
        return TrainState.create(apply_fn=module, params=params, tx=adamw(learning_rate))

    model = Model(name="mlp", init=init_state, dataset=dataset)
    model.train_step(classification_step(module),
                     sharding=ShardingConfig(**sharding) if sharding is not None else None)

    @model.evaluator
    def evaluator(state: TrainState, features: np.ndarray, targets: np.ndarray) -> float:
        # the trained state arrives gathered to whole tensors
        with torch.no_grad():
            logits = module(state.params, torch.from_numpy(features))
        return float((logits.argmax(-1).numpy() == targets).mean())

    state, metrics = model.train(hyperparameters={"learning_rate": 0.05},
                                 trainer_kwargs={"num_epochs": num_epochs,
                                                 "batch_size": batch_size}, n=n)
    return {"metrics": metrics, "params": _numpy_tree(state.params)}



def feed_cases() -> dict:
    """The sharded feed on data 2 x fsdp 2: each rank's rows, the global
    values the feed assembles, the placements."""
    import numpy as np

    from unionml_tpu_torch.data.pipeline import (
        DeviceFeed, local_batches, prefetch_to_device, process_batch_slice)
    from unionml_tpu_torch.parallel import ShardingConfig, named_sharding

    cfg = ShardingConfig(data=2, fsdp=2)
    out: dict = {"slice16": process_batch_slice(cfg, 16),
                 "slice_replicated": process_batch_slice(named_sharding(cfg.mesh()), 8)}
    try:
        process_batch_slice(cfg, 2)
        out["starved"] = None
    except ValueError as exc:
        out["starved"] = str(exc)
    batches = [(np.full((8, 4), i, np.float32), np.full((8,), i, np.float32)) for i in range(5)]

    def run(double_buffer):
        fed = prefetch_to_device(local_batches(iter(batches), cfg, 8), sharding=cfg,
                                 double_buffer=double_buffer)
        return [(x.full_tensor().numpy(), y.full_tensor().numpy(), str(tuple(x.placements)),
                 tuple(x.to_local().shape)) for x, y in fed]

    out["inline"] = run(False)
    out["threaded"] = run(True)
    g = np.arange(16, dtype=np.float32) * (1 + np.arange(16) % 3)
    out["local_rows"] = next(local_batches(iter([(g, g * 2)]), cfg, 16))
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    via_local = DeviceFeed(sharding=cfg).put(next(local_batches(iter([x]), cfg, 16)))
    out["roundtrip"] = via_local.full_tensor().numpy()
    placed = DeviceFeed(sharding=cfg).put(
        {"x": np.ones((2, 3), np.float32), "y": np.zeros((2,), np.int32)})
    out["pytree"] = {k: (str(tuple(v.placements)), tuple(v.shape), str(v.dtype))
                     for k, v in placed.items()}
    micro = cfg.microbatched()
    fed = next(prefetch_to_device(local_batches(iter([np.zeros((4, 8, 3), np.float32)]),
                                                micro, 8), sharding=micro))
    out["micro"] = (str(tuple(fed.placements)), tuple(fed.shape), tuple(fed.to_local().shape))
    return out


def _ckpt_state(seed: int = 0):
    import torch

    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree

    g = torch.Generator().manual_seed(seed)
    tree = {"step": 7, "w": torch.randn(8, 6, generator=g), "b": torch.randn(6, generator=g),
            "e": torch.randn(4, 4, generator=g).to(torch.bfloat16)}
    cfg = ShardingConfig(data=2, fsdp=2)
    return tree, shard_pytree(tree, cfg)


def ckpt_cases(root: str) -> dict:
    """Sharded save / restore: the round trip bit for bit, re-placement
    onto other placements and onto a plain tree, the manager's async
    save, rotation, latest_step and torn dirs, and its metrics."""
    import os

    import torch
    import torch.distributed as dist

    from unionml_tpu_torch import telemetry
    from unionml_tpu_torch.checkpoint import make_checkpoint_manager
    from unionml_tpu_torch.checkpoint.sharded import (
        CheckpointManager, restore_sharded, save_sharded)
    from unionml_tpu_torch.parallel import ShardingConfig, shard_pytree

    tree, placed = _ckpt_state()
    out: dict = {}
    save_sharded(os.path.join(root, "one"), placed, step=3)
    back = restore_sharded(os.path.join(root, "one"), placed, step=3)
    out["same_bits"] = all(torch.equal(back[k].full_tensor(), tree[k]) for k in ("w", "b", "e"))
    out["same_placements"] = all(back[k].placements == placed[k].placements for k in ("w", "b"))
    other = shard_pytree(tree, ShardingConfig(data=1, fsdp=4))
    moved = restore_sharded(os.path.join(root, "one"), other, step=3)
    out["replaced"] = (str(tuple(moved["w"].placements)),
                       all(torch.equal(moved[k].full_tensor(), tree[k]) for k in ("w", "b", "e")))
    plain = restore_sharded(os.path.join(root, "one"), {k: (v.clone() if isinstance(v, torch.Tensor) else 0)
                                                       for k, v in tree.items()}, step=3)
    out["plain"] = plain["step"] == 7 and all(torch.equal(plain[k], tree[k]) for k in ("w", "e"))
    reg = telemetry.MetricsRegistry()
    saved = {}
    with CheckpointManager(os.path.join(root, "m"), max_to_keep=2, registry=reg) as m:
        for step in (1, 2, 3):
            placed["w"].to_local().add_(1.0)
            saved[step] = placed["w"].full_tensor()
            m.save(step, placed)
        m.wait()
        out["steps"] = sorted(p for p in os.listdir(os.path.join(root, "m")))
        out["latest"] = m.latest_step()
        got = m.restore(placed)
        out["latest_bits"] = torch.equal(got["w"].full_tensor(), saved[3])
        older = m.restore(placed, step=2)
        out["older_bits"] = torch.equal(older["w"].full_tensor(), saved[2])
    if dist.get_rank() == 0:
        torn = os.path.join(root, "m", "step_9.tmp-sharded")
        os.makedirs(torn)
        open(os.path.join(torn, "shard_0.pt"), "wb").close()
    dist.barrier()
    again = make_checkpoint_manager(os.path.join(root, "m"))
    out["auto_kind"] = type(again).__module__
    out["latest_after_torn"] = again.latest_step()
    again.close()
    snap = reg.snapshot()
    out["metrics"] = {k: snap[k] for k in snap if k.startswith("unionml_checkpoint_")}
    return out


def elastic_resume(root: str, cfg: dict, jax_params: Any, x: Any, y: Any, *,
                   kill_after: int = 0, overlap_grads: bool = False,
                   accumulate_steps: int = 1) -> dict:
    """run_elastic_trainer under sharding (data 2 x fsdp 2) on the Mlp,
    checkpointing every 2 steps; ``kill_after`` > 0 raises a preemption
    after that step, and the run is relaunched from the checkpoints."""
    from unionml_tpu_torch.elastic import Preemption, run_elastic_trainer
    from unionml_tpu_torch.models.train import classification_step
    from unionml_tpu_torch.parallel import ShardingConfig

    def run(hook):
        module, state = _mlp_state(cfg, jax_params, 1e-2)
        return run_elastic_trainer(
            step_fn=classification_step(module, accumulate_steps=accumulate_steps),
            state=state, arrays=[x, y], checkpoint_dir=root, batch_size=16, num_epochs=2,
            seed=3, checkpoint_every=2, sharding=ShardingConfig(data=2, fsdp=2),
            accumulate_steps=accumulate_steps, overlap_grads=overlap_grads, fault_hook=hook)

    killed = False
    if kill_after:
        def hook(step):
            if step == kill_after:
                raise Preemption(f"killed after step {step}")
        try:
            run(hook)
        except Preemption:
            killed = True
    state, step = run(None)
    import os

    return {"params": _numpy_tree(state.params), "step": step, "killed": killed,
            "dirs": sorted(os.listdir(root)),
            "placement": str(tuple(state.params["dense_0"]["kernel"].placements))}


def skew_sample(step_s: float) -> Any:
    """allgather_step_times of ``step_s * (rank + 1)`` in each rank."""
    import torch.distributed as dist

    from unionml_tpu_torch.goodput import allgather_step_times

    return allgather_step_times(step_s * (dist.get_rank() + 1))


def sanitizers(llama_cfg: dict, jax_params: Any, plant: tuple) -> dict:
    """The diagnostics' sanitizers on placed trees: describe / assert
    sharding on a batch placed by ``P("data", None)`` over ``data=4`` (the
    reference's test) and on the tiny Llama placed by
    ``LLAMA_PARTITION_RULES`` over ``data=2, tensor=2``; ``assert_finite``
    on that placed tree with a NaN at ``plant`` (a key path); the NaN
    guard on a DTensor op whose NaN lies in rank 2's shard only. Errors
    come back as their messages."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from unionml_tpu_torch.diagnostics import (
        assert_finite,
        assert_sharding,
        describe_sharding,
        nan_guard,
        realized_spec,
    )
    from unionml_tpu_torch.models import LLAMA_PARTITION_RULES, LlamaConfig, from_jax_params
    from unionml_tpu_torch.parallel import ShardingConfig, make_mesh, shard_pytree
    from unionml_tpu_torch.parallel.sharding import NamedSharding, P, _place

    def error(call) -> Any:
        try:
            call()
        except (AssertionError, FloatingPointError) as exc:
            return f"{type(exc).__name__}: {exc}"
        return None

    out: dict = {}
    mesh = make_mesh({"data": 4})
    x = _place(torch.ones(16, 4), NamedSharding(mesh, P("data", None)))
    tree = {"batch": x, "host": np.ones(3)}
    out["describe"] = describe_sharding(tree)
    out["asserts"] = {
        name: error(lambda want=want: assert_sharding(tree, want))
        for name, want in (("placed", {"batch": P("data", None)}),
                           ("short", {"batch": P("data")}),
                           ("other", {"batch": P(None, "data")}),
                           ("callable", {"batch": lambda spec: spec[0] == "data"}),
                           ("missing", {"nonexistent": P()}))}
    # placed some other way: the spec its placements give
    out["distributed"] = tuple(realized_spec(distribute_tensor(torch.ones(8, 4), mesh,
                                                               [Shard(1)])))

    cfg = LlamaConfig(**llama_cfg)
    params = from_jax_params(jax_params, cfg, device="cpu")
    config = ShardingConfig(data=2, tensor=2, rules=LLAMA_PARTITION_RULES)
    placed = shard_pytree(params, config)
    out["llama_specs"] = {path: tuple(realized_spec(leaf)) for path, leaf in
                          _diag_paths(placed)}
    out["llama_asserts"] = {
        "kernels": error(lambda: assert_sharding(placed, {
            "['attn']['q']['kernel']": P(None, "tensor", None),
            "['attn']['o']['kernel']": P("tensor", None, None)})),
        "wrong": error(lambda: assert_sharding(placed, {"['attn']['q']['kernel']":
                                                        P("tensor", None)}))}
    bad = params
    node = bad
    for key in plant[:-1]:
        node = node[key]
    node[plant[-1]] = node[plant[-1]].clone()
    node[plant[-1]].view(-1)[1] = float("nan")
    out["finite"] = error(lambda: assert_finite(shard_pytree(bad, config), name="params"))
    out["finite_clean"] = error(lambda: assert_finite(placed, name="params"))

    # the guard checks a DTensor op by this rank's shard: rank 2's holds an inf
    rows = torch.ones(8, 4)
    rows[4, 1] = float("inf")
    spread = distribute_tensor(rows, mesh, [Shard(0)])
    with nan_guard():
        out["guard"] = error(lambda: spread * 0.0)
    out["rank"] = dist.get_rank()
    return out


def _diag_paths(tree: Any):
    from unionml_tpu_torch.diagnostics import _leaf_paths

    return list(_leaf_paths(tree))


if __name__ == "__main__":
    import logging
    import warnings

    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    sys.path.insert(0, REPO)
    sys.modules.setdefault("torch_ranks", sys.modules[__name__])
    h, p, k, r, w, s = sys.argv[1:7]
    _serve(h, int(p), bytes.fromhex(k), int(r), int(w), int(s))
    sys.exit(0)
