"""Single-file state artifacts, and the tree conversions checkpoints share.

The port of :mod:`unionml_tpu.checkpoint.pytree_io`. The reference writes
flax's msgpack wire format behind a JSON header; the port writes its own
format with :func:`torch.save`: a dict holding a format tag, the JSON
header with the hyperparameters and the state's tree of tensors and
numbers, read back with ``weights_only=True`` (no code runs on load). As
in the reference, ``load_pytree`` restores INTO the structure that
``target_factory(hyperparameters)`` rebuilds (typically the app's
``init``), each tensor onto its target leaf's device and dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import IO, Any, Callable, Optional, Union

import torch

from unionml_tpu_torch.checkpoint._metrics import checkpoint_metrics
from unionml_tpu_torch.models.train import TrainState, tree_leaves, tree_unflatten

FORMAT = "unionml_tpu_torch.state/1"


def state_tree(state: Any) -> Any:
    """The tree of tensors and numbers a checkpoint keeps of ``state``: a
    :class:`~unionml_tpu_torch.models.train.TrainState`'s ``state_dict()``
    (its apply function and optimizer are code, not data); any other
    state as it is (nested dicts / lists / tuples)."""
    return state.state_dict() if isinstance(state, TrainState) else state


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def restore_into(target: Any, saved: Any) -> Any:
    """``target`` (a state or tree) holding ``saved``'s values (a tree of
    :func:`state_tree`'s shape): each tensor goes onto its target leaf's
    device and dtype, so a CUDA state is never restored silently to the
    CPU. Raises ``ValueError`` when the structures differ."""
    like = state_tree(target)
    if _skeleton(like) != _skeleton(saved):
        raise ValueError("the checkpoint's tree does not have the target state's structure")
    mine, theirs = tree_leaves(like), tree_leaves(saved)
    out = []
    for m, t in zip(mine, theirs):
        if isinstance(m, torch.Tensor):
            if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(m.shape):
                raise ValueError(
                    f"checkpoint leaf {getattr(t, 'shape', type(t).__name__)} does not fit "
                    f"the target's {tuple(m.shape)}"
                )
            t = t.to(device=m.device, dtype=m.dtype)
        out.append(t)
    tree = tree_unflatten(like, out)
    if isinstance(target, TrainState):
        # every tree of the state's state_dict(): params and opt_state, and
        # a LoRA state's frozen_params
        return dataclasses.replace(target, step=int(tree["step"]),
                                   **{key: val for key, val in tree.items() if key != "step"})
    return tree


def _open(file: Union[str, os.PathLike, IO], mode: str):
    if hasattr(file, "write") or hasattr(file, "read"):
        return file, False
    return open(file, mode), True


def save_pytree(pytree: Any, hyperparameters: Optional[dict],
                file: Union[str, os.PathLike, IO]) -> None:
    """Write ``pytree`` (a state or tree) and ``hyperparameters`` (plain
    JSON data) to ``file``."""
    t0 = time.perf_counter()
    f, should_close = _open(file, "wb")
    try:
        start = f.tell() if f.seekable() else 0
        torch.save({"format": FORMAT,
                    "header": json.dumps({"hyperparameters": hyperparameters}),
                    "tree": state_tree(pytree)}, f)
        written = f.tell() - start if f.seekable() else 0
    finally:
        if should_close:
            f.close()
    metrics = checkpoint_metrics()
    metrics["save_ms"].labels("pytree").observe((time.perf_counter() - t0) * 1e3)
    metrics["save_bytes"].labels("pytree").inc(written)


def load_pytree(file: Union[str, os.PathLike, IO],
                target_factory: Callable[[Optional[dict]], Any]) -> Any:
    """Load an artifact written by :func:`save_pytree`;
    ``target_factory(hyperparameters)`` rebuilds the target structure."""
    t0 = time.perf_counter()
    f, should_close = _open(file, "rb")
    try:
        start = f.tell() if f.seekable() else 0
        try:
            payload = torch.load(f, map_location="cpu", weights_only=True)
        except (RuntimeError, EOFError, pickle.UnpicklingError) as exc:
            raise ValueError(f"not a unionml_tpu_torch state artifact ({exc})") from exc
        read = f.tell() - start if f.seekable() else 0
    finally:
        if should_close:
            f.close()
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(
            "not a unionml_tpu_torch state artifact; use a custom @model.loader for "
            "other artifacts"
        )
    header = json.loads(payload["header"])
    out = restore_into(target_factory(header.get("hyperparameters")), payload["tree"])
    metrics = checkpoint_metrics()
    metrics["restore_ms"].labels("pytree").observe((time.perf_counter() - t0) * 1e3)
    metrics["restore_bytes"].labels("pytree").inc(read)
    return out
