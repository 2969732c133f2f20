"""Device-mesh construction and multi-process bring-up.

The port of :mod:`unionml_tpu.parallel.mesh` on ``torch.distributed``: a
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, its dimensions named after the
parallelism strategies (``mesh_dim_names`` in the reference's axis
order), one rank per device. The rank layout is the reference's: axes
reshape the rank list in order, and ``dcn_axes`` (axes that span hosts)
are the outer, host-major factor of their axis, as
``mesh_utils.create_hybrid_device_mesh`` lays slices out.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from unionml_tpu_torch._device import DeviceLike, resolve_device

__all__ = [
    "cpu_multiprocess_supported",
    "make_mesh",
    "mesh_array",
    "mesh_devices",
    "mesh_shape",
    "multihost_initialize",
]

#: The process-group timeout :func:`multihost_initialize` sets: a hung
#: collective raises after it instead of blocking its rank forever.
DEFAULT_TIMEOUT_S = 600.0


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def mesh_devices(n: Optional[int] = None) -> List[int]:
    """The devices to build a mesh over: the global ranks of the default
    process group (one device each; ``[0]`` without a group), all of them
    by default or the first ``n``."""
    devices = list(range(_world_size()))
    if n is not None:
        if n > len(devices):
            raise ValueError(
                f"requested {n} devices but only {len(devices)} are visible. "
                "Start one rank per device (torchrun, or multihost_initialize "
                "in each process)."
            )
        devices = devices[:n]
    return devices


def _resolve_axes(axes: Dict[str, int], n: int) -> Dict[str, int]:
    axes = dict(axes)
    inferred = [k for k, v in axes.items() if v == -1]
    if len(inferred) > 1:
        raise ValueError(f"only one mesh axis may be -1, got {inferred}")
    known = int(np.prod([v for v in axes.values() if v != -1])) if axes else 1
    if inferred:
        if n % known:
            raise ValueError(f"device count {n} not divisible by fixed axes product {known}")
        axes[inferred[0]] = n // known
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"mesh axes {axes} require {total} devices but {n} are available")
    return axes


def mesh_array(
    axes: Dict[str, int],
    *,
    devices: Optional[Sequence[int]] = None,
    dcn_axes: Optional[Dict[str, int]] = None,
):
    """``(resolved axes, rank array)`` of the mesh :func:`make_mesh`
    builds, without a process group: at most one axis may be ``-1``
    (inferred from the device count), and the sizes must multiply to it.
    With ``dcn_axes`` each named axis splits into ``slices`` host-major
    outer blocks times its within-host size, so the ranks of one host
    (consecutive ranks) stay together on every other axis."""
    devices = list(devices) if devices is not None else mesh_devices()
    axes = _resolve_axes(axes, len(devices))
    names = tuple(axes)
    if dcn_axes:
        # validated up front so a misconfiguration fails the same way on
        # one host and on many
        for k, slices in dcn_axes.items():
            if k not in axes:
                raise ValueError(f"dcn_axes key {k!r} is not a mesh axis {names}")
            if slices <= 0 or axes[k] % slices:
                raise ValueError(f"dcn_axes[{k!r}]={slices} must divide axis size {axes[k]}")
        dcn = [dcn_axes.get(k, 1) for k in names]
        ici = [axes[k] // d for k, d in zip(names, dcn)]
        arr = np.asarray(devices).reshape(tuple(dcn) + tuple(ici))
        # interleave to (dcn_0, ici_0, dcn_1, ici_1, ...): each axis index
        # is dcn-major, so its outer factor steps across hosts
        order = [i for pair in zip(range(len(names)), range(len(names), 2 * len(names)))
                 for i in pair]
        arr = arr.transpose(order).reshape(tuple(axes.values()))
    else:
        arr = np.asarray(devices).reshape(tuple(axes.values()))
    return axes, arr


def _device_type() -> str:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group: call "
            "multihost_initialize(...) (or torch.distributed.init_process_group) "
            "in every rank first"
        )
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(
    axes: Dict[str, int],
    *,
    devices: Optional[Sequence[int]] = None,
    dcn_axes: Optional[Dict[str, int]] = None,
):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` with named
    ``axes`` over the ranks of the default process group (see
    :func:`mesh_array` for the sizes and the layout). The device type
    follows the group's backend: ``cuda`` under NCCL, ``cpu`` under gloo.
    Collectives over one mesh dimension run on that dimension's process
    group (``mesh.get_group(name)``)."""
    from torch.distributed.device_mesh import DeviceMesh

    resolved, arr = mesh_array(axes, devices=devices, dcn_axes=dcn_axes)
    import torch

    return DeviceMesh(_device_type(), torch.as_tensor(arr, dtype=torch.int64),
                      mesh_dim_names=tuple(resolved))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, as ``jax`` ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def cpu_multiprocess_supported() -> bool:
    """Can this torch build run multi-process collectives on the CPU? True
    when the gloo backend is available (what :func:`multihost_initialize`
    selects for ``device="cpu"``)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_gloo_available()


def multihost_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> bool:
    """Bring up the default process group: NCCL when ``device`` is CUDA
    (``None`` means CUDA, raising without a card), gloo when it is the
    CPU. The backend follows the explicit device, never what the machine
    happens to have.

    Arguments left ``None`` come from torchrun's environment
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With
    neither, this is a single-process run and it returns False, as it
    does when a group is already initialized; True once it has started
    one. ``coordinator_address`` is ``host:port`` of rank 0's TCP store.
    Under NCCL each rank takes ``cuda:LOCAL_RANK`` (default: its rank
    modulo the visible cards) as its current device."""
    import torch
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "multihost_initialize needs num_processes and process_id (or torchrun's "
            "WORLD_SIZE and RANK) beside the coordinator address"
        )
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S), **kwargs,
    )
    return True
