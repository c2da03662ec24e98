"""Mesh helpers: process groups, device meshes and the two collectives of
the sharded Monte Carlo path.

Counterpart of ``pyphysim_tpu/parallel/mesh.py``. JAX runs one process over
many devices and shards with ``Mesh`` / ``shard_map``; PyTorch runs one
process per device, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, each rank computes its contiguous shard (:func:`shard_rows`) and
the shards are all-gathered in rank order (:func:`gather_rows`) where JAX
constrains an output to be replicated.

The backend follows the device, never what happens to be available: a
CUDA mesh runs NCCL and a CPU mesh gloo. Rank ``r`` uses
``cuda:{LOCAL_RANK}``, or ``cuda:{r % device_count}`` without that
variable. When no process group is up, :func:`make_mesh` starts a
world-size-1 group over a ``file://`` store in a temporary directory (no
port, no network): the counterpart of JAX's single-process mesh.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import DeviceLike, require_cuda

__all__ = ["make_mesh", "make_host_chip_mesh", "shard_batch",
           "init_multihost", "shard_rows", "gather_rows",
           "shard_prng_build", "shard_inject_build"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device type "
                         f"{device_type!r}")
    return _BACKENDS[device_type]


def _rank_device(device_type: str) -> torch.device:
    """This rank's device of ``device_type`` (the CUDA index from
    ``LOCAL_RANK``, else the rank modulo the device count)."""
    if device_type != "cuda":
        return torch.device(device_type)
    require_cuda("cuda")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _ensure_group(device: DeviceLike) -> str:
    """The device type of ``device``, with a process group up whose
    backend serves it: an existing group is checked, none starts a
    world-size-1 group."""
    device_type = require_cuda(device).type
    backend = _backend(device_type)
    if not dist.is_initialized():
        store_dir = tempfile.mkdtemp(prefix="pyphysim_mesh_")
        atexit.register(shutil.rmtree, store_dir, True)
        if device_type == "cuda":
            # the only interface a machine without a network is sure of
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"file://{store_dir}/store", world_size=1,
            rank=0)
    elif backend not in dist.get_backend():
        raise RuntimeError(
            f"a {device_type} mesh needs the {backend} backend; the process "
            f"group runs {dist.get_backend()!r}")
    if device_type == "cuda":
        torch.cuda.set_device(_rank_device("cuda"))
    return device_type


def make_mesh(devices: Optional[int] = None, axis_name: str = "mc",
              device: DeviceLike = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over every rank of the process
    group, or over its first ``devices`` ranks. Every rank of the group
    must call it (a mesh creates its sub-groups collectively). A count
    larger than the world raises ``ValueError``."""
    device_type = _ensure_group(device)
    world = dist.get_world_size()
    count = world if devices is None else int(devices)
    if not 1 <= count <= world:
        raise ValueError(f"{count} devices asked of a world of {world}")
    return DeviceMesh(device_type, torch.arange(count),
                      mesh_dim_names=(axis_name,))


def make_host_chip_mesh(num_hosts: Optional[int] = None,
                        axis_names: Sequence[str] = ("host", "chip"),
                        device: DeviceLike = "cuda") -> DeviceMesh:
    """A 2-D ``(host, chip)`` mesh over every rank: the outer axis crosses
    nodes, the inner one stays within a node. ``num_hosts`` defaults to
    the number of nodes (``WORLD_SIZE // LOCAL_WORLD_SIZE`` as a launcher
    sets them, else 1); on one node it splits the ranks into virtual host
    groups. Ranks that do not split evenly raise ``ValueError``."""
    device_type = _ensure_group(device)
    world = dist.get_world_size()
    if num_hosts is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_hosts = max(world // max(local_world, 1), 1)
    if world % num_hosts != 0:
        raise ValueError(f"{world} ranks do not split into {num_hosts} "
                         "hosts")
    grid = torch.arange(world).reshape(num_hosts, world // num_hosts)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, axis_name: str = "mc"):
    """``x`` (leading axis = repetitions) as a ``DTensor`` sharded over
    ``axis_name`` and replicated over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    placements = [Shard(0) if name == axis_name else Replicate()
                  for name in mesh.mesh_dim_names]
    return distribute_tensor(x.to(_rank_device(mesh.device_type)), mesh,
                             placements)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: DeviceLike = "cuda") -> None:
    """Join a multi-process group: ``tcp://coordinator_address`` when an
    address (``host:port``) is given, else the launcher's ``env://``
    variables. A no-op when a group is already up."""
    if dist.is_initialized():
        return
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group(
        _backend(require_cuda(device).type), init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))


def _coordinate(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis size)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh} has no axis {axis!r}")
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in {mesh}")
    return (mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def shard_rows(mesh: DeviceMesh, axis: str, rows: int) -> Tuple[int, int]:
    """(this rank's index along ``axis``, rows a shard): rank ``i`` owns
    rows ``[i * n_local, (i + 1) * n_local)``. Rows that do not divide
    over the axis raise ``ValueError``."""
    index, size = _coordinate(mesh, axis)
    if rows % size:
        raise ValueError(f"{rows} rows are not divisible by mesh axis "
                         f"{axis!r} of size {size}")
    return index, rows // size


def gather_rows(mesh: DeviceMesh, axis: str,
                local: torch.Tensor) -> torch.Tensor:
    """The shards of every rank along ``axis``, concatenated in rank order
    along dim 0, on every rank: one all-gather over the axis's group.
    ``local`` must lie on the mesh's device type (no copy to another
    device is made for it)."""
    _, size = _coordinate(mesh, axis)
    if local.device.type != mesh.device_type:
        raise ValueError(f"a shard on {local.device} cannot be gathered "
                         f"over a {mesh.device_type} mesh")
    local = local.contiguous()
    wire = local.view(torch.uint8) if local.dtype == torch.bool else local
    out = torch.empty((size * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=mesh.get_group(axis))
    return out.view(torch.bool) if local.dtype == torch.bool else out


def shard_prng_build(build, reps: int, num_tiles: int, mesh, axis: str,
                     start_arg: int):
    """The PRNG-mode ``run`` of a Monte Carlo kernel's ``build`` with its
    rep axis split over ``mesh`` / ``axis``: this rank's ``build(n_local,
    num_tiles)`` called with its ``start`` (positional argument
    ``start_arg``, default 0) advanced by ``index * n_local``, then the
    rows all-gathered in rank order."""
    index, n_local = shard_rows(mesh, axis, reps)
    local = build(n_local, num_tiles)

    def run(*args, **kwargs):
        args = list(args)
        if len(args) > start_arg:
            args[start_arg] = int(args[start_arg]) + index * n_local
        else:
            kwargs["start"] = int(kwargs.get("start", 0)) + index * n_local
        return gather_rows(mesh, axis, local(*args, **kwargs))

    return run


def shard_inject_build(build_inject, reps: int, num_tiles: int, mesh,
                       axis: str, num_bits: int):
    """The inject-mode ``run`` of a Monte Carlo kernel's ``build_inject``
    with its rep axis split over ``mesh`` / ``axis``: this rank's rows of
    the first ``num_bits`` arguments (the bit tensors) through
    ``build_inject(n_local, num_tiles)``, then the rows all-gathered."""
    index, n_local = shard_rows(mesh, axis, reps)
    local = build_inject(n_local, num_tiles)
    rows = slice(index * n_local, (index + 1) * n_local)

    def run(*args, **kwargs):
        bits = [b[rows] for b in args[:num_bits]]
        return gather_rows(mesh, axis,
                           local(*bits, *args[num_bits:], **kwargs))

    return run
