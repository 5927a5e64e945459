"""Device-mesh helpers.

Port of ``periodicity_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, one
process (rank) a device. With no process group and no multi-process
environment, :func:`default_mesh` starts a world-size-1 group on an
in-memory store, so one process stays zero-config, as one JAX process is.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.containers import _default_device

__all__ = ["default_mesh", "grid_sharding"]


def _device_type(device):
    """The mesh's device type: "cuda" unless ``device`` names the CPU (and
    None raises where there is no card, as the port's inputs do)."""
    return _default_device(device).type


def _ensure_group(device_type):
    """A default process group: the one that exists, the one the
    environment names (``initialize_distributed``), or a world of one on a
    ``HashStore`` (nccl on the card, gloo on the CPU)."""
    if dist.is_initialized():
        return
    from .distributed import initialize_distributed

    if initialize_distributed(device=device_type):
        return
    if device_type == "cuda":
        # select the card before the mesh, as a launcher would
        torch.cuda.set_device(torch.cuda.current_device())
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def _mesh(device_type, shape, names):
    """``init_device_mesh`` over the whole world, ranks row-major."""
    _ensure_group(device_type)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= int(s)
    if size != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {world} devices")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def default_mesh(axis_names=("grid",), shape=None, device=None):
    """A DeviceMesh over every rank of the default process group.

    axis_names: mesh axis names, e.g. ("batch", "grid").
    shape: per-axis sizes; defaults to the whole world on the first axis.
    device: "cpu" for a gloo mesh of CPU ranks; None (the card) for nccl.
    """
    device_type = _device_type(device)
    _ensure_group(device_type)
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return _mesh(device_type, shape, axis_names)


def grid_sharding(mesh, axis="grid", dim=0):
    """DTensor placements that lay tensor dimension ``dim`` over one mesh
    axis: ``Shard(dim)`` on that axis, ``Replicate()`` on the others."""
    return [Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def axis_info(mesh, axis):
    """(size, this rank's index, process group) of one mesh axis: the
    counterpart of JAX's ``mesh.shape[axis]`` and ``lax.axis_index``."""
    names = mesh.mesh_dim_names
    if names is None or axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    dim = names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


def mesh_device(mesh):
    """The torch.device a rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_output(local, mesh, axis, dim=0):
    """The rank's ``local`` block as a DTensor sharded on ``dim`` over
    ``axis`` (replicated over the other axes). No collective runs."""
    shape = list(local.shape)
    shape[dim] *= axis_info(mesh, axis)[0]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, grid_sharding(mesh, axis, dim), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_block(x, mesh, axis, dim=0):
    """This rank's contiguous block along ``dim`` of ``x``: a DTensor's
    local shard as it lies, or the rank's slice of a whole tensor held on
    every rank. The size along ``dim`` must divide by the axis size."""
    if isinstance(x, DTensor):
        return x.to_local()
    d, idx, _ = axis_info(mesh, axis)
    n = x.shape[dim]
    if n % d:
        raise ValueError(f"size {n} of dim {dim} must be divisible by mesh axis size {d}")
    el = n // d
    return x.narrow(dim, idx * el, el)

