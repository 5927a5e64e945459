"""Multi-process initialization helpers.

Port of ``periodicity_tpu/parallel/distributed.py``: one
``torch.distributed.init_process_group`` wrapper with torchrun's
environment as its defaults, plus a mesh constructor that lays a named axis
hierarchy over [hosts, devices per host] so collectives ride the right
links.

Design notes (as in the JAX package):

- Axes that exchange LARGE tensors every step (the ``seq`` axis of the
  sharded GP likelihood, the ``grid`` axis of a sharded periodogram)
  belong on the in-host (minor) mesh dimension, over NVLink.
- Axes with rare or small exchanges (independent light curves on
  ``batch``, MCMC walker blocks) tolerate the network between hosts: put
  them on the host (major) dimension.
- A single process (nothing configured) is a silent no-op: every helper
  degrades to the local behaviour, keeping the zero-config default.

JAX warns when ``initialize`` comes after its backend started; a torch
process group can start at any time, so that warning has no counterpart.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "multihost_mesh"]


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           local_device_ids=None, device=None):
    """Start the default process group from arguments or torchrun's
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prepended),
    ``num_processes`` the world size, ``process_id`` the rank;
    ``local_device_ids[0]`` (or torchrun's ``LOCAL_RANK``) picks this
    process's card. The backend is nccl unless ``device="cpu"`` (gloo).

    No-op (returns False) when nothing names a multi-process run, so
    library code can call it unconditionally. Returns True when the group
    was (or already is) initialized.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = os.environ["MASTER_ADDR"]
        if "MASTER_PORT" in os.environ:
            coordinator_address += f":{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return False  # single process: stay zero-config
    cpu = device is not None and torch.device(device).type == "cpu"
    if local_device_ids is None and "LOCAL_RANK" in os.environ:
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if local_device_ids is not None and not cpu:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    address = str(coordinator_address)
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group("gloo" if cpu else "nccl", init_method=address,
                            world_size=int(num_processes), rank=int(process_id))
    return True


def multihost_mesh(ici_axes=("grid",), dcn_axes=("batch",), ici_shape=None, dcn_shape=None,
                   device=None):
    """Mesh over ALL ranks with the host axes (``dcn_axes``) major and the
    in-host axes (``ici_axes``) minor, so shardings over the in-host axes
    exchange over the fast links and only the host axes cross hosts.

    Defaults: one host axis of size WORLD_SIZE // LOCAL_WORLD_SIZE (torchrun
    numbers a host's ranks contiguously), in-host axes over the local
    world. With a single process this is ``default_mesh`` plus a leading
    size-1 host axis per ``dcn_axes`` entry.
    """
    from .mesh import _device_type, _ensure_group, _mesh

    device_type = _device_type(device)
    _ensure_group(device_type)
    world = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_hosts = max(1, world // max(n_local, 1))
    if dcn_shape is None:
        dcn_shape = (n_hosts,) + (1,) * (len(dcn_axes) - 1)
    if ici_shape is None:
        ici_shape = (n_local,) + (1,) * (len(ici_axes) - 1)
    shape = tuple(dcn_shape) + tuple(ici_shape)
    return _mesh(device_type, shape, tuple(dcn_axes) + tuple(ici_axes))
