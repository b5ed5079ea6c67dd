"""Device meshes and the process group under them.

Single pod: (data=16, model=16) = 256 devices; multi-pod: (pod=2, data=16,
model=16) = 512, the leading ``pod`` axis pure data parallelism (the JAX
package's production meshes).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, whose world size must equal the mesh's product.  Defined as
functions (never module-level constants), so importing this module
touches no process group.

``init_distributed`` starts that group: from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when it is set,
else as a world of one on a free localhost port.  NCCL on a CUDA device,
gloo on the CPU (only when the caller asks for the CPU).

``make_dry_mesh`` is a dry run's world (launch/dryrun.py, the counterpart of
the JAX package's 512 host devices): a mesh of any shape over torch's
``fake`` process-group backend, in which this process is rank 0 and the
collectives move nothing; it refuses to start while a real process group
runs and destroys its group when the cell ends.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import socket
from typing import Iterator, Tuple

import torch
import torch.distributed as dist


TIMEOUT_S = 600.0           # a collective that waits longer raises


def _device_type(device) -> str:
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, device="cuda"):
    """A mesh of ``shape`` named ``axes`` over the started process group
    (e.g. (1, 1) in a world of one)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} processes, "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def mesh_num_devices(mesh) -> int:
    return math.prod(int(s) for s in mesh.mesh.shape)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda") -> Tuple[int, int, torch.device]:
    """Start the default process group unless one is running; returns
    (rank, world size, this rank's device).  Under torchrun each rank
    takes ``cuda:LOCAL_RANK``; without it the process is a world of
    one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        init_method = ("env://" if "MASTER_ADDR" in os.environ
                       else f"tcp://localhost:{_free_port()}")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dist.get_rank(), dist.get_world_size(), dev


@contextlib.contextmanager
def make_dry_mesh(shape, axes) -> Iterator:
    """A mesh of ``shape`` named ``axes`` over the ``fake`` backend: a
    world of prod(shape) ranks of which this process is rank 0, whose
    collectives complete without moving data (a dry run traces on the
    meta device).  Refuses to start while a process group runs; the group
    is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.core import collectives
    if dist.is_initialized():
        raise RuntimeError("make_dry_mesh: a process group is running; a dry "
                           "run starts its own fake world")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        collectives.forget_groups()
        dist.destroy_process_group()


def make_dry_production_mesh(*, multi_pod: bool = False):
    """``make_dry_mesh`` of the production shape: (data 16, model 16), or
    (pod 2, data 16, model 16)."""
    if multi_pod:
        return make_dry_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_dry_mesh((16, 16), ("data", "model"))
