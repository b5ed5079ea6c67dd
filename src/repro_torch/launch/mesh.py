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
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from typing import Tuple

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
