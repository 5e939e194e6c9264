"""Mesh construction on ``torch.distributed``: the port of
``src/repro/launch/mesh.py``.

The port is multi-controller: one process per card, started by
``torchrun``, each holding its shard of every DTensor.  A mesh is a
``DeviceMesh`` from ``init_device_mesh`` over the default process group,
which is NCCL for ``cuda`` and gloo for ``cpu``.  The group is started on
first use: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) when it is set, else as a group of one
rank on a free local port.  Importing this module starts nothing.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --mesh 2,2                                   # 4 gloo ranks, host
  python -m repro_torch.launch.train --no-smoke --mesh 1,1   # one card
"""

from __future__ import annotations

import os
import socket

import torch

__all__ = ["describe", "device_for", "init_process_group", "make_cli_mesh",
           "make_debug_mesh", "make_mesh", "make_production_mesh", "setup",
           "shutdown", "world_size"]


def world_size() -> int:
    """Ranks of the running group, else of ``torchrun``'s environment
    (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device_type: str = "cuda") -> str:
    """Start the default process group if none runs (NCCL for ``cuda``,
    gloo otherwise) and return its backend.  On ``cuda`` each rank takes
    the card ``LOCAL_RANK``."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device and none is "
                               "available; pass --device cpu")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0)
    return backend


def shutdown() -> None:
    """Destroy the default process group, if one runs."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def device_for(device_type: str) -> torch.device:
    """This rank's device of a mesh on ``device_type``."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device_type)


def make_mesh(shape, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the default
    group (started here if need be); its size must be the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if n != world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the world has {world_size()}")
    init_process_group(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ("data", "model") on 256 ranks, or 2x16x16 ("pod", "data",
    "model") on 512; any other world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A small ("data", "model") mesh for tests (gloo on the host)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def make_cli_mesh(spec: str | None = None, device_type: str = "cuda"):
    """Mesh from a "data,model" CLI spec; default is every rank
    data-parallel, (world, 1).  Shared by the train and serve launchers so
    both agree on axis names.  A spec whose product is not the world size
    raises."""
    if spec:
        try:
            d, m = (int(x) for x in spec.split(","))
        except ValueError:
            raise SystemExit(
                f"--mesh expects 'data,model' (e.g. '4,2'), got {spec!r}")
    else:
        d, m = world_size(), 1
    return make_mesh((d, m), ("data", "model"), device_type)


def setup(spec, device):
    """(mesh, this rank's device, rank) of a launcher's ``--mesh spec`` on
    ``device``'s type; (None, device, 0) without a spec and without a
    ``torchrun`` world, and then no process group starts."""
    if not spec and world_size() == 1:
        return None, device, 0
    import torch.distributed as dist

    mesh = make_cli_mesh(spec, device.type)
    return mesh, device_for(device.type), dist.get_rank()


def describe(mesh) -> str:
    """One line naming a mesh's axes, sizes and process-group backend."""
    import torch.distributed as dist

    axes = ", ".join(f"{n}={s}" for n, s in
                     zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return (f"mesh ({axes}) on {mesh.device_type}, backend "
            f"{dist.get_backend()}, {dist.get_world_size()} ranks")
