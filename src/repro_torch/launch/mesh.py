"""Device meshes over ``torch.distributed``: the JAX package's
``launch/mesh.py`` under its names, axes and order, ("data", "model") or
("pod", "data", "model").

A mesh spans the ranks of the default process group, which the caller
starts first (``torch.distributed.init_process_group``, with its address,
world size and rank). No builder starts one: without it they raise. The
device type is explicit and defaults to the card; pass ``device_type="cpu"``
for a gloo group on the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str) -> DeviceMesh:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(address, world size, rank) before building a mesh")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device_type='cpu' for a mesh on the host")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh(data: int, model: int, pods: int = 1, *,
              device_type: str = "cuda") -> DeviceMesh:
    """Any mesh for tests and small runs (e.g. (2, 4) on 8 ranks)."""
    if pods > 1:
        return _mesh((pods, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(1, 1, device_type=device_type)
