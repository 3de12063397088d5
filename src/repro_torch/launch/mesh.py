"""Mesh builders over the ranks of the initialized process group (the JAX
package's `launch/mesh.py`). Functions, so importing this module touches
no process group.

`make_production_mesh` lays the world's ranks out as a (world / n_model,
n_model) ("data", "model") mesh, with a leading ("pod", ...) axis of 2
for multi-pod; `make_small_context` is the reduced (n_data, n_model) mesh
the tests use. The JAX file's TPU constants (a v5e chip's peaks, the
16 x 16 pod) are not carried over: the card's roofline numbers come with
the dry-run (ROADMAP A16).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.context import MeshContext


def _mesh(shape: tuple, names: tuple, device_type: Optional[str]):
    """A DeviceMesh of `shape` over the world's ranks, on `device_type`
    (default "cuda" where a card is visible, else "cpu"). It keeps the
    default group's backend: a gloo default group gives a cuda mesh gloo
    groups."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if torch.Size(shape).numel() != world:
        raise ValueError(f"a {shape} mesh needs {torch.Size(shape).numel()} "
                         f"ranks, the world has {world}")
    device_type = device_type or (
        "cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, n_model: int = 1,
                         device_type: Optional[str] = None):
    world = dist.get_world_size() if dist.is_initialized() else 0
    pods = 2 if multi_pod else 1
    if world == 0 or world % (pods * n_model):
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"{pods} pod(s) x data x {n_model} model")
    n_data = world // (pods * n_model)
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_context(*, multi_pod: bool = False, fsdp: bool = True,
                 n_model: int = 1,
                 device_type: Optional[str] = None) -> MeshContext:
    mesh = make_production_mesh(multi_pod=multi_pod, n_model=n_model,
                                device_type=device_type)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshContext(mesh=mesh, data_axes=data_axes, model_axis="model",
                       fsdp=fsdp)


def make_small_context(n_data: int = 4, n_model: int = 2,
                       device_type: Optional[str] = None) -> MeshContext:
    """An (n_data, n_model) mesh over a world of n_data x n_model ranks."""
    mesh = _mesh((n_data, n_model), ("data", "model"), device_type)
    return MeshContext(mesh=mesh, data_axes=("data",), model_axis="model")


def model_context(device_type: Optional[str] = None) -> MeshContext:
    """The one-axis ("model",) mesh over the whole world, no data axis:
    expert parallelism alone (`models.moe`)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    mesh = _mesh((world,), ("model",), device_type)
    return MeshContext(mesh=mesh, data_axes=(), model_axis="model")


def data_context(device_type: Optional[str] = None) -> MeshContext:
    """The one-axis ("data",) mesh over the whole world: the mesh engine's
    default (model_axis is "data", as the JAX engine's default has it)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    mesh = _mesh((world,), ("data",), device_type)
    return MeshContext(mesh=mesh, data_axes=("data",), model_axis="data")
