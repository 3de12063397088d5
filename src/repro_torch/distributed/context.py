"""The mesh context (the JAX package's `distributed/context.py`) and the
few collectives the multi-device paths need.

Model and engine code asks "what mesh am I running over?" instead of
threading a mesh through every call. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims; the group of
an axis is `mesh.get_group(name)`, and a tuple of axes gets one group of
its own (`axis_group`). When no context is set, models take their
one-process paths (no collectives).

The port is SPMD over processes: every rank runs the same program, and
every collective below is one call on tensors, entered by every rank of
the group in the same order, its pieces in rank order:

  all_gather       tiled along dim 0 (rank r's block at rows r*m..)
  reduce_scatter   sum, tiled along dim 0 (rank r keeps block r)
  broadcast        from the group rank that owns the tensor
  all_reduce_max   an elementwise MAX of a mask (bool in, bool out)
  all_to_all       tiled along dim 0: block j of every rank to rank j,
                   stacked in rank order

The backend is the caller's (`init_process_group`): gloo or NCCL, CUDA or
CPU tensors. Nothing here switches it or moves a tensor through the host
behind the caller's back; a backend that refuses a tensor raises.
`collective_stats()` counts the calls and bytes of each op
(`reset_collective_stats()` zeroes them). Seconds are counted only inside
`timed_collectives()`, a profiling switch: there each call is timed
between two device synchronisations, which the main path never makes.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshContext:
    mesh: Any          # a torch.distributed.device_mesh.DeviceMesh
    # axis-name conventions (the JAX package's DESIGN.md §4):
    #   batch/tokens/edges/seeds shard over data_axes (("pod","data")
    #   multi-pod); heads/mlp/vocab/experts shard over model_axis
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = True   # ZeRO-3: params themselves sharded over data axes

    @property
    def n_data(self) -> int:
        return math.prod(axis_size(self.mesh, a) for a in self.data_axes)

    @property
    def n_model(self) -> int:
        return axis_size(self.mesh, self.model_axis)


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim called `name`."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


def axes_size(mesh, axes) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


_CTX: Optional[MeshContext] = None


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    global _CTX
    _CTX = ctx


def get_mesh_context() -> Optional[MeshContext]:
    return _CTX


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshContext]):
    prev = get_mesh_context()
    set_mesh_context(ctx)
    try:
        yield ctx
    finally:
        set_mesh_context(prev)


def data_axes() -> tuple[str, ...] | None:
    ctx = get_mesh_context()
    return ctx.data_axes if ctx else None


def model_axis() -> str | None:
    ctx = get_mesh_context()
    return ctx.model_axis if ctx else None


# ------------------------------------------------------------- groups ----
_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group over the mesh axes `axes` (a name or a tuple of
    names) that holds this rank: `mesh.get_group(name)` for one axis; for
    several, one group per slice, made once (every rank makes every slice's
    group in the same order, as `new_group` asks). Its ranks are in
    ascending order, so rank order in the group is the row-major order of
    the named axes for a mesh laid out as an arange."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axes_size(mesh, axes))
        mine = None
        for row in ranks.tolist():
            group = dist.new_group(sorted(row))
            if dist.get_rank() in row:
                mine = group
        _GROUPS[key] = mine
    return _GROUPS[key]


# -------------------------------------------------------- collectives ----
_STATS: dict = {}
_TIMED = False


def collective_stats() -> dict:
    """{op: {"calls", "bytes", "seconds"}} since the last reset; bytes are
    those this rank sends (all_gather / broadcast from the owner: its
    tensor; reduce_scatter: its full input; all_reduce_max: its mask;
    all_to_all: its tensor, its own block included);
    seconds only of the calls made inside `timed_collectives()`."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


@contextlib.contextmanager
def timed_collectives():
    """Time every collective made inside (profiling): the device is
    synchronised before and after each call, so the seconds are the
    collective's own, and the run is slower than the main path."""
    global _TIMED
    prev, _TIMED = _TIMED, True
    try:
        yield
    finally:
        _TIMED = prev


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(op: str, t: torch.Tensor, sent: int, fn):
    s = _STATS.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(sent)
    if not _TIMED:
        return fn()
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(t)
    s["seconds"] += time.perf_counter() - t0
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` (same shape on every rank) stacked along dim 0 in
    rank order: (size * m, ...). Bools travel as uint8."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    out = torch.empty((size * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    _timed("all_gather", src, _nbytes(src), lambda: (
        dist.all_gather_into_tensor(out, wire, group=group)))
    return out.view(torch.bool) if src.dtype == torch.bool else out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's `t` (same shape, dim 0 divisible by the group
    size), rank r keeping rows [r*m/size, (r+1)*m/size)."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if src.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(src.shape)} does "
                         f"not divide over {size} ranks")
    out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _timed("reduce_scatter", src, _nbytes(src), lambda: (
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)))
    return out


def all_to_all(t: torch.Tensor, group,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`t` (same shape on every rank, dim 0 divisible by the group size
    m) cut along dim 0 into m blocks, block j sent to group rank j; the
    result stacks the blocks received, rank i's at rows [i*n/m,
    (i+1)*n/m): jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True). Written into `out` (contiguous, t's shape) if given."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if src.shape[0] % size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(src.shape)} does "
                         f"not divide over {size} ranks")
    if out is None:
        out = torch.empty_like(src)
    _timed("all_to_all", src, _nbytes(src), lambda: (
        dist.all_to_all_single(out, src, group=group)))
    return out


def broadcast(t: torch.Tensor, owner: int, group) -> torch.Tensor:
    """`t` from group rank `owner` into every rank's `t` (in place; the
    owner's is read only). Returns `t`."""
    mine = dist.get_rank(group) == owner
    _timed("broadcast", t, _nbytes(t) if mine else 0, lambda: (
        dist.broadcast(t, src=dist.get_global_rank(group, owner),
                       group=group)))
    return t


def all_reduce_max(mask: torch.Tensor, group) -> torch.Tensor:
    """The elementwise OR (a MAX) of every rank's bool `mask`."""
    wire = mask.to(torch.uint8).contiguous()
    _timed("all_reduce_max", wire, _nbytes(wire), lambda: (
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)))
    return wire.bool()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's `t` (a new tensor)."""
    out = t.contiguous().clone()
    _timed("all_reduce_sum", out, _nbytes(out), lambda: (
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)))
    return out
