"""Argument checks shared by the CUDA kernel wrappers."""

from __future__ import annotations

import torch


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; return it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
    return dev


def f32(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    return t.contiguous()


# the point storage dtypes the fit's kernels read (`ops.storage_dtype`)
STORAGE = (torch.float32, torch.bfloat16)


def storage(name: str, t: torch.Tensor) -> torch.Tensor:
    """Point rows stored as float32 or bfloat16."""
    if t.dtype not in STORAGE:
        raise TypeError(f"{name}: expected float32 or bfloat16 storage, got "
                        f"{t.dtype}")
    return t.contiguous()


def i32(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    return t.contiguous()


def u8(t: torch.Tensor) -> torch.Tensor:
    """A bool mask as the uint8 bytes the kernels read."""
    return t.to(torch.uint8).contiguous()
