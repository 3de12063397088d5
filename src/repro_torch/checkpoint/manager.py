"""Checkpoints: atomic, crc-checked snapshots of a tree of arrays (a numpy
copy of the JAX package's `checkpoint/manager.py`, with torch in place of
jax arrays and of the jax tree utilities).

Layout:   <dir>/step_<N>/
              manifest.json      step, metadata, and per leaf its dtype,
                                 shape and crc32
              arrays.npz         one entry per leaf (path-keyed)

The layout is the JAX package's byte for byte, so a snapshot written by
one package restores in the other: leaf keys are jax's key paths joined
with "//" (dict keys sorted, list and tuple entries by index, NamedTuple
fields as ".field", None dropped), the crc32 is taken over the bytes as
saved, and a bf16 leaf is saved as its uint16 view under "dtype":
"bfloat16" (restored as a torch.bfloat16 tensor: numpy has no bf16).

  * atomic: written to step_<N>.tmp then renamed, so a crash mid-save never
    corrupts the latest checkpoint; `.tmp` directories are never listed;
  * bounded: `keep` newest steps are retained, older ones removed;
  * checked: every leaf is verified against its crc32 before it is trusted.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.alid import resolve_device

_SEP = "//"


class CheckpointCorruption(RuntimeError):
    """A checkpoint leaf failed its recorded crc32 on restore: the bytes on
    disk are not the bytes that were saved. Callers fall back to an earlier
    step rather than resume from poisoned state."""


def _crc32(arr: np.ndarray) -> int:
    # reshape(-1) first: a 0-d leaf cannot be viewed at a different itemsize
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map_leaves(tree: Any, fn: Callable[[str, Any], Any],
                path: tuple = ()) -> Any:
    """`tree` with every leaf replaced by fn(key, leaf), in jax's flatten
    order and with jax's key strings; None stays None (no leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        # jax keeps an OrderedDict's order and sorts every other dict's keys
        ordered = isinstance(tree, collections.OrderedDict)
        out = ((k, _map_leaves(tree[k], fn, path + (str(k),)))
               for k in (tree if ordered else sorted(tree)))
        return collections.OrderedDict(out) if ordered else dict(out)
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(getattr(tree, f), fn,
                                        path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _flatten(tree: Any) -> dict[str, Any]:
    flat: dict[str, Any] = {}

    def put(key, leaf):
        flat[key] = leaf

    _map_leaves(tree, put)
    return flat


def _to_host(leaf) -> tuple[np.ndarray, bool]:
    """(host array as saved, whether the leaf is bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
                True
        return t.numpy(), False
    return np.asarray(leaf), False


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[dict] = None, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, bf16 = _to_host(leaf)
        info = {"dtype": "bfloat16" if bf16 else str(arr.dtype),
                "shape": list(arr.shape)}
        # integrity: crc32 of the bytes as SAVED (post bf16->uint16 view),
        # verified on restore before any bit of the leaf is trusted
        info["crc32"] = _crc32(arr)
        manifest["leaves"][key] = info
        arrays[key] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(list_checkpoints(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """Read a checkpoint's manifest (tree structure + metadata) without
    touching the array payload: cheap epoch/step introspection."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _verify_leaf(key: str, info: dict, arr: np.ndarray, where: str) -> None:
    """Check a loaded leaf against its manifest crc32 (pre bf16 view: the
    bytes as saved). Checkpoints written before crcs existed lack the
    field and skip verification."""
    want = info.get("crc32")
    if want is not None and _crc32(arr) != want:
        raise CheckpointCorruption(
            f"leaf {key!r} in {where} failed its crc32 — the checkpoint "
            "bytes on disk are corrupt")


def _load_leaf(data, key: str, info: dict, where: str, verify: bool):
    """One leaf as saved, checked; bf16 leaves as torch.bfloat16 tensors,
    the rest as host numpy arrays."""
    arr = np.array(data[key])
    if verify:
        _verify_leaf(key, info, arr, where)
    if info["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def restore_checkpoint_tree(ckpt_dir: str, step: int, verify: bool = True
                            ) -> tuple[dict, dict[str, Any]]:
    """Structure-free restore: shapes and dtypes come from the MANIFEST, not
    a `like` template, which suits snapshots whose arrays grow and shrink
    between steps (the online clustering's epochs). Returns (manifest,
    {flat_key: host array}); nesting (if any) stays encoded in the
    `//`-joined keys. bf16 leaves come back as torch.bfloat16 tensors.
    `verify=True` checks every leaf against its manifest crc32 and raises
    `CheckpointCorruption` on mismatch."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = load_manifest(ckpt_dir, step)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = {key: _load_leaf(data, key, info, path, verify)
               for key, info in manifest["leaves"].items()}
    return manifest, out


def restore_checkpoint(ckpt_dir: str, step: int, like: Any, device="cuda",
                       verify: bool = True) -> tuple[int, Any]:
    """Restore into the structure of `like` (a tree whose leaves have a
    `.shape`): every leaf comes back as a torch tensor on `device` (the card
    unless the caller asks for the CPU), whatever its device when saved.
    `verify=True` checks each leaf's manifest crc32 (`CheckpointCorruption`
    on mismatch)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = load_manifest(ckpt_dir, step)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(key, leaf):
            arr = _load_leaf(data, key, manifest["leaves"][key], path,
                             verify)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {key!r}: saved shape "
                                 f"{tuple(arr.shape)}, template "
                                 f"{tuple(leaf.shape)}")
            return torch.as_tensor(arr, device=dev)

        tree = _map_leaves(like, load)
    return manifest["step"], tree
