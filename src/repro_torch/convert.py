"""Carry state from the JAX package to the port.

ALID has no weights; its state is the LSH tables, the LID states and the
fitted `Clustering`; the LMs, BST and the GNNs of the model zoo have
their parameter trees. Each function here takes the JAX package's objects as
numpy arrays (`np.asarray` of its jax arrays, or its `to_dict()`) and
returns the port's counterpart, so that tests can hand both packages the
same tables, states and weights. Like every entry point of the port, each
puts its tensors on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alid import Clustering, resolve_device
from repro_torch.core.lid import LIDState
from repro_torch.core.store import ShardedStore
from repro_torch.lsh.pstable import LSHTables, ShardedLSHTables


def lsh_tables_from_numpy(proj, bias, sorted_keys, perm,
                          device="cuda") -> LSHTables:
    """proj (L, m, d) f32, bias (L, m) f32, sorted_keys (L, n) uint32,
    perm (L, n) int32 -> LSHTables (keys held as int64 uint32 values)."""
    device = resolve_device(device)
    return LSHTables(
        proj=torch.as_tensor(np.asarray(proj, np.float32), device=device),
        bias=torch.as_tensor(np.asarray(bias, np.float32), device=device),
        sorted_keys=torch.as_tensor(
            np.asarray(sorted_keys).astype(np.uint32).astype(np.int64),
            device=device),
        perm=torch.as_tensor(np.asarray(perm).astype(np.int64),
                             device=device))


def sharded_store_from_numpy(shards, valid, global_idx, shard_of, slot_of,
                             centers, radii, proj, bias, sorted_keys, perm,
                             device="cuda") -> ShardedStore:
    """The leaves of a JAX `ShardedStore` (its `tables` flattened into
    proj, bias, sorted_keys (S, L, cap) uint32 and perm (S, L, cap) int32)
    -> the port's ShardedStore (indices int64, keys int64 holding uint32)."""
    device = resolve_device(device)

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    return ShardedStore(
        shards=on(shards, np.float32), valid=on(valid, bool),
        global_idx=on(global_idx, np.int64), shard_of=on(shard_of, np.int64),
        slot_of=on(slot_of, np.int64), centers=on(centers, np.float32),
        radii=on(radii, np.float32),
        tables=ShardedLSHTables(
            proj=on(proj, np.float32), bias=on(bias, np.float32),
            sorted_keys=on(np.asarray(sorted_keys).astype(np.uint32),
                           np.int64),
            perm=on(perm, np.int64)))


def lid_state_from_numpy(beta_idx, beta_mask, v_beta, x, ax, n_iters,
                         converged, device="cuda") -> LIDState:
    """The fields of one LIDState (unbatched, as one seed of the JAX
    package) or of a vmapped batch of them -> a batched LIDState."""
    device = resolve_device(device)
    beta_idx = np.asarray(beta_idx, np.int32)
    batched = beta_idx.ndim == 2

    def lane(a, dtype):
        a = np.asarray(a, dtype)
        return torch.as_tensor(a if batched else a[None], device=device)

    return LIDState(beta_idx=lane(beta_idx, np.int32),
                    beta_mask=lane(beta_mask, bool),
                    v_beta=lane(v_beta, np.float32),
                    x=lane(x, np.float32), ax=lane(ax, np.float32),
                    n_iters=lane(n_iters, np.int32),
                    converged=lane(converged, bool))


def clustering_from_dict(d: dict) -> Clustering:
    """The JAX package's `Clustering.to_dict()` -> the port's Clustering."""
    return Clustering.from_dict({k: np.asarray(v) for k, v in d.items()})


def lm_params_from_numpy(tree, device="cuda"):
    """The JAX package's LM parameter tree (nested dicts and lists of numpy
    arrays, `jax.tree.map(np.asarray, params)`) -> the port's, the same
    keys and shapes. bf16 leaves arrive as `ml_dtypes.bfloat16` arrays;
    they are recognised by their dtype's name and their bits reinterpreted
    as torch.bfloat16, so this module needs no `ml_dtypes`."""
    resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def bst_params_from_numpy(tree, device="cuda"):
    """The JAX package's BST parameter tree (tables, `blocks` as a list of
    dicts, the MLP) -> the port's (`models.bst.init_params`'s layout)."""
    return lm_params_from_numpy(tree, device)


def gnn_params_from_numpy(tree, device="cuda") -> dict:
    """The JAX package's GNN parameter tree (its `layers` stacked along a
    leading axis, as `lax.scan` takes them) -> the port's
    (`models.gnn.init_params`'s layout: `layers` a list, one dict a
    layer), leaf for leaf, bf16 through its bits."""
    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    params = {k: lm_params_from_numpy(v, device) for k, v in tree.items()
              if k != "layers"}
    n_layers = len(np.asarray(_first_leaf(tree["layers"])))
    params["layers"] = [lm_params_from_numpy(unstack(tree["layers"], i),
                                             device)
                        for i in range(n_layers)]
    return params


def _first_leaf(t):
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t
