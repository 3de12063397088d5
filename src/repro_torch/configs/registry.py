"""Architecture registry: the JAX package's ten assigned archs by id.

`get_arch(id)` returns the config module (`CONFIG`, `SMOKE_CONFIG`) of an
arch the port runs: the dense LMs and BST. The others raise
NotImplementedError naming the ROADMAP item they wait for. The recsys
shapes (`RECSYS_SHAPES`) are copied as data; the rest of the JAX
registry's dry-run machinery (`Cell`, `make_cell`, the input specs, the LM
and GNN shape sets) is not ported.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "gemma2-27b",
    "deepseek-7b",
    "h2o-danube-1.8b",
    "llama4-scout-17b-16e",
    "kimi-k2-1t-a32b",
    "gin-tu",
    "graphcast",
    "meshgraphnet",
    "graphsage-reddit",
    "bst",
]

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "deepseek-7b": "deepseek_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "bst": "bst",
}

_WAITING = {
    "llama4-scout-17b-16e": "the MoE layers (ROADMAP A16)",
    "kimi-k2-1t-a32b": "the MoE layers (ROADMAP A16)",
    "gin-tu": "the GNNs (ROADMAP A16)",
    "graphcast": "the GNNs (ROADMAP A16)",
    "meshgraphnet": "the GNNs (ROADMAP A16)",
    "graphsage-reddit": "the GNNs (ROADMAP A16)",
}

# the recsys cells' shapes, as the JAX registry has them: BST's step and
# batch (serving: candidates scored; retrieval: one user's context against
# n_candidates items)
RECSYS_SHAPES = {
    "train_batch": dict(step="train", batch=65_536),
    "serve_p99": dict(step="serve", batch=512),
    "serve_bulk": dict(step="serve", batch=262_144),
    "retrieval_cand": dict(step="retrieval", batch=1, n_candidates=1_000_000),
}


def get_arch(arch_id: str):
    if arch_id in _WAITING:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it waits for {_WAITING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; expected one of "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
