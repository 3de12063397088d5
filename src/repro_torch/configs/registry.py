"""Architecture registry: the JAX package's ten assigned archs by id.

`get_arch(id)` returns the config module (`CONFIG`, `SMOKE_CONFIG`) of an
arch the port runs: the dense LMs. The others raise NotImplementedError
naming the ROADMAP item they wait for. The dry-run machinery of the JAX
registry (`Cell`, `make_cell`, the shape sets) is not ported.
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
}

_WAITING = {
    "llama4-scout-17b-16e": "the MoE layers (ROADMAP A16)",
    "kimi-k2-1t-a32b": "the MoE layers (ROADMAP A16)",
    "gin-tu": "the GNNs and segment_matmul (ROADMAP A16, B8)",
    "graphcast": "the GNNs and segment_matmul (ROADMAP A16, B8)",
    "meshgraphnet": "the GNNs and segment_matmul (ROADMAP A16, B8)",
    "graphsage-reddit": "the GNNs and segment_matmul (ROADMAP A16, B8)",
    "bst": "BST serving and embedding_bag (ROADMAP A16, B7)",
}


def get_arch(arch_id: str):
    if arch_id in _WAITING:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it waits for {_WAITING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; expected one of "
                       f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
