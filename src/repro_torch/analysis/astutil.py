"""Shared AST helpers: file iteration, import resolution and call-name
matching, used by the dispatch and concurrency passes (the twin of
`repro.analysis.astutil`, without its jit-decorator parsing: the port has
no `jax.jit`)."""

from __future__ import annotations

import ast
import glob
import os
from typing import Iterator, Optional

# What the source passes scan, repo-relative: the port's package and its
# examples (a root holding `*` is a glob). The kernel package is the
# backend itself (its plain versions and tile plans ARE the one sanctioned
# implementation), and this package hosts the rule data.
SCAN_ROOTS = ("src/repro_torch", "examples/torch_*.py")
EXCLUDE_PREFIXES = ("src/repro_torch/kernels", "src/repro_torch/analysis")


def iter_source_files(root: str,
                      roots=SCAN_ROOTS,
                      exclude=EXCLUDE_PREFIXES) -> Iterator[str]:
    """Yield repo-relative paths of every .py file in scope, sorted."""
    out = []
    for base in roots:
        if "*" in base:
            out += [os.path.relpath(p, root) for p in
                    glob.glob(os.path.join(root, base)) if p.endswith(".py")]
            continue
        absbase = os.path.join(root, base)
        if os.path.isfile(absbase) and absbase.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(absbase):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "_build"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.relpath(os.path.join(dirpath, fn),
                                               root))
    return iter(sorted({rel for rel in out
                        if not any(rel.startswith(p) for p in exclude)}))


class ImportTable:
    """alias -> fully-qualified module/name map for one module.

    `import torch.nn.functional as F` maps F -> torch.nn.functional;
    `from torch import linalg` maps linalg -> torch.linalg; `import numpy
    as np` maps np -> numpy.
    """

    def __init__(self, tree: ast.AST):
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.alias[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def resolve(self, dotted: str) -> str:
        """Expand the leading alias of a dotted name: F.pairwise_distance
        -> torch.nn.functional.pairwise_distance."""
        head, _, rest = dotted.partition(".")
        full = self.alias.get(head, head)
        return f"{full}.{rest}" if rest else full


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_full_name(node: ast.Call, imports: ImportTable) -> Optional[str]:
    """Fully-qualified callee name of a Call, or None (lambdas, chains)."""
    name = dotted_name(node.func)
    return imports.resolve(name) if name else None


def base_name(node: ast.AST) -> Optional[str]:
    """Root Name of an expression chain: `state.x[i].item` -> state."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def parse_file(root: str, rel: str):
    """(source, tree) for a repo-relative path."""
    with open(os.path.join(root, rel), "r") as f:
        src = f.read()
    return src, ast.parse(src, filename=rel)
