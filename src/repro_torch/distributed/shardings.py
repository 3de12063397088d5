"""Logical-axis sharding rules (the JAX package's `distributed/
shardings.py`): model code and the engines speak logical axes; this module
resolves them against the active mesh context.

Conventions (the JAX package's DESIGN.md §4):
  batch/tokens/edges/nodes/seeds/candidates -> data axes (("pod","data")
                                               when multi-pod)
  heads / mlp / vocab-rows / experts        -> "model"
  kv_seq (long-context decode cache)        -> data axes (SP for batch=1)
  ZeRO: optimizer states & master params additionally shard their largest
  replicated dim over the data axes (FSDP-style).

The rules are pure functions over names and shapes. A spec is a
`PartitionSpec`: a tuple with, per tensor dim, None, an axis name or a
tuple of names, entry for entry the JAX `PartitionSpec` of the same rule.
Parameter trees are nested dicts, lists, tuples and NamedTuples whose
leaves have a `.shape` (tensors, arrays, `Leaf`); a tree of specs has the
same structure. `placements(spec, ctx)` maps a spec onto the DTensor
placements (`Shard(dim)` / `Replicate()`) of each mesh dim.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

from repro_torch.distributed.context import axis_size, get_mesh_context


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), an axis name, or a tuple of
    names. `PartitionSpec("data", None)` is JAX's `P("data", None)`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Leaf(NamedTuple):
    """A tensor's shape and dtype, standing in for the tensor where only
    its shape matters (an abstract parameter tree)."""
    shape: tuple
    dtype: Any = None


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


def _size(leaf) -> int:
    return math.prod(tuple(leaf.shape))


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or x is None


# ------------------------------------------------------------- trees ----
def _children(tree):
    """(keys, values, rebuild) of a container: dict keys sorted (JAX's
    order), lists / tuples / NamedTuples by position."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys], (
            lambda vals: type(tree)(zip(keys, vals)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree), lambda vals: type(tree)(*vals)
    if isinstance(tree, (list, tuple)):
        return list(range(len(tree))), list(tree), (
            lambda vals: type(tree)(vals))
    raise TypeError(f"not a parameter tree node: {type(tree).__name__}")


def tree_map_with_path(fn, tree, path: tuple = (), is_leaf=_is_leaf):
    """fn(path, leaf) over every leaf; `path` holds each level's dict key
    or sequence index (NamedTuple fields by name)."""
    if is_leaf(tree):
        return fn(path, tree)
    keys, vals, rebuild = _children(tree)
    return rebuild([tree_map_with_path(fn, v, path + (k,), is_leaf)
                    for k, v in zip(keys, vals)])


def tree_leaves(tree, is_leaf=_is_leaf) -> list:
    out: list = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree,
                       is_leaf=is_leaf)
    return out


def _spec_leaf(x) -> bool:
    return isinstance(x, PartitionSpec)


# ------------------------------------------------------------- rules ----
def _data_entry(ctx):
    return ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]


def logical_spec(*axes: Optional[str]) -> PartitionSpec:
    """Resolve logical axis names to a spec under the current context."""
    ctx = get_mesh_context()
    if ctx is None:
        return P()
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif a in ("batch", "tokens", "seeds", "kv_seq", "bags", "shards"):
            # "shards": the ShardedStore's leading axis, one slice of the
            # dataset per device group
            out.append(_data_entry(ctx))
        elif a in ("edges", "nodes", "candidates"):
            # no tensor-parallel dim: the whole mesh (data + model)
            out.append(ctx.data_axes + (ctx.model_axis,))
        elif a in ("heads", "kv_heads", "mlp", "vocab", "expert", "model"):
            out.append(ctx.model_axis)
        elif a in ("embed", "seq", "none"):
            out.append(None)
        else:
            raise ValueError(f"unknown logical axis {a!r}")
    return P(*out)


def _axes_size(ctx, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axis_size(ctx.mesh, n) for n in names)


def degrade_spec(spec: PartitionSpec, shape: tuple) -> PartitionSpec:
    """Per-dim fallback for non-divisible shapes: drop trailing mesh axes
    from a dim's assignment until it divides (replicate as last resort)."""
    ctx = get_mesh_context()
    if ctx is None:
        return spec
    out = []
    shape = tuple(shape)
    for entry, dim in zip(list(spec) + [None] * (len(shape) - len(spec)),
                          shape):
        names = list(entry) if isinstance(entry, tuple) else (
            [entry] if entry else [])
        while names and dim % _axes_size(ctx, tuple(names)) != 0:
            names.pop()
        out.append(tuple(names) if len(names) > 1
                   else (names[0] if names else None))
    return P(*out)


def zero_shard_spec(spec: PartitionSpec, shape: tuple) -> PartitionSpec:
    """FSDP/ZeRO: shard the largest still-replicated dim over the data axes
    (if divisible). No-op if the spec already uses the data axes."""
    ctx = get_mesh_context()
    if ctx is None:
        return spec
    used = set()
    for s in spec:
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    if any(a in used for a in ctx.data_axes):
        return spec
    n_data = ctx.n_data
    shape = tuple(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, dim) in enumerate(zip(entries, shape)):
        if s is None and dim % n_data == 0 and dim > best_size:
            best, best_size = i, dim
    if best is None:
        return spec
    entries[best] = _data_entry(ctx)
    return P(*entries)


# ------------------------------------------------------------ params ----
def _lm_leaf_spec(path: tuple, ndim: int, q_ok: bool,
                  kv_ok: bool) -> PartitionSpec:
    name = path[-1]
    stacked = path[0] == "blocks"  # leading (n_groups,) axis
    lead: tuple = (None,) if stacked else ()

    def spec(*tail):
        return (P(*(lead + tail)) if len(lead) + len(tail) == ndim
                else P(*((None,) * ndim)))

    if name == "embed":
        return P("model", None)
    if name == "lm_head":
        return P(None, "model")
    if name == "wq":
        return spec(None, "model") if q_ok else spec(None, None)
    if name in ("wk", "wv"):
        return spec(None, "model") if kv_ok else spec(None, None)
    if name in ("w_gate", "w_up"):
        if "moe" in path:
            return spec("model", None, None)      # (G, E, D, F)
        return spec(None, "model")                # (G, D, F)
    if name == "wo":
        return spec("model", None) if q_ok else spec(None, None)
    if name == "w_down":
        if "moe" in path:
            return spec("model", None, None)      # (G, E, F, D)
        return spec("model", None)                # (G, F, D)
    if name == "router":
        return spec(None, None)
    return P(*((None,) * ndim))                   # norms, biases, misc


def lm_param_specs(abstract: Any, cfg: Any = None) -> Any:
    """Spec tree for transformer params (same structure).

    Head projections shard over the model axis only when the head count
    divides it; the FFN / expert weights always shard. With ctx.fsdp
    (ZeRO-3) every param of more than 2**21 elements additionally shards
    its largest remaining dim over the data axes."""
    ctx = get_mesh_context()
    n_model = ctx.n_model if ctx else 1
    q_ok = cfg is None or (cfg.n_heads % n_model == 0)
    kv_ok = cfg is None or (cfg.n_kv_heads % n_model == 0)
    fsdp = ctx.fsdp if ctx else False

    def f(path, leaf):
        keys = tuple(str(k) for k in path)
        # shared-expert weights live under moe/shared but shard like ffn
        if "shared" in keys:
            keys = tuple(k for k in keys if k != "moe")
        spec = _lm_leaf_spec(keys, _ndim(leaf), q_ok, kv_ok)
        if fsdp and _size(leaf) * 2 > (1 << 22):  # leave small leaves alone
            spec = zero_shard_spec(spec, leaf.shape)
        return spec
    return tree_map_with_path(f, abstract)


def store_specs(store: Any) -> Any:
    """Specs for a `core.store.ShardedStore` (same structure). The
    per-shard payload (points, validity, the slot -> index map, the
    per-shard sorted keys and perms) shards its leading S axis over the
    data axes; the routing balls, the shared LSH projections and the (n,)
    inverse maps replicate."""
    from repro_torch.core.store import ShardedStore
    from repro_torch.lsh.pstable import ShardedLSHTables
    if not isinstance(store, ShardedStore):
        raise TypeError(f"store_specs: expected a ShardedStore, got "
                        f"{type(store).__name__}")

    def sharded(leaf):
        return degrade_spec(logical_spec(
            *(["shards"] + [None] * (_ndim(leaf) - 1))), leaf.shape)

    def replicated(leaf):
        return P(*((None,) * _ndim(leaf)))

    return ShardedStore(
        shards=sharded(store.shards),
        valid=sharded(store.valid),
        global_idx=sharded(store.global_idx),
        shard_of=replicated(store.shard_of),
        slot_of=replicated(store.slot_of),
        centers=replicated(store.centers),
        radii=replicated(store.radii),
        tables=ShardedLSHTables(
            proj=replicated(store.tables.proj),
            bias=replicated(store.tables.bias),
            sorted_keys=sharded(store.tables.sorted_keys),
            perm=sharded(store.tables.perm),
        ),
    )


def gnn_param_specs(abstract: Any) -> Any:
    """GNN params are small (<= a few MB): replicate everything."""
    return tree_map_with_path(lambda _, leaf: P(*((None,) * _ndim(leaf))),
                              abstract)


def bst_param_specs(abstract: Any) -> Any:
    """Embedding tables row-sharded over model; dense layers replicated.
    A sequence index reads "[i]" in a path, as a JAX SequenceKey prints."""
    def f(path, leaf):
        keys = tuple(k if isinstance(k, str) else f"[{k}]" for k in path)
        if any("table" in k for k in keys) and _ndim(leaf) == 2:
            return P("model", None)
        return P(*((None,) * _ndim(leaf)))
    return tree_map_with_path(f, abstract)


def opt_state_specs(param_specs: Any, param_abs: Any, opt_abs: dict) -> dict:
    """Specs for an optimizer-state tree (the JAX package's train/
    optimizers.py layout): per-leaf dicts keyed m/v/master (adamw), vr/vc/v
    (adafactor), m (sgdm). Same spec as the param (axes dropped for
    factored states), then ZeRO-sharded over the data axes."""
    flat_specs = tree_leaves(param_specs, is_leaf=_spec_leaf)
    flat_abs = tree_leaves(param_abs)

    def is_state(x):
        return isinstance(x, dict) and all(_is_leaf(v) for v in x.values())

    flat_states = tree_leaves(opt_abs["leaves"], is_leaf=is_state)
    if not len(flat_specs) == len(flat_abs) == len(flat_states):
        raise ValueError("opt_state_specs: the spec, param and state trees "
                         "differ in structure")
    out_states = []
    for spec, p, st in zip(flat_specs, flat_abs, flat_states):
        entries = list(spec) + [None] * (_ndim(p) - len(spec))
        d: dict = {}
        for key, leaf in st.items():
            if key in ("m", "v", "master"):
                s = P(*entries)
            elif key == "vr":
                s = P(*entries[:-1])
            elif key == "vc":
                s = P(*(entries[:-2] + entries[-1:]))
            else:
                s = P(*((None,) * _ndim(leaf)))
            d[key] = zero_shard_spec(s, leaf.shape)
        out_states.append(d)
    states = iter(out_states)
    leaves = tree_map_with_path(lambda _, __: next(states), param_abs)
    return {"step": P(), "leaves": leaves}


def placements(spec: PartitionSpec, ctx) -> tuple:
    """The DTensor placements of `spec` on ctx.mesh, one per mesh dim:
    `Shard(i)` where tensor dim i's entry names that mesh dim, else
    `Replicate()`. A tensor dim split over several mesh dims is sharded
    by each in mesh-dim order (DTensor's order), which is the entry's
    order for the conventions above."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                if name in by_axis:
                    raise ValueError(f"{spec}: mesh axis {name!r} shards "
                                     "two tensor dims")
                by_axis[name] = i
    names = list(ctx.mesh.mesh_dim_names)
    unknown = set(by_axis) - set(names)
    if unknown:
        raise ValueError(f"{spec}: axes {sorted(unknown)} are not in the "
                         f"mesh's {names}")
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate()
                 for n in names)
