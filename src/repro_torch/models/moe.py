"""Mixture-of-Experts FFN with sort-based token dispatch and an explicit
expert-parallel all-to-all: the JAX package's `models/moe.py`, on tensors.

Dataflow (one process, or each rank of the mesh's model axis):
  1. router on the tokens (f32) -> top-k experts + gates
  2. rank tokens within each expert (stable argsort), drop beyond capacity C
  3. scatter to the dispatch buffer (E, C, D)
  4. under a mesh: all_to_all over the model axis, (E, C, D) ->
     (E/m, C*m, D), each rank holding E/m experts        [EP dispatch]
  5. batched expert FFN (SwiGLU) over the local experts
  6. the reverse all_to_all, gather back to tokens, weight by gates
                                                          [EP combine]

Points the JAX package's numbers depend on, kept here:
- the router product runs in f32 (callers keep TF32 off, as
  `layers.dense` asks), and top-k keeps jax's tie order, the lower
  expert first on equal probabilities (the first k of a stable
  descending sort; `torch.topk` promises no order);
- the aux loss is taken over softmax(logits), for the sigmoid router too;
- the capacity counts every token of the call, the left-padded pad slots
  of a packed serving batch included: pads are routed and take capacity
  as in the JAX package;
- ranks, keep and destinations are int32 / int64 integers equal to
  jax's; a dropped entry goes to the spare row E * C and reads zeros;
- the experts' products emit x's dtype, SiLU runs in f32 and is rounded
  back before `* u`; the shared expert takes SiLU in x's dtype;
- the combine multiplies each expert output by its gate in x's dtype and
  sums the k terms in f32, one after another in k order, rounding once:
  jnp.sum upcasts a bf16 sum to f32, and XLA's CPU reduce adds the k
  terms in order (tests/test_torch_moe.py holds the port to it bitwise
  on equal inputs).

Under autograd (training) the one-process dispatch runs the same
products without `out=`, so that the router, dispatch, experts, combine
and aux loss are differentiable (tests/test_torch_train.py holds llama4's
smoke loss and gradients to JAX's); no MoE config trains on one card, and
the mesh branch trains with the dry-run (ROADMAP A16).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device
from repro_torch.distributed.context import (all_gather, all_reduce_sum,
                                             all_to_all, axes_size,
                                             axis_group, get_mesh_context)
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # always-on shared experts (kimi-k2 style)
    capacity_factor: float = 1.25
    router: str = "softmax"        # "softmax" | "sigmoid" (llama4 top-1)
    norm_topk: bool = True         # renormalize top-k gates (deepseek/kimi)
    aux_loss_coef: float = 0.01


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_shapes(cfg: MoEConfig, d_model: int) -> dict:
    """The (E, ...) expert leaves' shapes."""
    e, f = cfg.n_experts, cfg.d_ff
    return {"w_gate": (e, d_model, f), "w_up": (e, d_model, f),
            "w_down": (e, f, d_model)}


def moe_init(key, cfg: MoEConfig, d_model: int, dtype, device="cuda",
             experts: Optional[tuple[int, int]] = None,
             alloc=None) -> dict:
    """The JAX package's `moe_init(key, cfg, d_model, dtype)`: the router
    (d_model, E) in f32, the experts in dtype, the shared expert's
    SwiGLU. Every leaf is drawn in slices (`layers.normal_init`) into its
    tensor: `alloc(path, shape, dtype)`, if given, returns it (a layer
    group's slice of a stacked leaf), else a new one on `device`.

    `experts=(a, b)` draws experts [a, b) of the expert leaves only (an
    expert-parallel rank's share): the same bits as rows a..b of the
    whole draw, each leaf starting at a times its expert's size."""
    ks = trandom.split(key, 5)
    if alloc is None:
        dev = resolve_device(device)

        def alloc(path, shape, dt):
            return torch.empty(shape, dtype=dt, device=dev)
    lo, hi = experts if experts is not None else (0, cfg.n_experts)
    if not 0 <= lo < hi <= cfg.n_experts:
        raise ValueError(f"moe_init: experts {experts} outside "
                         f"[0, {cfg.n_experts})")
    p = {"router": L.normal_init(
        ks[0], (d_model, cfg.n_experts), torch.float32,
        out=alloc(("router",), (d_model, cfg.n_experts), torch.float32))}
    for i, (name, shape) in enumerate(expert_shapes(cfg, d_model).items()):
        one = shape[1] * shape[2]
        mine = (hi - lo, *shape[1:])
        p[name] = L.normal_init(ks[1 + i], mine, dtype,
                                out=alloc((name,), mine, dtype),
                                start=lo * one)
    if cfg.n_shared > 0:
        f = cfg.n_shared * cfg.d_ff
        ks2 = trandom.split(ks[4], 3)
        p["shared"] = {
            name: L.normal_init(ks2[i], shape, dtype,
                                out=alloc(("shared", name), shape, dtype))
            for i, (name, shape) in enumerate(
                (("w_gate", (d_model, f)), ("w_up", (d_model, f)),
                 ("w_down", (f, d_model))))}
    return p


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA's CPU backend expands it: 1 / (1 + exp(-x)),
    each op rounded to x's dtype (torch's fused sigmoid rounds once)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * sigmoid(x), each op in x's dtype."""
    return x * sigmoid(x)


def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots an expert takes from a call of t tokens: int(t k / E x the
    capacity factor) + 1 in Python floats, rounded up to a multiple of 8,
    at least 8."""
    cap = int((t * cfg.top_k / cfg.n_experts) * cfg.capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)


def route(router: torch.Tensor, cfg: MoEConfig, x: torch.Tensor):
    """The router on x (T, D): (logits f32 (T, E), gates f32 (T, k),
    eidx int64 (T, k)), top-k in jax's tie order."""
    logits = x.float() @ router.float()
    if cfg.router == "sigmoid":
        probs = sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.norm_topk and cfg.router == "softmax":
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, gates, eidx


def aux_loss(logits: torch.Tensor, eidx: torch.Tensor,
             cfg: MoEConfig) -> torch.Tensor:
    """Switch's load-balance loss E * sum_e f_e * P_e * coef, over
    softmax(logits) whatever the router."""
    e = cfg.n_experts
    pe = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    hit = torch.zeros((eidx.shape[0], e), dtype=torch.bool,
                      device=eidx.device)
    hit.scatter_(1, eidx, True)
    fe = torch.mean(hit.float(), dim=0)
    return e * torch.sum(pe * fe) * cfg.aux_loss_coef


def dispatch_plan(eidx: torch.Tensor, n_experts: int, cap: int):
    """Each (token, choice) entry's rank within its expert, in token order
    (a stable argsort, then searchsorted on the left), whether it is kept
    (rank < cap) and its row of the dispatch buffer (expert * cap + rank,
    the spare row E * cap if dropped): (rank int32, keep bool, dst int64),
    each (T * k,)."""
    flat_e = eidx.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=eidx.device, dtype=flat_e.dtype))
    rank_sorted = torch.arange(n, device=eidx.device) - seg_start[sorted_e]
    rank = torch.zeros((n,), dtype=torch.int32, device=eidx.device)
    rank[order] = rank_sorted.to(torch.int32)
    keep = rank < cap
    dst = torch.where(keep, flat_e * cap + rank, n_experts * cap)
    return rank, keep, dst


def _swiglu_experts(params, h, out=None):
    """h: (E_local, C, D) -> (E_local, C, D), each product batched over
    the experts and emitted in h's dtype (into `out` if given)."""
    g = torch.bmm(h, params["w_gate"].to(h.dtype))
    u = torch.bmm(h, params["w_up"].to(h.dtype))
    a = silu(g.float()).to(h.dtype) * u
    return torch.bmm(a, params["w_down"].to(h.dtype), out=out)


def _dispatch_combine(params, cfg: MoEConfig, x: torch.Tensor, group=None,
                      info: Optional[dict] = None):
    """x: (T, D) local tokens -> (out (T, D), aux f32 scalar). With
    `group` (the mesh's model axis) the expert leaves hold this rank's
    E/m experts and the buffers travel by all_to_all. `info`, if a dict,
    receives the capacity, the dropped entries and eidx."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    logits, gates, eidx = route(params["router"], cfg, x)
    aux = aux_loss(logits, eidx, cfg)
    _, keep, dst = dispatch_plan(eidx, e, cap)
    if info is not None:
        info.update(capacity=cap, dropped=int((~keep).sum()), eidx=eidx)
        if _KEEP_INPUTS:
            info.update(x=x, keep=keep)

    # every entry is scattered, the dropped ones onto the spare row E * C,
    # and the experts' output keeps a zero spare row for them to read:
    # no mask, so no wait for the device
    tok_of = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dst] = x[tok_of]
    buf = buf[:-1].view(e, cap, d)
    if group is None and ops.wants_grad(
            x, *(w for w in params.values() if torch.is_tensor(w))):
        # training (on the CPU: no MoE config trains on one card): the
        # same products without `out=`, which autograd does not take
        y = _swiglu_experts(params, buf).reshape(e * cap, d)
        h = torch.cat([y, y.new_zeros((1, d))])
        vals = h[dst].view(t, k, d) * gates.to(x.dtype)[..., None]
        return _combine(vals, k, x.dtype), aux
    h = torch.empty((e * cap + 1, d), dtype=x.dtype, device=x.device)
    h[-1].zero_()
    into = h[:-1].view(e, cap, d)

    if group is not None:
        m = dist.get_world_size(group)
        # (E, C, D) -> (m, E/m, C, D), block j to rank j -> (E/m, m C, D)
        got = all_to_all(buf, group).view(m, e // m, cap, d)
        y = _swiglu_experts(params, got.transpose(0, 1).reshape(
            e // m, m * cap, d))
        back = y.view(e // m, m, cap, d).transpose(0, 1).contiguous()
        all_to_all(back, group, out=into)
    else:
        _swiglu_experts(params, buf, out=into)

    vals = h[dst].view(t, k, d) * gates.to(x.dtype)[..., None]
    return _combine(vals, k, x.dtype), aux


def _combine(vals: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """The k gated expert outputs (T, k, D) summed in f32 in k order."""
    out = vals[:, 0].float()
    for j in range(1, k):
        out = out + vals[:, j].float()
    return out.to(dtype)


def _shared_ffn(params, x):
    s = params["shared"]
    g = silu(L.dense(x, s["w_gate"].to(x.dtype)))    # in x's dtype
    u = L.dense(x, s["w_up"].to(x.dtype))
    return L.dense(g * u, s["w_down"].to(x.dtype))


def _local_experts(params, cfg: MoEConfig, rank: int, m: int) -> dict:
    """The router and this model rank's E/m experts: the leaves as given
    where they hold E/m experts, rows [rank E/m, (rank+1) E/m) where they
    hold all E."""
    e = cfg.n_experts
    if e % m:
        raise ValueError(f"moe_apply: {e} experts do not divide over a "
                         f"model axis of {m}")
    per = e // m
    out = {"router": params["router"]}
    for name in EXPERT_LEAVES:
        w = params[name]
        if w.shape[0] == e:
            w = w[rank * per:(rank + 1) * per]
        elif w.shape[0] != per:
            raise ValueError(f"moe_apply: {name} holds {w.shape[0]} "
                             f"experts, neither {e} nor {per}")
        out[name] = w
    return out


def _group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _mesh_apply(params, cfg: MoEConfig, x: torch.Tensor, ctx, info):
    """The JAX package's shard_map branch. Every rank passes the whole x
    (B, S, D) and takes its token shard by the JAX rule: batch over the
    data axes where B divides, seq over the model axis where S does (else
    replicated there: decode dispatches the same tokens on every model
    rank). The experts go over the model axis; the output shards are
    all-gathered, so every rank returns the whole (B, S, D); aux is the
    mean of the ranks' aux."""
    b, s, d = x.shape
    data_axes = tuple(a for a in ctx.data_axes if a != ctx.model_axis)
    m = ctx.n_model
    n_data = axes_size(ctx.mesh, data_axes) if data_axes else 1
    seq_shard = s % m == 0 and s >= m
    batch_shard = b % n_data == 0 and b >= n_data
    model_group = axis_group(ctx.mesh, ctx.model_axis)
    data_group = axis_group(ctx.mesh, data_axes) if data_axes else None
    all_group = axis_group(ctx.mesh, data_axes + (ctx.model_axis,))
    mr, dr = _group_rank(model_group), _group_rank(data_group)
    bb = b // n_data if batch_shard else b
    ss = s // m if seq_shard else s
    xb = x[dr * bb:(dr + 1) * bb] if batch_shard else x
    xx = xb[:, mr * ss:(mr + 1) * ss] if seq_shard else xb
    local = _local_experts(params, cfg, mr, m)
    o, aux = _dispatch_combine(local, cfg, xx.reshape(bb * ss, d),
                               model_group, info)
    world = dist.get_world_size(all_group)
    aux = all_reduce_sum(aux.reshape(1), all_group)[0] / world
    # rank (data i, model j) of the gather holds block (i, j)
    blocks = all_gather(o.view(1, bb, ss, d).contiguous(), all_group)
    blocks = blocks.view(n_data, m, bb, ss, d)
    if not batch_shard:
        blocks = blocks[:1]
    if not seq_shard:
        blocks = blocks[:, :1]
    out = blocks.permute(0, 2, 1, 3, 4).reshape(b, s, d)
    return out, aux


_LOG: Optional[list] = None
_KEEP_INPUTS = False


@contextlib.contextmanager
def recording(keep_inputs: bool = False):
    """Record every `moe_apply` made inside: a list that gains, per call,
    {"capacity", "dropped" (entries past capacity), "eidx" (T, k) of this
    process's tokens}, and with `keep_inputs` also "x" (T, D), the tokens
    routed, and "keep" (T * k,). Reading `dropped` synchronises the
    device, so this is for checks, not the main path."""
    global _LOG, _KEEP_INPUTS
    prev, _LOG = _LOG, []
    prev_keep, _KEEP_INPUTS = _KEEP_INPUTS, keep_inputs
    try:
        yield _LOG
    finally:
        _LOG, _KEEP_INPUTS = prev, prev_keep


def moe_apply(params: dict, cfg: MoEConfig, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux f32 scalar). Under
    a mesh context (`distributed.mesh_context`) the dispatch runs over
    the mesh (`_mesh_apply`); the experts may be given whole or as this
    rank's share (`moe_init(experts=...)`)."""
    b, s, d = x.shape
    info = {} if _LOG is not None else None
    ctx = get_mesh_context()
    if ctx is None:
        out, aux = _dispatch_combine(params, cfg, x.reshape(b * s, d),
                                     None, info)
        out = out.view(b, s, d)
    else:
        out, aux = _mesh_apply(params, cfg, x, ctx, info)
    if "shared" in params:
        out = out + _shared_ffn(params, x)
    if info is not None:
        _LOG.append(info)
    return out, aux
