"""Optimizers, ported from the JAX package's `train/optimizers.py` (no
optax there, none here):

  adamw     - f32 m / v (+ an f32 master copy where params are low-precision)
  adafactor - factored second moment, no momentum, no master copy (kimi-k2:
              AdamW would need ~14 TB of state for 1.04T params)
  sgdm      - plain momentum (tests / ablations)

The state is a dict parallel to the params, as the JAX package's pytree:
{"step": int32 scalar, "leaves": the params' tree with, per leaf, {"m",
"v"[, "master"]} | {"vr", "vc"} | {"v"} | {"m"}}, so a JAX checkpoint's
state carries over (`convert.opt_state_from_numpy`).

`opt_update` computes what the JAX function does, op for op in f32 (the
global norm's and the means' sums in torch's order), but updates the
params and the state IN PLACE and returns the same trees: at
h2o-danube-1.8b's width a functional update would hold old and new m, v,
master and params at once (2 x 25.6 GB). Run it under torch.no_grad()
(the train steps do). Like the JAX function it clips every gradient to
f32 at once (`clip_by_global_norm`) before the leaves are updated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_fp32: bool = True       # keep an f32 master for low-precision params


# ------------------------------------------------------------------ trees --
def tree_leaves(tree: Any) -> list:
    """The leaves in jax's flattening order: dict keys sorted, lists and
    tuples in order, None dropped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (dicts, lists and tuples; None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return None if tree is None else fn(tree, *rest)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


# ------------------------------------------------------------------ state --
def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    """The optimizer state of `params` (on their device): zeros, and for
    adamw with `master_fp32` an f32 copy of each non-f32 leaf."""
    def leaf_state(p):
        z = dict(dtype=torch.float32, device=p.device)
        if cfg.kind == "adamw":
            s = {"m": torch.zeros(p.shape, **z),
                 "v": torch.zeros(p.shape, **z)}
            if cfg.master_fp32 and p.dtype != torch.float32:
                s["master"] = p.float()
            return s
        if cfg.kind == "adafactor":
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        if cfg.kind == "sgdm":
            return {"m": torch.zeros(p.shape, **z)}
        raise ValueError(cfg.kind)

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "leaves": tree_map(leaf_state, params)}


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio, in f32 (a 0-d
    tensor on step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = torch.minimum(step / max(cfg.warmup, 1), torch.ones((), **f32))
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.decay_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, **f32) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of their f32 sums of
    squares: a 0-d f32 tensor."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(_f32(leaf) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Any, max_norm: float):
    """(every gradient as f32 times min(1, max_norm / max(norm, 1e-9)),
    the norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: _f32(g) * scale, grads), gnorm


# ----------------------------------------------------------------- update --
def _upd_adamw(cfg, p, g, s, lr, bc1, bc2):
    s["m"].mul_(cfg.b1).add_(g * (1 - cfg.b1))
    s["v"].mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
    mh = s["m"] / bc1
    u = mh.div_((s["v"] / bc2).sqrt_().add_(cfg.eps))
    base = s["master"] if "master" in s else _f32(p)
    u.add_(cfg.weight_decay * base).mul_(lr)
    new = base - u
    if "master" in s:
        s["master"].copy_(new)
    p.copy_(new)


def _upd_adafactor(cfg, p, g, s, lr):
    g2 = g * g + 1e-30
    if "vr" in s:
        s["vr"].mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g2, dim=-1))
        s["vc"].mul_(cfg.b2).add_((1 - cfg.b2) * torch.mean(g2, dim=-2))
        r = s["vr"] / torch.clamp(torch.mean(s["vr"], dim=-1, keepdim=True),
                                  min=1e-30)
        u = g / (torch.sqrt(r)[..., None] * torch.sqrt(s["vc"])[..., None, :]
                 + cfg.eps)
    else:
        s["v"].mul_(cfg.b2).add_((1 - cfg.b2) * g2)
        u = g / (torch.sqrt(s["v"]) + cfg.eps)
    del g2
    # update clipping (Shazeer & Stern): bound the RMS of the update
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp(rms, min=1.0)
    pf = _f32(p)
    p.copy_(pf - lr * (u + cfg.weight_decay * pf))


def _upd_sgdm(cfg, p, g, s, lr):
    s["m"].mul_(cfg.b1).add_(g)
    p.copy_(_f32(p) - lr * s["m"])


@torch.no_grad()
def opt_update(cfg: OptConfig, grads: Any, state: dict, params: Any):
    """One optimizer step: returns (params, state, {"grad_norm", "lr"}),
    the params and state updated in place (the same trees). The learning
    rate is the schedule's at the new step; gradients are clipped to the
    global norm `cfg.grad_clip` first, all of them to f32."""
    step = state["step"] + 1
    stepf = float(step)
    lr = float(lr_schedule(cfg, step.cpu()))
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    f32 = dict(dtype=torch.float32)
    bc1 = float(1 - torch.tensor(cfg.b1, **f32) ** torch.tensor(stepf, **f32))
    bc2 = float(1 - torch.tensor(cfg.b2, **f32) ** torch.tensor(stepf, **f32))
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_s = _state_leaves(params, state["leaves"])
    del grads
    for i, (p, s) in enumerate(zip(flat_p, flat_s)):
        g = flat_g[i]
        flat_g[i] = None            # each clipped gradient freed once used
        if cfg.kind == "adamw":
            _upd_adamw(cfg, p, g, s, lr, bc1, bc2)
        elif cfg.kind == "adafactor":
            _upd_adafactor(cfg, p, g, s, lr)
        elif cfg.kind == "sgdm":
            _upd_sgdm(cfg, p, g, s, lr)
        else:
            raise ValueError(cfg.kind)
        del g
    state["step"] = step
    return params, state, {
        "grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}


def _state_leaves(params: Any, leaves: Any) -> list:
    """The per-leaf state dicts of `leaves`, in `params`' leaf order."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _state_leaves(params[k], leaves[k])]
    if isinstance(params, (list, tuple)):
        return [x for i, v in enumerate(params)
                for x in _state_leaves(v, leaves[i])]
    return [] if params is None else [leaves]
