"""Config-driven decoder-only transformer: the LMs of the JAX package's
zoo, dense (h2o-danube-1.8b, deepseek-7b, gemma2-27b) and MoE
(llama4-scout-17b-16e, kimi-k2-1t-a32b: `models/moe.py`), ported from its
`models/transformer.py` with the same parameter tree, cast points and
cache layout.

Parameters are a plain dict of tensors, as the JAX package's pytree:
`embed`, `final_norm`, `lm_head` (untied configs) and `blocks/layer{i}`
per pattern position, each leaf stacked over the layer groups (leading
(G,) axis). The KV cache is, per pattern position, (G, B, Hkv, S_max, dh).
Attention goes through `kernels.ops.flash_attention`; every entry point
takes `backend` ("auto" | "ref" | "kernel") and hands it down to that op.

Training differentiates `forward` (`train.steps.lm_loss`): the attention
kernel's backward is `csrc/flash_attention_bwd.cu`, and the token lookup's
gradient sums by token through `ops.gather_rows` (no atomics), so a step's
gradients are the same bits from run to run. `cfg.remat` checkpoints each
layer group as the JAX package's `jax.checkpoint` of its scan body does
(`torch.utils.checkpoint`, non-reentrant): the backward recomputes the
group from its input, and since every kernel is deterministic the
recompute gives the forward's bits, so remat on and off give equal
gradients. What has no counterpart here: the JAX package's sharding
constraints (identity without a mesh, so `training=True` computes what
`training=False` does; the train steps refuse a mesh context until ROADMAP
A16's dry-run), the layer-group `scan` (a Python loop over the groups), and
`models/flags.py`, which only steers XLA's cost probe.

Weights are drawn in slices straight into their stacked leaves
(`layers.normal_init`), so a leaf larger than the card's room for
counters (kimi-k2's (384, 7,168, 2,048) experts) draws in bounded
memory; `init_params(experts=(a, b))` draws an expert-parallel rank's
share of every MoE layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("full",)  # cycled kinds: full|local|chunked|full_nope
    window: int = 4096
    chunk: int = 8192
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma: scale embeddings by sqrt(d)
    post_norms: bool = False             # gemma2: post-attn/post-ffn RMSNorms
    dtype: Any = torch.bfloat16
    remat: bool = True                   # checkpoint each layer group

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.n_layers,
                                                        self.pattern)
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count, as the JAX package counts it."""
        d, h, kv, dh, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.d_ff, self.vocab)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.moe:
            ffn = (3 * d * self.moe.d_ff * self.moe.n_experts
                   + 3 * d * self.moe.d_ff * self.moe.n_shared
                   + d * self.moe.n_experts)
        else:
            ffn = 3 * d * f
        norms = 2 * d + (2 * d if self.post_norms else 0)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + norms) + emb + d

    def active_param_count(self) -> int:
        """Parameters a token runs through: every one in a dense model; in
        a MoE model attention, the top-k and shared experts and the
        embeddings, as the JAX package counts them (no norms, no
        router)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = (d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d)
        ffn = 3 * d * self.moe.d_ff * (self.moe.top_k + self.moe.n_shared)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


# ----------------------------------------------------------------- params --
def _layer_init(key, cfg: LMConfig, alloc, experts=None) -> dict:
    """One layer's leaves, each drawn into `alloc(path, shape, dtype)`;
    a MoE layer's `moe` in place of `ffn`, as in the JAX package."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = cfg.dtype
    ks = trandom.split(key, 8)

    def zeros(name):
        return alloc((name,), (d,), torch.float32).zero_()

    def normal(i, path, shape):
        return L.normal_init(ks[i], shape, dtype,
                             out=alloc(path, shape, dtype))

    p = {"ln_attn": zeros("ln_attn"), "wq": normal(0, ("wq",), (d, h * dh)),
         "wk": normal(1, ("wk",), (d, kv * dh)),
         "wv": normal(2, ("wv",), (d, kv * dh)),
         "wo": normal(3, ("wo",), (h * dh, d)), "ln_ffn": zeros("ln_ffn")}
    if cfg.post_norms:
        p["ln_attn_post"] = zeros("ln_attn_post")
        p["ln_ffn_post"] = zeros("ln_ffn_post")
    if cfg.moe is not None:
        p["moe"] = moe_init(ks[4], cfg.moe, d, dtype, experts=experts,
                            alloc=lambda path, shape, dt: alloc(
                                ("moe", *path), shape, dt))
    else:
        p["ffn"] = {"w_gate": normal(5, ("ffn", "w_gate"), (d, cfg.d_ff)),
                    "w_up": normal(6, ("ffn", "w_up"), (d, cfg.d_ff)),
                    "w_down": normal(7, ("ffn", "w_down"), (cfg.d_ff, d))}
    return p


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stacked_tree(layer: dict, stacked: dict, path=()) -> dict:
    """The layer tree's structure over the stacked leaves, keyed by path."""
    return {k: (_stacked_tree(v, stacked, (*path, k)) if isinstance(v, dict)
                else stacked[(*path, k)]) for k, v in layer.items()}


def take_group(tree: dict, g: int) -> dict:
    """Layer group g of a stacked block tree (views, no copy)."""
    return _tree_map(lambda t: t[g], tree)


def init_params(rng, cfg: LMConfig, device="cuda",
                experts: Optional[tuple[int, int]] = None) -> dict:
    """The JAX package's `init_params(rng, cfg)`, drawn with the port's
    threefry on `device`: the same keys, the same weights (normal draws
    within the ulps of `random.normal`, then rounded to cfg.dtype). Each
    layer group is drawn from `fold_in(k_layers[i], g)` straight into its
    slice of the stacked leaves, one group at a time, each leaf in slices
    of `layers.DRAW_CHUNK` elements. `experts=(a, b)` keeps experts
    [a, b) of every MoE layer (an expert-parallel rank's share, the same
    bits as those rows of the whole draw)."""
    dev = resolve_device(device)
    dtype = cfg.dtype
    keys = trandom.split(rng, 2 + len(cfg.pattern))
    k_emb, k_head, k_layers = keys[0], keys[1], keys[2:]
    params: dict = {
        "embed": L.normal_init(k_emb, (cfg.vocab, cfg.d_model), dtype,
                               device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal_init(k_head, (cfg.d_model, cfg.vocab),
                                          dtype, device=dev)
    blocks = {}
    for i in range(len(cfg.pattern)):
        stacked: dict = {}
        for g in range(cfg.n_groups):
            def alloc(path, shape, dt, g=g):
                if path not in stacked:
                    stacked[path] = torch.empty((cfg.n_groups, *shape),
                                                dtype=dt, device=dev)
                return stacked[path][g]
            layer = _layer_init(trandom.fold_in(k_layers[i], g), cfg, alloc,
                                experts)
        blocks[f"layer{i}"] = _stacked_tree(layer, stacked)
    params["blocks"] = blocks
    return params


# ---------------------------------------------------------------- forward --
def _attn_kwargs(cfg: LMConfig, kind: str) -> dict:
    if kind == "local":
        return dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap)
    if kind == "chunked":
        return dict(causal=True, chunk=cfg.chunk, softcap=cfg.attn_softcap)
    return dict(causal=True, softcap=cfg.attn_softcap)


def _attention(p, cfg: LMConfig, kind: str, x, positions, cache=None,
               cache_pos: int = 0, kv_start=None, backend: str = "auto"):
    """x: (B, S, D). cache: None or this layer's dict(k, v) of (B, Hkv,
    S_max, dh) views, written in place at [cache_pos, cache_pos + S)
    (the JAX package's dynamic_update_slice makes a new buffer)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(x, p["wq"]).view(b, s, h, dh)
    k = L.dense(x, p["wk"]).view(b, s, kv, dh)
    v = L.dense(x, p["wv"]).view(b, s, kv, dh)
    if kind != "full_nope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    q = q.transpose(1, 2)   # (B, H, S, dh), a view
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    kw = _attn_kwargs(cfg, kind)
    if cache is None:
        out = ops.flash_attention(q, k, v, 0, backend=backend, **kw)
    else:
        cache["k"][:, :, cache_pos:cache_pos + s] = k
        cache["v"][:, :, cache_pos:cache_pos + s] = v
        out = ops.flash_attention(q, cache["k"], cache["v"], cache_pos,
                                  kv_start=kv_start, backend=backend, **kw)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return L.dense(out, p["wo"])


def _dense_ffn(p, x):
    g = torch.nn.functional.silu(L.dense(x, p["w_gate"]).float()).to(x.dtype)
    u = L.dense(x, p["w_up"])
    return L.dense(g * u, p["w_down"])


def _block(p, cfg: LMConfig, kind: str, x, positions, cache=None,
           cache_pos: int = 0, kv_start=None, backend: str = "auto"):
    a_in = L.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a_out = _attention(p, cfg, kind, a_in, positions, cache, cache_pos,
                       kv_start, backend)
    if cfg.post_norms:
        a_out = L.rms_norm(a_out, p["ln_attn_post"], cfg.norm_eps)
    x = x + a_out
    f_in = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    if cfg.moe is not None:
        f_out, aux = moe_apply(p["moe"], cfg.moe, f_in)
    else:
        f_out, aux = _dense_ffn(p["ffn"], f_in), None
    if cfg.post_norms:
        f_out = L.rms_norm(f_out, p["ln_ffn_post"], cfg.norm_eps)
    return x + f_out, aux


def _embed(params, cfg: LMConfig, tokens, backend: str = "auto"):
    x = ops.gather_rows(params["embed"], tokens, backend=backend).to(
        cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32,
                                        device=x.device)).to(cfg.dtype)
    return x


def _head(params, cfg: LMConfig, x):
    """Final norm, the head product rounded to the model dtype, then f32,
    then the final softcap."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.dense(x, head.to(cfg.dtype)).float()
    return L.softcap(logits, cfg.final_softcap)


def forward(params: dict, cfg: LMConfig, tokens, training: bool = True,
            backend: str = "auto"):
    """Training/prefill forward. tokens: (B, S) -> (logits (B, S, V) f32,
    aux f32: the MoE layers' load-balance losses summed over the layers
    and divided by n_layers, as in the JAX package; 0.0 in a dense
    model). `training` changes nothing here (see the module docstring);
    under autograd with `cfg.remat` each layer group is checkpointed."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, backend)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(x, aux, group):
        for i, kind in enumerate(cfg.pattern):
            x, a = _block(group[f"layer{i}"], cfg, kind, x, positions,
                          backend=backend)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        group = take_group(params["blocks"], g)
        if remat:
            x, aux = checkpoint(group_body, x, aux, group,
                                use_reentrant=False)
        else:
            x, aux = group_body(x, aux, group)
    return _head(params, cfg, x), aux / cfg.n_layers


# ----------------------------------------------------------------- decode --
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Stacked KV cache: per pattern position, (G, B, Hkv, S_max, dh)
    zeros. Local (sliding-window) layers keep max_len slots too, as in the
    JAX package."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_groups, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {f"layer{i}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for i in range(len(cfg.pattern))}


def _cache_forward(params: dict, cfg: LMConfig, cache: dict, tokens,
                   pos: int, pad=None, backend: str = "auto",
                   last_only: bool = False):
    """Forward T tokens against a KV cache, writing them at [pos, pos+T)
    in place. T=1 is decode; T=prompt_len with pos=0 is prefill. Returns
    (logits (B, T, V), cache); with `last_only`, the logits of the last
    position only, (B, 1, V): the head runs on that position alone.

    `pad` ((B,) int32, optional) is the per-row LEFT-pad length of a
    packed serving batch: row i's cache slots [0, pad[i]) hold pad tokens.
    RoPE positions shift to logical positions (slot - pad[i]) and attention
    masks those slots out (ops.flash_attention kv_start), so every row
    computes what it would solo. None = unpadded. A MoE layer routes every
    position of the call, so a prefill's capacity is that of all B x T
    tokens, pads included, as in the JAX package."""
    b, t = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = (pos + torch.arange(t, device=x.device))[None, :].expand(b, t)
    if pad is not None:
        # logical positions; pad-slot rows go negative but are never attended
        positions = positions - pad[:, None].to(positions.dtype)
    for g in range(cfg.n_groups):
        group = take_group(params["blocks"], g)
        for i, kind in enumerate(cfg.pattern):
            layer_cache = {"k": cache[f"layer{i}"]["k"][g],
                           "v": cache[f"layer{i}"]["v"][g]}
            x, _ = _block(group[f"layer{i}"], cfg, kind, x, positions,
                          cache=layer_cache, cache_pos=pos, kv_start=pad,
                          backend=backend)
    if last_only:
        x = x[:, -1:]
    return _head(params, cfg, x), cache


def decode_step(params: dict, cfg: LMConfig, cache: dict, token, pos: int,
                pad=None, backend: str = "auto"):
    """One decode step. token: (B, 1); pos: the write position (tokens
    already in the cache). `pad`: per-row left-pad of a packed batch (see
    `_cache_forward`). Returns (logits (B, V), cache)."""
    logits, cache = _cache_forward(params, cfg, cache, token, int(pos), pad,
                                   backend)
    return logits[:, 0, :], cache


def prefill_with_cache(params: dict, cfg: LMConfig, cache: dict, tokens,
                       pad=None, backend: str = "auto"):
    """Prefill a prompt into an (empty) cache. Left-padded batches pass the
    per-row pad length (see `_cache_forward`). Returns (last_logits (B, V),
    cache): the last slot is each row's last REAL token (left-pad aligns
    last tokens). Only that position's logits are computed."""
    logits, cache = _cache_forward(params, cfg, cache, tokens, 0, pad,
                                   backend, last_only=True)
    return logits[:, -1, :], cache


def param_bytes(params: dict) -> int:
    """Bytes held by a parameter tree."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
    _tree_map(add, params)
    return total

