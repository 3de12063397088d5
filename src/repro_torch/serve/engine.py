"""Batched LM serving: prefill, then a decode loop with per-slot state, and
a BatchServer that packs queued requests into fixed batch slots: the
JAX package's `serve/engine.py`, on the port's models.

The JAX package jits the decode loop as a `scan`; here it is a Python loop
over `decode_step`, which writes the KV cache in place. Sampling draws from
the port's threefry, so greedy and sampled tokens follow the JAX package's
for the same logits and key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device
from repro_torch.models import transformer as lm_m


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: Optional[int] = None


def _sample(logits, key, scfg: ServeConfig):
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return trandom.categorical(key, logits / scfg.temperature,
                               axis=-1).to(torch.int32)


def _decode_loop(params, cfg: lm_m.LMConfig, scfg: ServeConfig, cache,
                 first_logits, prompt_len: int, rng, pad=None,
                 backend: str = "auto"):
    """Sample, then decode the sampled token, `max_new_tokens` times: a
    key split off `rng` each step, finished rows (eos) emit 0. The JAX
    scan also decodes the last sampled token, whose logits nobody reads;
    this loop stops before that step."""
    b = first_logits.shape[0]
    logits = first_logits
    done = torch.zeros((b,), dtype=torch.bool, device=logits.device)
    toks = []
    for t in range(scfg.max_new_tokens):
        rng, key = trandom.split(rng)
        tok = _sample(logits, key, scfg)
        tok = torch.where(done, torch.zeros_like(tok), tok)
        toks.append(tok)
        if t + 1 < scfg.max_new_tokens:
            logits, cache = lm_m.decode_step(params, cfg, cache, tok[:, None],
                                             prompt_len + t, pad, backend)
        if scfg.eos_id is not None:
            done = done | (tok == scfg.eos_id)
    return torch.stack(toks, dim=1), cache    # (B, max_new)


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def generate(params, cfg: lm_m.LMConfig, prompts,
             scfg: ServeConfig = ServeConfig(), rng=None, prompt_lens=None,
             *, device="cuda", backend: str = "auto",
             stats: Optional[dict] = None):
    """prompts: (B, P) ints -> generated (B, max_new) int32 on `device`,
    where `params` must live.

    `prompt_lens` ((B,) ints, optional) is the per-row REAL prompt length
    of a LEFT-padded batch (row i's prompt occupies slots [P - lens[i],
    P)). When given, pad slots are masked out of attention and RoPE
    positions run logical (0-based at each row's first real token), so
    every packed prompt decodes exactly as it would solo. None = all rows
    are full length. `stats`, if a dict, receives the host seconds of the
    prefill and of the decode loop (each ending in a synchronise) and the
    number of decode steps."""
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"generate: params lie on {params['embed'].device}"
                         f", the call asks for {dev}")
    prompts = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, p = prompts.shape
    rng = trandom.PRNGKey(0) if rng is None else rng
    max_len = p + scfg.max_new_tokens + 1
    cache = lm_m.init_cache(cfg, b, max_len, device=dev)
    pad = None
    if prompt_lens is not None:
        lens = torch.as_tensor(np.asarray(prompt_lens), device=dev)
        pad = (p - lens.reshape(b)).to(torch.int32)
    t0 = _sync(dev) if stats is not None else 0.0
    first_logits, cache = lm_m.prefill_with_cache(params, cfg, cache,
                                                  prompts, pad, backend)
    t1 = _sync(dev) if stats is not None else 0.0
    out, _ = _decode_loop(params, cfg, scfg, cache, first_logits, p, rng,
                          pad, backend)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=_sync(dev) - t1,
                     decode_steps=max(scfg.max_new_tokens - 1, 0))
    return out


def pack_prompts(batch, slots: int):
    """One BatchServer batch: the prompts LEFT-padded to the longest so
    their last tokens align, in `slots` rows -> (tokens (slots, maxp)
    int32, lens (slots,) int32). Empty slots hold zero tokens and length
    maxp (no pad masking)."""
    maxp = max(len(p) for p in batch)
    prompts = np.zeros((slots, maxp), np.int32)
    lens = np.full((slots,), maxp, np.int32)
    for i, p in enumerate(batch):
        prompts[i, maxp - len(p):] = p
        lens[i] = len(p)
    return prompts, lens


class BatchServer:
    """Fixed-slot batched server: requests queue up, each serve() call packs
    up to `batch_slots` prompts (left-padded to a shared length), runs one
    batched generate, and returns per-request completions. `batch_stats`
    holds each batch's prefill and decode seconds (see `generate`)."""

    def __init__(self, params, cfg: lm_m.LMConfig, batch_slots: int = 8,
                 scfg: ServeConfig = ServeConfig(), *, device="cuda",
                 backend: str = "auto"):
        self.device = resolve_device(device)
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.batch_slots = batch_slots
        self.backend = backend
        self.queue: list[tuple[int, np.ndarray]] = []
        self.batch_stats: list[dict] = []
        self._next_id = 0

    def submit(self, prompt_tokens: np.ndarray) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, np.asarray(prompt_tokens, np.int32)))
        return rid

    def serve(self) -> dict[int, np.ndarray]:
        results: dict[int, np.ndarray] = {}
        while self.queue:
            batch = self.queue[:self.batch_slots]
            self.queue = self.queue[self.batch_slots:]
            prompts, lens = pack_prompts([p for _, p in batch],
                                         self.batch_slots)
            stats = {"requests": len(batch), "prompt_len": prompts.shape[1]}
            out = generate(self.params, self.cfg, prompts, self.scfg,
                           prompt_lens=lens, device=self.device,
                           backend=self.backend, stats=stats).cpu().numpy()
            self.batch_stats.append(stats)
            for i, (rid, _) in enumerate(batch):
                results[rid] = out[i]
        return results
