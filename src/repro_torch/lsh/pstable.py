"""p-stable Locality Sensitive Hashing (Datar et al., SoCG'04), replicated
tables.

Each table is ONE sorted permutation of the dataset keyed by a 32-bit mixed
bucket key: a query is a binary search (searchsorted) plus a bounded
contiguous gather, fixed-shape and batched over queries.

h_{l,j}(v) = floor((w_{l,j} . v + b_{l,j}) / r)   w ~ N(0,1)  (p=2 stable)
key_l(v)  = mix32(h_{l,1..m})                     (multiply-xor fold)

Keys are uint32 values held in int64 tensors, so that sorting them gives
the uint32 order the JAX package's tables have.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as trandom
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mix_fold, to_uint32


class LSHParams(NamedTuple):
    n_tables: int = 4          # L
    n_projections: int = 8     # mu (hash functions per table)
    seg_len: float = 1.0       # r, the quantization segment (paper Fig. 6)
    probe: int = 16            # max neighbours gathered per table per query


class LSHTables(NamedTuple):
    proj: torch.Tensor         # (L, m, d) f32
    bias: torch.Tensor         # (L, m) f32
    sorted_keys: torch.Tensor  # (L, n) int64 uint32 values, ascending
    perm: torch.Tensor         # (L, n) int64: sorted position -> data index


def _mix_fold(h: torch.Tensor) -> torch.Tensor:
    """Fold (..., m) lattice words (int64 holding uint32) into (...,) uint32
    keys held as int64: the multiply-xor fold of `kernels.ref.mix_fold`."""
    return to_uint32(mix_fold(h))


def make_projections(rng: torch.Tensor, params: LSHParams, d: int,
                     device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The ONE place the PRNG key becomes (proj, bias), drawn exactly as
    `jax.random.normal` / `uniform` draw them. The draw runs on the CPU
    (a few thousand numbers), so the projections are the same bits on every
    device."""
    keys = trandom.split(rng)
    proj = trandom.normal(keys[0], (params.n_tables, params.n_projections, d))
    bias = trandom.uniform(keys[1], (params.n_tables, params.n_projections),
                           0.0, params.seg_len)
    return proj.to(device), bias.to(device)


def hash_points(v: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
                seg_len: float, backend: str = "auto") -> torch.Tensor:
    """Keys for v:(n, d) under all tables -> (L, n) int64 uint32 values,
    through `ops.lsh_hash`."""
    keys = ops.lsh_hash(v, proj, bias, seg_len, backend=backend)   # (n, L)
    return to_uint32(keys).T.contiguous()


def build_lsh(v: torch.Tensor, params: LSHParams, rng: torch.Tensor,
              backend: str = "auto") -> LSHTables:
    _, d = v.shape
    proj, bias = make_projections(rng, params, d, v.device)
    keys = hash_points(v, proj, bias, params.seg_len, backend)    # (L, n)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    return LSHTables(proj=proj, bias=bias, sorted_keys=sorted_keys,
                     perm=order)


def hash_queries(q: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
                 seg_len: float, backend: str = "auto"):
    """(keys, salts) for queries q:(Q, d) -> both (L, Q) int64 uint32.

    The salt folds the raw float bits of the f32 projections, so two
    distinct points get distinct salts and probe different windows of one
    oversized bucket (CIVS coverage, paper Fig. 4b). As in the JAX package,
    the salt projection is recomputed here rather than emitted by the hash
    kernel."""
    keys = hash_points(q, proj, bias, seg_len, backend)
    z = (torch.einsum("nd,lmd->lnm", q.float(), proj.float())
         + bias.float()[:, None, :])
    return keys, _mix_fold(to_uint32(z.view(torch.int32)))


def _query_one_table(sorted_keys: torch.Tensor, perm: torch.Tensor,
                     keys: torch.Tensor, salts: torch.Tensor,
                     probe: int) -> torch.Tensor:
    """One table, queries keys/salts:(Q,) -> (Q, probe) data indices whose
    key matches, else -1. A bucket larger than `probe` is read from a
    per-query salted offset, so queries into one large bucket get different
    members (CIVS coverage, paper Fig. 4b)."""
    start = torch.searchsorted(sorted_keys, keys, side="left")
    end = torch.searchsorted(sorted_keys, keys, side="right")
    span = torch.clamp_min(end - start - probe, 0)
    offset = torch.where(span > 0, salts % (span + 1), 0)
    raw = (start + offset)[:, None] + torch.arange(probe, device=keys.device)
    pos = torch.clamp_max(raw, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == keys[:, None]) & (raw < end[:, None])
    return torch.where(hit, perm[pos], -1)


def probe_tables(sorted_keys: torch.Tensor, perm: torch.Tensor,
                 keys: torch.Tensor, salts: torch.Tensor,
                 probe: int) -> torch.Tensor:
    """Probe pre-hashed queries against the tables.

    sorted_keys/perm: (L, n); keys/salts: (L, Q) -> (Q, L*probe) data
    indices, -1 = miss."""
    cands = torch.stack([
        _query_one_table(sorted_keys[t], perm[t], keys[t], salts[t], probe)
        for t in range(keys.shape[0])])                       # (L, Q, probe)
    return cands.permute(1, 0, 2).reshape(keys.shape[1], -1)


def query_batch(tables: LSHTables, q: torch.Tensor, params: LSHParams,
                backend: str = "auto") -> torch.Tensor:
    """Candidates for queries q:(Q, d) -> (Q, L*probe) data indices."""
    keys, salts = hash_queries(q, tables.proj, tables.bias, params.seg_len,
                               backend)
    return probe_tables(tables.sorted_keys, tables.perm, keys, salts,
                        params.probe)


def bucket_sizes(tables: LSHTables) -> torch.Tensor:
    """Per data item: the size of its bucket in table 0 (PALID seeding
    samples initial vertexes from buckets with > 5 items)."""
    sk = tables.sorted_keys[0]
    left = torch.searchsorted(sk, sk, side="left")
    right = torch.searchsorted(sk, sk, side="right")
    sizes = torch.zeros(sk.shape[0], dtype=torch.int32, device=sk.device)
    sizes[tables.perm[0]] = (right - left).to(torch.int32)
    return sizes
