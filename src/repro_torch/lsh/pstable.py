"""p-stable Locality Sensitive Hashing (Datar et al., SoCG'04): replicated
tables, and the shard-local tables of the sharded and streamed stores.

Each table is ONE sorted permutation of the dataset keyed by a 32-bit mixed
bucket key: a query is a binary search (searchsorted) plus a bounded
contiguous gather, fixed-shape and batched over queries. Shard-local tables
share the projections, so a query hashes once and the same (key, salt)
probes every shard; one global probe window per (table, query) is split
across the shards (`shard_bucket_windows`).

h_{l,j}(v) = floor((w_{l,j} . v + b_{l,j}) / r)   w ~ N(0,1)  (p=2 stable)
key_l(v)  = mix32(h_{l,1..m})                     (multiply-xor fold)

Keys are uint32 values held in int64 tensors, so that sorting them gives
the uint32 order the JAX package's tables have.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mix_fold, pinned_sum, to_uint32


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


class ShardedLSHTables(NamedTuple):
    """Shard-local LSH: one sorted key array per (shard, table). The
    projections are shared, so the per-shard tables partition the
    monolithic table's buckets exactly. Padded slots carry `PAD_KEY`
    (sorts last) and perm -1 (never returned as a hit)."""
    proj: torch.Tensor         # (L, m, d) f32, shared across shards
    bias: torch.Tensor         # (L, m) f32
    sorted_keys: torch.Tensor  # (S, L, cap) int64 uint32 values, ascending
    perm: torch.Tensor         # (S, L, cap) int64: sorted pos -> slot, -1 pad


PAD_KEY = 0xFFFFFFFF


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
    # analysis: allow(private-matmul): the salt projection recomputed beside the hash kernel, the twin of the pragma at repro/lsh/pstable.py:158
    z = (torch.einsum("nd,lmd->lnm", q.float(), proj.float())
         + bias.float()[:, None, :])
    return keys, _mix_fold(to_uint32(z.view(torch.int32)))


def spatial_score(v: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """(n,) projections of the rows of v:(n, d) onto `direction`:(d,), the
    order the stores shard by. Each row's d products are summed in the
    pinned order (`kernels.ref.pinned_sum`), so a row's score does not
    depend on the batch it is computed in: the sharded build's one pass
    and the streamed build's chunks give the same bits."""
    return pinned_sum(v.float() * direction.float())


def hash_chunk(chunk: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
               seg_len: float, backend: str = "auto"):
    """Bucket keys (L, m) and spatial score (m,) of ONE chunk of rows: the
    streamed store build hashes the dataset chunk by chunk through this,
    each chunk's keys and scores bit-equal to a whole-dataset pass."""
    return (hash_points(chunk, proj, bias, seg_len, backend),
            spatial_score(chunk, proj[0, 0]))


def shard_bucket_windows(sorted_keys: torch.Tensor, keys: torch.Tensor,
                         salts: torch.Tensor, probe: int):
    """Global probe budget: split one `probe`-wide window across shards.

    sorted_keys: (S, L, cap) per-shard tables; keys/salts: (L, Q) hashed
    queries. The GLOBAL bucket of a (table, query) is the concatenation of
    the per-shard buckets (shards partition the data and share hash
    functions), so one window of `probe` slots at the salted offset of
    `_query_one_table` is carved out of it and intersected with each
    shard's span: the shards together return min(global bucket, probe)
    members, the replicated engine's sample size. The offset is the JAX
    package's uint32 `salts % (span + 1)`, here on int64 holding the same
    values. Returns (starts, lo, hi), each (S, L, Q) int64: `starts` is the
    bucket head in the shard's sorted order; the shard reads local bucket
    positions [lo, hi)."""
    n_s, n_l, cap = sorted_keys.shape
    flat = sorted_keys.reshape(n_s * n_l, cap)
    q = keys.unsqueeze(0).expand(n_s, -1, -1).reshape(n_s * n_l, -1) \
        .contiguous()
    starts = torch.searchsorted(flat, q, side="left").reshape(n_s, n_l, -1)
    ends = torch.searchsorted(flat, q, side="right").reshape(n_s, n_l, -1)
    sizes = ends - starts
    total = sizes.sum(0)                                  # (L, Q)
    prefix = torch.cumsum(sizes, 0) - sizes               # members in shards < s
    span = torch.clamp_min(total - probe, 0)
    offset = salts % (span + 1)
    lo = torch.minimum(torch.clamp_min(offset[None] - prefix, 0), sizes)
    hi = torch.minimum(torch.clamp_min(offset[None] + probe - prefix, 0),
                       sizes)
    return starts, lo, hi


def shard_bucket_windows_host(sorted_keys, keys, salts, probe: int):
    """Numpy mirror of `shard_bucket_windows` for host-resident shard
    tables: sorted_keys (S, L, cap) uint32, keys/salts (L, Q) uint32.
    Integer for integer the device version's (and the JAX package's), so
    the streamed engine carves the same windows without shipping the key
    tables to the device. Returns (starts, lo, hi), each (S, L, Q) int32."""
    s_n, l_n, _ = sorted_keys.shape
    q_n = keys.shape[1]
    starts = np.empty((s_n, l_n, q_n), np.int64)
    ends = np.empty((s_n, l_n, q_n), np.int64)
    for s in range(s_n):
        for t in range(l_n):
            starts[s, t] = np.searchsorted(sorted_keys[s, t], keys[t], "left")
            ends[s, t] = np.searchsorted(sorted_keys[s, t], keys[t], "right")
    sizes = ends - starts
    total = sizes.sum(axis=0)                             # (L, Q)
    prefix = np.cumsum(sizes, axis=0) - sizes
    span = np.maximum(total - probe, 0)
    offset = (np.asarray(salts, np.uint32)
              % (span.astype(np.uint32) + np.uint32(1))).astype(np.int64)
    lo = np.clip(offset[None] - prefix, 0, sizes)
    hi = np.clip(offset[None] + probe - prefix, 0, sizes)
    return (starts.astype(np.int32), lo.astype(np.int32),
            hi.astype(np.int32))


def probe_tables_window(sorted_keys: torch.Tensor, perm: torch.Tensor,
                        keys: torch.Tensor, starts: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor,
                        probe: int) -> torch.Tensor:
    """Probe one shard's tables with explicit per-(table, query) windows
    from `shard_bucket_windows`: local bucket positions [lo, hi) of each
    bucket. sorted_keys/perm: (L, cap); keys/starts/lo/hi: (L, Q) ->
    (Q, L*probe) local slots, -1 = miss."""
    offs = torch.arange(probe, device=keys.device)
    pos = torch.clamp_max((starts + lo)[..., None] + offs,
                          sorted_keys.shape[1] - 1)          # (L, Q, probe)
    hit = ((lo[..., None] + offs) < hi[..., None]) & (
        torch.gather(sorted_keys, 1, pos.reshape(pos.shape[0], -1))
        .reshape(pos.shape) == keys[..., None])
    cands = torch.where(hit, torch.gather(perm, 1, pos.reshape(
        pos.shape[0], -1)).reshape(pos.shape), -1)
    return cands.permute(1, 0, 2).reshape(keys.shape[1], -1)


def build_lsh_sharded(shard_points: torch.Tensor, valid: torch.Tensor,
                      params: LSHParams, rng: torch.Tensor,
                      backend: str = "auto") -> ShardedLSHTables:
    """Shard-local tables over pre-partitioned points (S, cap, d).

    Consumes `rng` exactly like `build_lsh`, so the same key gives the same
    projections, and every point's keys are the monolithic build's: all
    S * cap rows are hashed in one `ops.lsh_hash` call, then reshaped. Pads
    get PAD_KEY; each (shard, table) is sorted stably."""
    n_s, cap, d = shard_points.shape
    proj, bias = make_projections(rng, params, d, shard_points.device)
    keys = hash_points(shard_points.reshape(n_s * cap, d), proj, bias,
                       params.seg_len, backend)                # (L, S*cap)
    keys = keys.reshape(-1, n_s, cap).permute(1, 0, 2)         # (S, L, cap)
    keys = torch.where(valid[:, None, :], keys, PAD_KEY)
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    sorted_valid = torch.gather(valid[:, None, :].expand_as(keys), -1, order)
    perm = torch.where(sorted_valid, order, -1)
    return ShardedLSHTables(proj=proj, bias=bias,
                            sorted_keys=sorted_keys.contiguous(),
                            perm=perm.contiguous())


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
