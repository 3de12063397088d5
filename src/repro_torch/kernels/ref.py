"""Plain PyTorch versions of the kernels: the oracles every CUDA kernel is
checked against, and what `ops` runs for a tensor on the CPU.

Each function mirrors its twin in the JAX package's `kernels/ref.py` op for
op (same formulas, same masking conventions, same `MASK_VALUE` and -inf
sentinels), with one difference: where the JAX op was vmapped over a batch
of seeds, these take the batch as a leading tensor dimension.

Every sum that feeds the output of `roi_filter`, `affinity_matvec`,
`lid_sweep`, `assign` or `affinity` is taken in a PINNED order, so that a
CUDA kernel computing the same products in the same order gives the same
bits as its plain version on the card (an argmax near-tie in LID turns
any other rounding into other labels):

- `pinned_sum` (d-long sums: |v|^2, dots, pi, the ROI distance; and the
  assignment's per-cluster sum over the A supports): products rounded,
  then 32 running sums over the chunks of 32 (element t goes to sum
  t mod 32, chunk after chunk), then a halving tree over the 32;
- `tree_matvec` (the matvec's weighted sum): a halving tree over the
  zero-padded power of two, as the JAX package pins it;
- `segment_sum_ref` (`embedding_bag` and `segment_matmul`): each segment's
  rows added one after another in their input order, from +0, in f32.

Multiplies and adds stay separate operations (no fused multiply-add), in
both the plain versions and those kernels. The `lsh_hash` kernel sums in
its own order: its keys are integers, which differ only where a
projection lies within rounding of a bucket edge
(`kernels/lsh_hash.py` `key_flips`). `attention_ref` pins no order either:
the attention kernel's online softmax rounds otherwise than one softmax
over the whole row, and the two are held to a stated tolerance.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def tree_matvec(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n) with a FIXED binary-tree reduction order.

    The products are zero-padded to a power-of-two width and summed by
    halving, p[:half] + p[half:], exactly as the JAX package pins it, so
    equal products give bit-equal sums on every backend (the CUDA matvec
    reduces in shared memory in this same order)."""
    p = a.float() * w.float().unsqueeze(-2)
    n = p.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        p = torch.nn.functional.pad(p, (0, size - n))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


_LANES = 32


def _tree32(acc: torch.Tensor) -> torch.Tensor:
    """Halving tree over a last dim of 32: s[l] = s[l] + s[l + half]."""
    width = acc.shape[-1]
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc[..., 0]


def _pad32(t: torch.Tensor) -> torch.Tensor:
    d = t.shape[-1]
    dp = -(-d // _LANES) * _LANES
    return torch.nn.functional.pad(t, (0, dp - d)) if dp != d else t


def pinned_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the pinned order: zero-pad to a multiple of
    32, add the chunks of 32 in turn, then a halving tree over the 32."""
    p = _pad32(p)
    acc = p[..., :_LANES]
    for c in range(_LANES, p.shape[-1], _LANES):
        acc = acc + p[..., c:c + _LANES]
    return _tree32(acc)


def pinned_dot(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., m, d) x (..., n, d) -> (..., m, n) dots in the pinned order,
    without materializing the (..., m, n, d) products."""
    q, c = _pad32(q), _pad32(c)
    qe, ce = q.unsqueeze(-2), c.unsqueeze(-3)
    acc = qe[..., :_LANES] * ce[..., :_LANES]
    for k in range(_LANES, q.shape[-1], _LANES):
        acc = acc + qe[..., k:k + _LANES] * ce[..., k:k + _LANES]
    return _tree32(acc)


def _distance_rows(q32: torch.Tensor, c32: torch.Tensor, c2, p: float):
    """The (..., rows, n) distances of one block of query rows."""
    if p == 2.0:
        q2 = pinned_sum(q32 * q32).unsqueeze(-1)
        d2 = q2 + c2 - 2.0 * pinned_dot(q32, c32)
        return torch.sqrt(torch.clamp_min(d2, 0.0))
    diff = (q32.unsqueeze(-2) - c32.unsqueeze(-3)).abs()
    return diff.pow(p).sum(-1).pow(1.0 / p)


def pairwise_distance_ref(q: torch.Tensor, c: torch.Tensor,
                          p: float = 2.0) -> torch.Tensor:
    """||q_i - c_j||_p in f32: (..., m, d), (..., n, d) -> (..., m, n).

    p=2 uses the expansion |q|^2 + |c|^2 - 2 q c^T, clamped at 0, the form
    the kernels compute, with every d-sum in the pinned order; other p fall
    back to broadcast abs-power. Taken a block of q's rows at a time, so
    that the per-block products, (..., rows, n, 32) floats for p = 2 and
    (..., rows, n, d) otherwise, stay near `_DIST_ELEMS` and memory stays
    O(m n). Every entry is computed on its own, so the blocks change no
    bit of the result."""
    q32, c32 = q.float(), c.float()
    m, n, d = q32.shape[-2], c32.shape[-2], q32.shape[-1]
    lead = torch.broadcast_shapes(q32.shape[:-2], c32.shape[:-2])
    out = torch.empty((*lead, m, n), dtype=torch.float32, device=q.device)
    c2 = pinned_sum(c32 * c32).unsqueeze(-2) if p == 2.0 else None
    width = _LANES if p == 2.0 else max(d, 1)
    per_row = max(out[..., :1, :].numel() * width, 1)
    rows = max(1, _DIST_ELEMS // per_row)
    for lo in range(0, m, rows):
        out[..., lo:lo + rows, :] = _distance_rows(
            q32[..., lo:lo + rows, :], c32, c2, p)
    return out


# floats of one block's products in pairwise_distance_ref (256 MB)
_DIST_ELEMS = 1 << 26


def affinity_ref(q: torch.Tensor, c: torch.Tensor, k_scale: float,
                 p: float = 2.0) -> torch.Tensor:
    """exp(-k * ||q_i - c_j||_p): no diagonal logic. k is the fit's one
    f32 scale, as a Python float. The exp is taken in place, so the only
    (m, n) tensor is the result."""
    return pairwise_distance_ref(q, c, p).mul_(-k_scale).exp_().to(q.dtype)


def affinity_matvec_ref(q, q_idx, c, c_idx, w, k_scale,
                        p: float = 2.0) -> torch.Tensor:
    """out_i = sum_j [q_idx_i != c_idx_j] * exp(-k ||q_i - c_j||) * w_j.

    q:(..., m, d), q_idx:(..., m), c:(..., n, d), c_idx:(..., n),
    w:(..., n) -> (..., m) f32, contracted in `tree_matvec` order.

    The affinity is taken in f32 on the upcast rows and never rounded to
    q's dtype: the JAX Pallas kernel's semantics, which the CUDA kernel
    computes. (The JAX package's `affinity_matvec_ref` rounds the block to
    q's dtype first, so at bf16 storage its two backends differ, by up to
    ~4e-4 relative; at f32 the two forms are one.)"""
    a = pairwise_distance_ref(q, c, p).mul_(-k_scale).exp_()
    a = torch.where(q_idx.unsqueeze(-1) == c_idx.unsqueeze(-2), 0.0, a)
    return tree_matvec(a, w)


def roi_filter_ref(vc, center, radius, valid):
    """Fused ROI distance filter: the DIRECT per-row sqrt(sum((v - c)^2)).

    vc:(..., C, d), center:(..., d), radius:() or (...,), valid:(..., C) ->
    (dist f32, ok = valid & dist <= radius, neg = -dist where ok else -inf).
    """
    diff = vc.float() - center.float().unsqueeze(-2)
    dist = torch.sqrt(pinned_sum(diff * diff))
    r = torch.as_tensor(radius, dtype=torch.float32, device=dist.device)
    ok = valid & (dist <= (r.unsqueeze(-1) if r.dim() else r))
    neg = torch.where(ok, -dist, float("-inf"))
    return dist, ok, neg


def lid_sweep_ref(v_beta, beta_idx, beta_mask, x, ax, n_iters, converged,
                  k_scale, n_steps: int, max_iters: int, tol: float,
                  p: float = 2.0, refresh_every: int = 0,
                  support_eps: float = 1e-6):
    """Up to `n_steps` LID iterations (paper Sec. 4.1, Eq. 9-14) per seed.

    v_beta:(B, cap, d), beta_idx:(B, cap) int32, beta_mask:(B, cap) bool,
    x/ax:(B, cap) f32, n_iters:(B,) int32 (cumulative), converged:(B,) bool,
    k_scale: float -> (x, ax, n_iters, converged).

    The seeds are lanes with per-lane masks: each step runs for the whole
    batch, and a lane whose guard `~converged & n_iters < max_iters` is
    false (or whose step detected convergence) keeps its state unchanged,
    which is the semantics of the JAX package's vmap over this op.
    """
    v32 = v_beta.float()
    idx = beta_idx
    mask = beta_mask
    bsz, cap, _ = v32.shape
    x = x.float().clone()
    ax = ax.float().clone()
    it = n_iters.to(torch.int32).clone()
    cv = converged.clone()
    lanes = torch.arange(bsz, device=v32.device)
    slot = torch.arange(cap, device=v32.device)
    for _ in range(n_steps):
        live = (~cv) & (it < max_iters)
        if not bool(live.any()):
            break
        pi = pinned_sum(x * ax)
        r = torch.where(mask, ax - pi[:, None], 0.0)
        c1 = mask & (r > tol)
        c2 = mask & (r < -tol) & (x > 0.0)
        score = torch.where(c1 | c2, r.abs(), float("-inf"))
        i = torch.argmax(score, dim=-1)
        done = score[lanes, i] <= tol
        upd = live & ~done

        ri = r[lanes, i]
        xi = x[lanes, i]
        mu = torch.where(ri > 0.0, 1.0,
                         xi / torch.clamp_max(xi - 1.0, -1e-12))
        num = mu * ri
        den = mu * mu * (-2.0 * ax[lanes, i] + pi)
        eps = torch.where(den < 0.0, torch.clamp_max(-num / den, 1.0), 1.0)
        scale = (eps * mu)[:, None]
        vi = v32[lanes, i].unsqueeze(1)                       # (B, 1, d)
        col = affinity_ref(v32, vi, k_scale, p)[..., 0]       # (B, cap)
        col = torch.where(idx == idx[lanes, i][:, None], 0.0, col)
        col = torch.where(mask, col, 0.0)
        onehot = (slot[None, :] == i[:, None]).float()
        x_new = torch.clamp_min(x + scale * (onehot - x), 0.0)
        ax_new = ax + scale * (col - ax)
        if refresh_every > 0:
            hit = upd & ((it + 1) % refresh_every == 0)
            if bool(hit.any()):
                w = torch.where(mask & (x_new > support_eps), x_new, 0.0)
                full = affinity_matvec_ref(v32, idx, v32, idx, w, k_scale,
                                           p)
                full = torch.where(mask, full, 0.0)
                ax_new = torch.where(hit[:, None], full, ax_new)
        x = torch.where(upd[:, None], x_new, x)
        ax = torch.where(upd[:, None], ax_new, ax)
        it = torch.where(live, it + 1, it)
        cv = torch.where(live, done, cv)
    return x, ax, it, cv


def assign_ref(q, sup_v, sup_w, dens, k_scale: float, threshold: float,
               valid=None):
    """Fused cluster assignment (`Clustering.predict`, the serving layer):
    weighted support affinity, argmax over clusters, density threshold.

    q:(m, d), sup_v:(C, A, d), sup_w:(C, A), dens:(C,), valid:(m,) bool or
    None -> (labels (m,) int32, -1 = no cluster; best score (m,) f32):

        score[i, c] = sum_a w[c, a] exp(-k ||q_i - s_ca||)
        best[i]     = argmax_c score[i, c]  (first index on ties, NaN wins)
        label[i]    = best[i] if score[i, best] >= threshold * dens[best]
                      else -1

    The distance is the clamped expansion of `pairwise_distance_ref`, and
    the per-cluster sum over a is a segment sum in the `pinned_sum` order
    (32 running sums over a mod 32, then a halving tree), so the JAX
    package's (C*A, C) block-diagonal weight matrix is never built. Rows
    with valid False come out -1 with score 0.0; the others are bitwise
    the unmasked call's. k and threshold are f32 values as Python floats.
    The queries go through `pinned_dot` a few rows at a time, so its
    (rows, C*A, 32) products stay near `_ASSIGN_PAIRS` x 32 floats.
    """
    m, d = q.shape
    n_clusters, a_cap = sup_w.shape
    s = sup_v.float().reshape(n_clusters * a_cap, d)
    w = sup_w.float()
    q32 = q.float()
    q2 = pinned_sum(q32 * q32)
    s2 = pinned_sum(s * s)
    scores = torch.empty((m, n_clusters), dtype=torch.float32,
                         device=q.device)
    rows = max(1, _ASSIGN_PAIRS // max(n_clusters * a_cap, 1))
    for lo in range(0, m, rows):
        d2 = (q2[lo:lo + rows, None] + s2[None]
              - 2.0 * pinned_dot(q32[lo:lo + rows], s))
        aff = torch.exp(-k_scale * torch.sqrt(torch.clamp_min(d2, 0.0)))
        scores[lo:lo + rows] = pinned_sum(
            aff.reshape(-1, n_clusters, a_cap) * w)
    best = torch.argmax(scores, dim=-1)
    bscore = scores.gather(1, best[:, None])[:, 0]
    ok = bscore >= threshold * dens.float()[best]
    labels = torch.where(ok, best, -1).to(torch.int32)
    if valid is not None:
        labels = torch.where(valid, labels, -1)
        bscore = torch.where(valid, bscore, 0.0)
    return labels, bscore


# (query, support) pairs per block of assign_ref's queries
_ASSIGN_PAIRS = 1 << 21


def lsh_hash_ref(x, proj, bias, seg_len: float) -> torch.Tensor:
    """x:(n, d), proj:(L, m, d), bias:(L, m) -> (n, L) int32 key bits.

    f32 projection, floor(z / seg_len) with the f32-rounded seg_len, then
    the per-table multiply-xor fold (seed 0x811C9DC5, xor, times 0x9E3779B1
    mod 2**32, xor >> 15). The fold runs on int64 masked to 32 bits, since
    torch has no uint32 shift on the CPU; the result is handed back as the
    int32 with the same bits, as the JAX kernels return it. The projection
    is taken in the pinned order (the CUDA kernel's is its own), a block of
    rows at a time."""
    n_tables, n_proj, d = proj.shape
    w = proj.float().reshape(n_tables * n_proj, d)
    b = bias.float().reshape(n_tables * n_proj)
    seg = torch.full((), seg_len, dtype=torch.float32, device=x.device)
    out = torch.empty((x.shape[0], n_tables), dtype=torch.int32,
                      device=x.device)
    for lo in range(0, x.shape[0], _HASH_ROWS):
        z = pinned_dot(x[lo:lo + _HASH_ROWS].float(), w) + b
        h = torch.floor(z / seg).to(torch.int64) & 0xFFFFFFFF
        out[lo:lo + _HASH_ROWS] = mix_fold(h.reshape(-1, n_tables, n_proj))
    return out


# rows hashed per block by lsh_hash_ref: bounds its (rows, L*m, 32) products
_HASH_ROWS = 1 << 15


def mix_fold(h: torch.Tensor) -> torch.Tensor:
    """Fold (..., m) lattice words (int64 in [0, 2**32)) into (...,) int32
    key bits: the multiply-xor fold that the JAX package's `_mix_fold` and
    LSH kernels share."""
    acc = torch.full(h.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                     device=h.device)
    for j in range(h.shape[-1]):
        acc = mul32(acc ^ h[..., j], 0x9E3779B1)
        acc = acc ^ (acc >> 15)
    return to_int32_bits(acc)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a * b mod 2**32 for int64 words in [0, 2**32), without overflowing
    int64: the product is split on b's 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def to_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 -> the int32 with the same 32 bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def to_uint32(a: torch.Tensor) -> torch.Tensor:
    """int32 key bits -> int64 holding the uint32 value (sorts in uint32
    order)."""
    return a.to(torch.int64) & 0xFFFFFFFF


# ------------------------------------------------------- flash attention --
def _pad_mask(q_offset: int, kv_start: torch.Tensor, sq: int, sk: int):
    """Positions of a LEFT-padded serving batch: kv_start (B,) is the number
    of pad slots at the front of each row's kv timeline. Returns (qpos,
    kpos, mask) in LOGICAL positions (slot - kv_start), (B, Sq, 1) and
    (B, 1, Sk), with the pad kv slots masked out: window and chunk masks
    are not shift-invariant, so they must see logical positions for a
    packed short prompt to match its solo run."""
    dev = kv_start.device
    start = kv_start.to(torch.int64)[:, None, None]
    qpos = (q_offset + torch.arange(sq, device=dev))[None, :, None] - start
    kpos = torch.arange(sk, device=dev)[None, None, :] - start
    return qpos, kpos, kpos >= 0


def attention_mask(sq: int, sk: int, q_offset: int = 0, kv_start=None, *,
                   causal: bool = True, window=None, chunk=None,
                   device="cpu") -> torch.Tensor:
    """The attended (query, key) pairs: (Sq, Sk) bool, or (B, Sq, Sk) with
    `kv_start`. Chunk indices are floor divisions, as `//` is in JAX."""
    if kv_start is None:
        qpos = (q_offset + torch.arange(sq, device=device))[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    else:
        qpos, kpos, mask = _pad_mask(q_offset, kv_start, sq, sk)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if chunk is not None:
        mask = mask & ((kpos // chunk) == (qpos // chunk))
    return mask


def _attention_block(q, k, v, *, causal, window, chunk, softcap, q_offset,
                     scale, kv_start):
    """One dense block: q (B, H, Sq, dh) against the whole kv, with kv kept
    at Hkv heads (q head h reads kv head h // rep)."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    qr = q.reshape(b, hkv, rep * sq, dh).float()
    logits = torch.matmul(qr, k.float().transpose(-1, -2)) * scale
    logits = logits.view(b, hkv, rep, sq, sk)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(sq, sk, q_offset, kv_start, causal=causal,
                          window=window, chunk=chunk, device=q.device)
    mask = mask[None, None, None] if kv_start is None else mask[:, None, None]
    logits.masked_fill_(~mask, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).view(b, hkv, rep * sq, sk)
    del logits
    out = torch.matmul(probs, v.float())
    return out.view(b, h, sq, dh).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True, window=None, chunk=None,
                  softcap=None, q_offset: int = 0, scale=None,
                  block_q: int = 1024, flat_gqa: bool = True, kv_start=None):
    """Attention of q (B, H, Sq, dh) over k, v (B, Hkv, Sk, dh), in f32,
    the result in q's dtype: logits * scale (dh**-0.5 by default), softcap
    before the mask, causal / window / chunk masks in logical positions
    with `kv_start` ((B,) int or None: row i's kv slots [0, kv_start[i])
    are pad, never attended), masked logits MASK_VALUE, one softmax over
    the row. A row with no attended key therefore comes out as the uniform
    average of V, as in the JAX package's `attention_ref` (its Pallas
    kernel writes 0 there).

    Long sequences are scanned in q blocks of `block_q` where Sq is a
    multiple of it, as the JAX function does, so live logits are
    (B, H, block_q, Sk). `flat_gqa` is accepted for the JAX signature: its
    two branches (kv repeated to H heads, or q grouped by kv head) compute
    the same products, and this function always groups."""
    b, h, sq, dh = q.shape
    scale = (dh ** -0.5) if scale is None else scale
    kw = dict(causal=causal, window=window, chunk=chunk, softcap=softcap,
              scale=scale, kv_start=kv_start)
    if sq <= block_q or sq % block_q != 0:
        return _attention_block(q, k, v, q_offset=q_offset, **kw)
    return torch.cat([
        _attention_block(q[:, :, i:i + block_q], k, v, q_offset=q_offset + i,
                         **kw) for i in range(0, sq, block_q)], dim=2)


def attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                      window=None, chunk=None, softcap=None, scale=None,
                      block_q: int = 1024):
    """The backward of `attention_ref` (q_offset 0, no kv_start: training's
    calls), written out: (dq, dk, dv) in q's dtype, computed in f32 from
    q, k, v, the forward's output `out` and its gradient `dout`. With S
    the logits after scale and softcap, masked pairs excluded, P = exp(S -
    lse), D = rowsum(dout o out),
        dP = dout V^T, dS = P o (dP - D) o (1 - (S / c)^2 under softcap c),
        dq = scale dS K, dk = scale sum_rep dS^T Q, dv = sum_rep P^T dout,
    dk and dv summed over each kv head's query heads. This is the plain
    version the backward kernels (`csrc/flash_attention_bwd.cu`) are held
    to; torch's autograd of `attention_ref` computes the same function
    (D from the softmax's own output). Rows of q are taken `block_q` at a
    time, so the live logits are (B, H, block_q, Sk). A row that attends
    nothing gets P = 0 here (the kernel's 0 output), not the plain
    forward's uniform average."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = (dh ** -0.5) if scale is None else scale
    kf, vf = k.float(), v.float()
    dk = torch.zeros((b, hkv, sk, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for i in range(0, sq, block_q):
        n = min(block_q, sq - i)
        qb = q[:, :, i:i + n].float().reshape(b, hkv, rep * n, dh)
        ob = dout[:, :, i:i + n].float()
        dsum = (ob * out[:, :, i:i + n].float()).sum(-1)
        ob = ob.reshape(b, hkv, rep * n, dh)
        s = torch.matmul(qb, kf.transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s.view(b, hkv, rep, n, sk)
        mask = attention_mask(n, sk, i, causal=causal, window=window,
                              chunk=chunk, device=q.device)
        s = s.masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dp = torch.matmul(ob, vf.transpose(-1, -2)).view(b, hkv, rep, n, sk)
        ds = p * (dp - dsum.view(b, hkv, rep, n, 1))
        if softcap is not None:
            t = torch.where(mask, s / softcap, 0.0)
            ds = ds * (1.0 - t * t)
        ds = (ds * scale).view(b, hkv, rep * n, sk)
        p = p.view(b, hkv, rep * n, sk)
        dq[:, :, i:i + n] = torch.matmul(ds, kf).view(b, h, n, dh)
        dk += torch.matmul(ds.transpose(-1, -2), qb)
        dv += torch.matmul(p.transpose(-1, -2), ob)
        del s, p, dp, ds
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ------------------------------------------- segment sums: bags, messages --
def segment_sum_ref(rows, seg: torch.Tensor, valid: torch.Tensor, n: int,
                    d: int, mean: bool = False) -> torch.Tensor:
    """(n, d) f32 sums of rows into segments, in the pinned order that the
    `embedding_bag` and `segment_matmul` kernels share: segment s starts
    at +0 and adds, one after another, the rows e with valid[e] and
    seg[e] == s, in the order of e. `rows(e)` gives those rows ((k,) int64
    -> (k, d)), read only where valid. Empty segments are 0; `mean`
    divides each sum by max(count, 1).

    Step r adds the r-th row of every segment that has more than r rows,
    so each step writes each segment at most once (an exact elementwise
    add) and there are as many steps as the largest segment has rows."""
    pos = torch.nonzero(valid).flatten()                 # rows in input order
    keys = seg[pos].to(torch.int64)
    order = torch.argsort(keys, stable=True)
    keys, pos = keys[order], pos[order]                  # by segment, stable
    counts = torch.bincount(keys, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(keys.numel(), device=keys.device) - starts[keys]
    by_rank = torch.argsort(rank, stable=True)
    per_rank = torch.bincount(rank).tolist()
    out = torch.zeros((n, d), dtype=torch.float32, device=seg.device)
    lo = 0
    for k in per_rank:
        sel = by_rank[lo:lo + k]
        lo += k
        s = keys[sel]
        out[s] = out[s] + rows(pos[sel]).float()
    if mean:
        out = out / counts.clamp(min=1).float()[:, None]
    return out


def segment_matmul_ref(msg: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """sum_e msg[e] into row seg_ids[e] of an (n_segments, d) result in
    msg's dtype, accumulated in f32. Ids outside [0, n_segments) (the -1
    pads, wherever they sit) are dropped; their rows are never read. As
    the JAX package's `segment_matmul_ref`, in the order of
    `segment_sum_ref`."""
    seg = seg_ids.to(torch.int64)
    valid = (seg >= 0) & (seg < n_segments)
    out = segment_sum_ref(lambda e: msg[e], seg, valid, n_segments,
                          msg.shape[1])
    return out.to(msg.dtype)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      bag_ids: torch.Tensor, n_bags: int,
                      mode: str = "sum") -> torch.Tensor:
    """Rows table[idx[e]] summed (or averaged, `mode="mean"`) into bag
    bag_ids[e]: (n_bags, dim) in the table's dtype, accumulated in f32. An
    entry is skipped where idx is negative (the -1 pads, wherever they
    sit) or its bag is outside [0, n_bags); an id at or past the table's
    end reads its last row, as the JAX package's gather clamps it; empty
    bags are 0, and the mean divides by the number of entries not skipped.
    As the JAX package's `embedding_bag_ref`, in the order of
    `segment_sum_ref`."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    idx = idx.to(torch.int64).clamp(max=table.shape[0] - 1)
    bags = bag_ids.to(torch.int64)
    valid = (idx >= 0) & (bags >= 0) & (bags < n_bags)
    out = segment_sum_ref(lambda e: table[idx[e]], bags, valid, n_bags,
                          table.shape[1], mean=mode == "mean")
    return out.to(table.dtype)


def segment_matmul_bwd_ref(d_out: torch.Tensor, seg_ids: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The gradient of `segment_matmul_ref`'s messages: (n_rows, d) in
    d_out's dtype, row e = d_out[seg_ids[e]] where the id lies in [0,
    n_segments), 0 for the rows the forward skipped."""
    n = d_out.shape[0]
    seg = seg_ids.to(torch.int64)
    valid = (seg >= 0) & (seg < n)
    if n == 0:
        return d_out.new_zeros((int(n_rows), d_out.shape[1]))
    return d_out[seg.clamp(0, n - 1)].masked_fill_(~valid[:, None], 0)


def embedding_bag_bwd_ref(d_out: torch.Tensor, idx: torch.Tensor,
                          bag_ids: torch.Tensor, v_rows: int,
                          mode: str = "sum") -> torch.Tensor:
    """The gradient of `embedding_bag_ref`'s table: (v_rows, dim) in
    d_out's dtype. Row v sums d_out[bag_ids[e]] in f32 (divided by the
    bag's count, at least 1, for `mode="mean"`) over the entries the
    forward read (id >= 0, bag in [0, n_bags)) whose id is v; an id at or
    past v_rows (read as the last row by the forward) adds nothing, as in
    the JAX package, whose transpose of the clamped gather skips
    out-of-bounds rows; in the order of `segment_sum_ref` (each row from
    +0, its entries in input order), rounded once. Rows no entry names are
    0."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    n_bags = d_out.shape[0]
    ids = idx.to(torch.int64)
    bags = bag_ids.to(torch.int64)
    read = (ids >= 0) & (bags >= 0) & (bags < n_bags)
    g = d_out.float()
    if mode == "mean":
        cnt = torch.bincount(torch.where(read, bags, n_bags),
                             minlength=n_bags + 1)[:n_bags]
        g = g / cnt.clamp(min=1).float()[:, None]
    out = segment_sum_ref(lambda e: g[bags[e]], ids, read & (ids < v_rows),
                          v_rows, d_out.shape[1])
    return out.to(d_out.dtype)
