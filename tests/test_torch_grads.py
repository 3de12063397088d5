"""The plain backward versions that the port's backward kernels are held to
(`kernels.ref.attention_bwd_ref`, `segment_matmul_bwd_ref`,
`embedding_bag_bwd_ref`), against torch's autograd of the port's plain
forwards and against `jax.vjp` of the JAX package's `ref` ops, on inputs
drawn with numpy from a seed; and the three ops' gradients through
`ops.*` on the CPU (the plain route, which autograd differentiates).

Tolerances:
- attention, f32: each of dq, dk, dv within 2e-5 of its largest magnitude
  plus rtol 1e-4 (the explicit backward takes D = rowsum(dO o O) from the
  output, autograd from the softmax's own sums; the libraries order the
  products' sums apart).
- the segment sums' backward: equal to autograd's and to JAX's for
  segment_matmul (a gather); for embedding_bag equal where each table row
  sums one entry, else within rtol 1e-6 (JAX's scatter-add and the pinned
  input order may add in other orders).
The JAX package's gradient of embedding_bag drops ids at or past V (its
transpose of the clamped gather skips out-of-bounds rows), while the
forward reads them as row V - 1; the port follows and this file pins it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=5),
    "chunk": dict(causal=True, chunk=6),
    "softcap": dict(causal=True, softcap=3.0),
    "full": dict(causal=False),
}


def _jax_vjp(fn, primals, cotangent):
    """jax.vjp of fn at the primals for the cotangent, compiled as one
    program (eager dispatch would compile each op on its own)."""
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        tuple(jnp.asarray(x) for x in primals), jnp.asarray(cotangent))


def _rel_close(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(w).max()
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("mask,rep", [("causal", 1), ("window", 4),
                                      ("chunk", 8), ("softcap", 4),
                                      ("full", 1), ("causal", 8)])
def test_attention_bwd_ref_against_autograd_and_jax(mask, rep):
    """dq, dk, dv of attention_ref for every mask kind at GQA rep 1, 4, 8:
    the explicit plain backward, torch's autograd of the port's forward
    and jax.vjp of the JAX package's, on the same q, k, v and dO."""
    kw = MASKS[mask]
    rng = np.random.default_rng(11 + rep)
    b, hkv, s, dh = 2, 2, 13, 8
    h = hkv * rep
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in
                   ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh),
                    (b, h, s, dh)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tref.attention_ref(tq, tk, tv, **kw)
    out.backward(torch.tensor(do))
    auto = (tq.grad, tk.grad, tv.grad)
    mine = tref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                  out.detach(), torch.tensor(do), **kw)
    # with the lse given, as the wgmma forward keeps it for the backward
    lse = tref.attention_lse(tq.detach(), tk.detach(), **kw)
    with_lse = tref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      out.detach(), torch.tensor(do),
                                      lse=lse, **kw)
    jg = _jax_vjp(lambda a, b_, c: jref.attention_ref(a, b_, c, **kw),
                  (q, k, v), do)
    for name, m, m2, a, j in zip(("dq", "dk", "dv"), mine, with_lse, auto,
                                 jg):
        assert m.dtype == torch.float32 and m.shape == a.shape
        _rel_close(m.numpy(), a.numpy(), f"{name} vs autograd, {mask}")
        _rel_close(m.numpy(), np.asarray(j), f"{name} vs jax.vjp, {mask}")
        _rel_close(m2.numpy(), np.asarray(j),
                   f"{name} with lse vs jax.vjp, {mask}")


def test_attention_bwd_ref_blocks_and_bf16():
    """Rows taken in blocks give the unblocked result, and bf16 inputs give
    bf16 gradients within one bf16 ulp of the f32 computation's rounding
    of the same (bf16-rounded) inputs."""
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.tensor(rng.normal(size=(1, 4, 40, 8)).astype(
        np.float32)) for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    out = tref.attention_ref(q, k, v, window=9)
    whole = tref.attention_bwd_ref(q, k, v, out, do, window=9)
    blocks = tref.attention_bwd_ref(q, k, v, out, do, window=9, block_q=16)
    for a, b_ in zip(whole, blocks):
        _rel_close(b_.numpy(), a.numpy(), "blocked")
    h = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    o16 = tref.attention_ref(*h[:3], window=9)
    g16 = tref.attention_bwd_ref(*h[:3], o16, h[3], window=9)
    g32 = tref.attention_bwd_ref(*(t.float() for t in h[:3]), o16.float(),
                                 h[3].float(), window=9)
    for a, b_ in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b_.to(torch.bfloat16))


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("sk", [13, 6])
def test_attention_lse_is_the_masked_logsumexp(mask, sk):
    """attention_lse is torch.logsumexp of each row's scaled, capped,
    masked logits, +inf on a row that attends nothing (Sk = 6 < Sq = 13
    leaves the windowed and chunked rows past the keys empty), across
    query blocks; and attention_bwd_ref given it returns bitwise what it
    returns without it."""
    kw = MASKS[mask]
    rng = np.random.default_rng(31 + sk)
    b, hkv, rep, s, dh = 2, 2, 3, 13, 8
    q, do = (torch.tensor(rng.normal(size=(b, hkv * rep, s, dh)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(b, hkv, sk, dh)).astype(
        np.float32)) for _ in range(2))
    scale = dh ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q,
                          k.repeat_interleave(rep, 1)) * scale
    if kw.get("softcap"):
        logits = kw["softcap"] * torch.tanh(logits / kw["softcap"])
    m = tref.attention_mask(s, sk, causal=kw["causal"],
                            window=kw.get("window"), chunk=kw.get("chunk"))
    want = torch.logsumexp(logits.masked_fill(~m, float("-inf")), -1)
    empty = ~m.any(-1)
    want = torch.where(empty, float("inf"), want)
    for block_q in (1024, 4):
        got = tref.attention_lse(q, k, block_q=block_q, **kw)
        assert got.dtype == torch.float32 and got.shape == (b, hkv * rep, s)
        assert bool((got[:, :, empty] == float("inf")).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        out = tref.attention_ref(q, k, v, **kw)
        plain = tref.attention_bwd_ref(q, k, v, out, do, block_q=block_q,
                                       **kw)
        given = tref.attention_bwd_ref(q, k, v, out, do, block_q=block_q,
                                       lse=got, **kw)
        for a, b_ in zip(plain, given):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("dh,bf16,want", [
    (64, True, "wgmma"), (80, True, "wgmma"), (128, True, "wgmma"),
    (64, False, "tiles"), (80, False, "tiles"), (128, False, "tiles"),
    (256, True, "tiles"), (256, False, "tiles"), (96, True, "tiles")])
def test_bwd_plan_routes_by_dtype(dh, bf16, want):
    """The backward's plan: bf16 at dh 64 / 80 / 128 on the tensor cores
    ("wgmma"), f32 and the other head dims on the SIMT "tiles"; every
    plan's shared bytes within one block's SMEM_MAX; the wgmma dQ kernel
    takes the forward's query tiles."""
    from repro_torch.kernels import flash_attention as fa
    for h, hkv, s in ((32, 8, 5120), (32, 16, 4096), (40, 8, 9216),
                      (8, 1, 150), (4, 4, 77), (64, 1, 300)):
        pl = fa.bwd_plan(h, hkv, s, s, dh, bf16=bf16)
        assert pl.kernel == want
        assert 0 < pl.dq_smem <= fa.SMEM_MAX and \
            0 < pl.dkdv_smem <= fa.SMEM_MAX
        if want == "wgmma":
            hb, ppt, _ = fa.wgmma_plan(dh, h // hkv, s)
            assert (pl.hb, pl.ppt) == (hb, ppt)
            assert pl.rp == 64 * -(-(hb * ppt) // 64) and pl.rp <= 128
            assert pl.bk == fa.WGMMA_BWD_KEYS


@pytest.mark.parametrize("bf16", [True, False])
def test_bwd_plan_small_route_for_bst(bf16):
    """BST's 21 x 21 x 4 problems take the small route whatever the
    dtype."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.bwd_plan(8, 8, 21, 21, 4, bf16=bf16).kernel == "small"


def small_bwd_emulate(q, k, v, out, dout, plan, *, causal, window=None,
                      chunk=None, softcap=None, scale=None):
    """`flash_bwd_small_kernel` (csrc/flash_attention_bwd.cu) on the CPU,
    in its mapping and order: blocks of `plan.hb` (batch row, kv head)
    problems; phase 1 lays the flat (problem, query row) pairs over 256
    threads in rounds, each row forming its logits, max, e_j = exp(s_j -
    max) once, 1 / sum, P, dP, dS and dQ (dS K summed over the keys in
    order); phase 2 lays (problem, key) over the threads, each key forming
    P and dS again from the row's max and 1 / sum (the same operations)
    and summing dS Q and P dO over its kv head's query heads, then rows,
    in order. Each product and add is an f32 op of its own (the kernel
    fuses them: the rule below absorbs that). Returns (dq, dk, dv) and
    how often each query row and each key was taken."""
    from repro_torch.kernels.flash_attention import SMALL_BWD_THREADS
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep, rows, per = h // hkv, h // hkv * sq, plan.hb
    scale = dh ** -0.5 if scale is None else scale
    n = b * hkv
    qf = q.float().reshape(n, rows, dh)
    gf = dout.float().reshape(n, rows, dh)
    of = out.float().reshape(n, rows, dh)
    kf, vf = k.float().reshape(n, sk, dh), v.float().reshape(n, sk, dh)
    mask = tref.attention_mask(sq, sk, causal=causal, window=window,
                               chunk=chunk).repeat(rep, 1)      # (rows, sk)
    took_rows = torch.zeros((n, rows), dtype=torch.int64)
    took_keys = torch.zeros((n, sk), dtype=torch.int64)
    for blk in range(-(-n // per)):
        first = blk * per
        npb = min(per, n - first)
        for e0 in range(0, npb * rows, SMALL_BWD_THREADS):
            for e in range(e0, min(e0 + SMALL_BWD_THREADS, npb * rows)):
                took_rows[first + e // rows, e % rows] += 1
        for e in range(npb * sk):
            took_keys[first + e // sk, e % sk] += 1

    def dot(a, c):                     # the d-sum in order
        acc = torch.zeros(torch.broadcast_shapes(a.shape, c.shape)[:-1])
        for d in range(dh):
            acc = acc + a[..., d] * c[..., d]
        return acc

    def logit(x):
        x = x * scale
        return softcap * torch.tanh(x / softcap) if softcap else x

    def ds_of(pr, dp, dsum, s):
        ds = pr * (dp - dsum)
        if softcap:
            t = s / softcap
            ds = ds * (1.0 - t * t)
        return ds * scale

    # phase 1: every (problem, row) at once, the keys in order
    dsum = dot(gf, of)                                        # (n, rows)
    s_all = logit(dot(qf[:, :, None], kf[:, None]))          # (n, rows, sk)
    s = torch.where(mask, s_all, float("-inf"))
    mx = s.max(-1).values
    ev = torch.where(mask, torch.exp(s - mx[..., None]), 0.0)
    tot = torch.zeros_like(mx)
    for j in range(sk):
        tot = tot + ev[..., j]
    inv = torch.where(tot > 0, 1.0 / tot, 0.0)
    dq = torch.zeros_like(qf)
    for j in range(sk):
        pr = ev[..., j] * inv
        dp = dot(gf, vf[:, None, j])
        # softcap's factor reads the pair's logit, masked or not (P = 0)
        ds = ds_of(pr, dp, dsum, s_all[..., j])
        dq = dq + ds[..., None] * kf[:, None, j]
    # phase 2: every (problem, key) at once, the rows in order
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r in range(rows):
        on = mask[r][None, :, None]                             # (1, sk, 1)
        sr = logit(dot(kf, qf[:, None, r]))                     # (n, sk)
        pr = torch.exp(sr - mx[:, r, None]) * inv[:, r, None]
        dp = dot(vf, gf[:, None, r])
        ds = ds_of(pr, dp, dsum[:, r, None], sr)
        dk = torch.where(on, dk + ds[..., None] * qf[:, None, r], dk)
        dv = torch.where(on, dv + pr[..., None] * gf[:, None, r], dv)
    return ((dq.reshape(b, h, sq, dh), dk.reshape(b, hkv, sk, dh),
             dv.reshape(b, hkv, sk, dh)), took_rows, took_keys)


def _small_case(b, h, hkv, sq, sk, dh, kw, seed):
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(seed)
    q, dout = (torch.tensor(rng.normal(size=(b, h, sq, dh)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(b, hkv, sk, dh)).astype(
        np.float32)) for _ in range(2))
    out = tref.attention_ref(q, k, v, **kw)
    plan = fa.bwd_plan(h, hkv, sq, sk, dh)
    assert plan.kernel == "small"
    got, rows, keys = small_bwd_emulate(q, k, v, out, dout, plan, **kw)
    want = tref.attention_bwd_ref(q, k, v, out, dout, **kw)
    assert bool((rows == 1).all()) and bool((keys == 1).all())
    for g, w in zip(got, want):
        c = fa.compare_with_plain(
            g, w, torch.ones((b, g.shape[2]), dtype=torch.bool))
        assert c["bad"] == 0, c


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("dh", [1, 4, 8, 16])
@pytest.mark.parametrize("s", [1, 17, 21, 32])
def test_small_bwd_schedule_within_the_rule(s, dh, rep, causal):
    """The small route's lane mapping and summation order (emulated)
    against `attention_bwd_ref` by `compare_with_plain`'s f32 rule (|got -
    want| <= 1e-5 + 2e-5 |want|), every query row and key taken once, at
    Sq = Sk = 1, 17, 21, 32, dh 1 / 4 / 8 / 16, rep 1 and 2."""
    _small_case(3, 2 * rep, 2, s, s, dh, dict(causal=causal),
                seed=s * 100 + dh * 10 + rep + causal)


@pytest.mark.parametrize("b,h,hkv,sq,sk,dh,kw", [
    (3, 8, 8, 21, 21, 4, dict(causal=False)),              # BST
    (2, 4, 2, 17, 32, 8, dict(causal=True, window=5)),
    (2, 4, 4, 32, 17, 4, dict(causal=True, chunk=6)),
    (2, 4, 2, 21, 21, 16, dict(causal=True, softcap=3.0)),
    (1, 32, 2, 21, 21, 4, dict(causal=False)),             # rows in rounds
])
def test_small_bwd_schedule_masks_and_rounds(b, h, hkv, sq, sk, dh, kw):
    """The same at BST's shape, Sq != Sk under window and chunk masks,
    softcap, and rep x Sq past one block's 256 threads (rounds)."""
    _small_case(b, h, hkv, sq, sk, dh, kw, seed=sq * sk + dh + h)


def test_bwd_plan_small_blocks_and_bytes():
    """The small route's plan: 12 of BST's 21-row problems a block, each
    ~1.6 KB of shared memory (K, V, Q, dO at dh 4 and three floats a row);
    a problem whose rows outgrow a block's shared memory takes the tiles
    route."""
    from repro_torch.kernels import flash_attention as fa
    pl = fa.bwd_plan(8, 8, 21, 21, 4)
    assert (pl.kernel, pl.hb, pl.dq_smem) == ("small", 12, 12 * 4 * 400)
    assert fa.bwd_plan(2, 1, 32, 32, 16).hb == 4
    assert fa.bwd_plan(32, 2, 21, 21, 4).hb == 1
    assert fa.small_bwd_floats(1, 21, 21, 4) % 4 == 0
    big = fa.bwd_plan(1024, 1, 32, 32, 16)
    assert big.kernel == "tiles"
    assert fa.bwd_small_smem(1024, 32, 32, 16) > fa.SMEM_MAX


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_segment_matmul_bwd_ref_against_autograd_and_jax(dtype):
    """The messages' gradient is d_out gathered by segment, 0 for the -1
    pads and ids past n (which the forward skips): equal to autograd of the
    port's plain forward and to jax.vjp of the JAX package's."""
    rng = np.random.default_rng(31)
    n, e, d = 7, 40, 5
    seg = rng.integers(-1, n + 3, e).astype(np.int32)
    seg[:3] = -1
    msg = rng.normal(size=(e, d)).astype(np.float32)
    dout = rng.normal(size=(n, d)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tm = torch.tensor(msg).to(tdt).requires_grad_()
    tref.segment_matmul_ref(tm, torch.tensor(seg), n).backward(
        torch.tensor(dout).to(tdt))
    mine = tref.segment_matmul_bwd_ref(torch.tensor(dout).to(tdt),
                                       torch.tensor(seg), e)
    assert torch.equal(mine, tm.grad)
    tm2 = torch.tensor(msg).to(tdt).requires_grad_()
    ops.segment_matmul(tm2, torch.tensor(seg), n).backward(
        torch.tensor(dout).to(tdt))
    assert torch.equal(mine, tm2.grad)
    assert bool((mine[(seg < 0) | (seg >= n)] == 0).all())
    if dtype == np.float32:
        jg = _jax_vjp(lambda m: jref.segment_matmul_ref(
            m, jnp.asarray(seg), n), (msg,), dout)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(jg[0]))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_bwd_ref_against_autograd_and_jax(mode):
    """The table's gradient over bags with -1 pads and ids at and past V:
    each row the sum of the bags' gradients that name it (the mean's
    divided by the bag's count), ids past the table dropped as JAX drops
    them; against jax.vjp of the JAX package's plain EmbeddingBag, and
    against autograd of the port's where no id passes V (the port's plain
    forward reads such an id as row V - 1, so autograd would land it
    there)."""
    rng = np.random.default_rng(41)
    vrows, dim, nb, per = 9, 4, 6, 5
    table = rng.normal(size=(vrows, dim)).astype(np.float32)
    idx = rng.integers(-1, vrows + 2, nb * per).astype(np.int32)
    idx[[0, 7]] = [vrows, vrows + 3]             # past the table's end
    bags = np.repeat(np.arange(nb, dtype=np.int32), per)
    dout = rng.normal(size=(nb, dim)).astype(np.float32)
    mine = tref.embedding_bag_bwd_ref(torch.tensor(dout), torch.tensor(idx),
                                      torch.tensor(bags), vrows, mode)
    jg = _jax_vjp(lambda t: jref.embedding_bag_ref(
        t, jnp.asarray(idx), jnp.asarray(bags), nb, mode), (table,), dout)
    np.testing.assert_allclose(mine.numpy(), np.asarray(jg[0]),
                               rtol=1e-6, atol=1e-7)
    # no id past the table: autograd of the port's forward agrees
    ok = np.where(idx >= vrows, -1, idx)
    tt = torch.tensor(table, requires_grad=True)
    ops.embedding_bag(tt, torch.tensor(ok), torch.tensor(bags), nb,
                      mode).backward(torch.tensor(dout))
    want = tref.embedding_bag_bwd_ref(torch.tensor(dout), torch.tensor(ok),
                                      torch.tensor(bags), vrows, mode)
    np.testing.assert_allclose(want.numpy(), tt.grad.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_gather_rows_gradient_sums_by_index_in_order():
    """ops.gather_rows' table gradient is the segment sum of the rows'
    gradients by index (each id's rows in input order from +0), equal to
    torch's own indexing backward in f32 here, and the forward is plain
    indexing; without a graph it does not build one."""
    rng = np.random.default_rng(51)
    table = torch.tensor(rng.normal(size=(11, 3)).astype(np.float32),
                         requires_grad=True)
    idx = torch.tensor(rng.integers(0, 11, (4, 6)))
    g = torch.tensor(rng.normal(size=(4, 6, 3)).astype(np.float32))
    out = ops.gather_rows(table, idx)
    assert torch.equal(out, table.detach()[idx])
    out.backward(g)
    want = tref.segment_matmul_ref(g.reshape(-1, 3), idx.reshape(-1), 11)
    assert torch.equal(table.grad, want)
    t2 = table.detach().clone().requires_grad_()
    t2[idx].backward(g)
    np.testing.assert_allclose(table.grad.numpy(), t2.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        assert ops.gather_rows(table, idx).grad_fn is None
