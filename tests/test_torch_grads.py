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
    jg = _jax_vjp(lambda a, b_, c: jref.attention_ref(a, b_, c, **kw),
                  (q, k, v), do)
    for name, m, a, j in zip(("dq", "dk", "dv"), mine, auto, jg):
        assert m.dtype == torch.float32 and m.shape == a.shape
        _rel_close(m.numpy(), a.numpy(), f"{name} vs autograd, {mask}")
        _rel_close(m.numpy(), np.asarray(j), f"{name} vs jax.vjp, {mask}")


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
