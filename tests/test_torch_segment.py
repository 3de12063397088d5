"""The port's `embedding_bag` and `segment_matmul` (ops, plain versions and
the kernels' layout) against the JAX package's `backend="ref"` oracles.

The plain versions sum each bag or segment in its rows' input order, in
f32, as the kernels do; XLA's `segment_sum` sums in its own order, so the
ops are held to rtol 1e-6, atol 1e-6 against JAX (measured bit-equal on
these inputs). Pads (-1) sit at the start, at the end and interspersed,
across many 128-row blocks: the placements at which the JAX Pallas
kernels' `align_segments` layout goes wrong (ROADMAP C) and the ref, which
the port computes, does not. What the kernels add around their CUDA sum
(`segment_layout`, `lane_plan`, the overflow bin) runs here on the CPU,
and a sequential sum over that layout must give the plain version's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.segment_matmul import lane_plan, segment_keys, \
    segment_layout

PLACEMENTS = ["none", "leading", "trailing", "interspersed", "unsorted"]
DTYPES = {"float32": (torch.float32, np.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, np.float32, jnp.bfloat16)}


def _segments(rng, e, n, placement, pad_share=0.2):
    """(E,) int32 segment ids in [0, n) with -1 pads at `placement`;
    ascending but for "unsorted"."""
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    n_pad = int(e * pad_share)
    if placement == "leading":
        seg = np.concatenate([np.full(n_pad, -1, np.int32), seg[n_pad:]])
    elif placement == "trailing":
        seg = np.concatenate([seg[:e - n_pad], np.full(n_pad, -1, np.int32)])
    elif placement == "interspersed":
        seg[rng.choice(e, n_pad, replace=False)] = -1
    elif placement == "unsorted":
        seg = rng.permutation(seg)
        seg[rng.choice(e, n_pad, replace=False)] = -1
    return seg


def _torch(a, dtype=None):
    t = torch.tensor(np.asarray(a, np.float32) if dtype else np.asarray(a))
    return t.to(dtype) if dtype else t


def _assert_close(got: torch.Tensor, want, dtype: str):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    else:   # both round the same f32 sums to bf16
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("e,n,d", [(1000, 257, 16), (6000, 1500, 100),
                                   (128, 1024, 8)])
def test_segment_matmul_matches_jax(e, n, d, placement, dtype):
    """Every pad placement over many 128-row blocks, d = 100 as
    ogb_products' messages; (128, 1024) leaves most rows and whole row
    blocks unvisited, which must be exactly 0."""
    tdt, _, jdt = DTYPES[dtype]
    rng = np.random.default_rng(e + n + d)
    seg = _segments(rng, e, n, placement)
    msg = rng.standard_normal((e, d)).astype(np.float32)
    msg[seg < 0] = np.nan             # pads are never read
    jmsg = jnp.asarray(msg, jdt)
    want = jref.segment_matmul_ref(jmsg, jnp.asarray(seg), n)
    tmsg = torch.tensor(np.asarray(jmsg.astype(jnp.float32))).to(tdt)
    got = ops.segment_matmul(tmsg, torch.tensor(seg), n)
    assert got.dtype == tdt and got.shape == (n, d)
    _assert_close(got, want, dtype)
    unvisited = np.setdiff1d(np.arange(n), seg[seg >= 0])
    assert bool((got[torch.tensor(unvisited)] == 0).all())


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_embedding_bag_matches_jax(placement, dtype, mode):
    """4,000 BST-like bags of 8 ids (dim 32) with pads at `placement` in
    the ids (the bag of a padded id is -1 too, as models/bst.py builds it),
    a share of all-pad (empty) bags, in both modes."""
    tdt, _, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    n_bags, bag, v, dim = 4000, 8, 700, 32
    idx = rng.integers(0, v, n_bags * bag).astype(np.int32)
    pads = _segments(rng, idx.size, 2, placement, pad_share=0.3) < 0
    idx[pads] = -1
    idx.reshape(n_bags, bag)[::17] = -1                  # empty bags
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), bag)
    if placement == "unsorted":
        order = rng.permutation(idx.size)
        idx, bags = idx[order], bags[order]
    bags = np.where(idx >= 0, bags, -1)
    table = jnp.asarray(rng.standard_normal((v, dim)), jdt)
    want = jref.embedding_bag_ref(table, jnp.asarray(idx), jnp.asarray(bags),
                                  n_bags, mode=mode)
    ttable = torch.tensor(np.asarray(table.astype(jnp.float32))).to(tdt)
    got = ops.embedding_bag(ttable, torch.tensor(idx), torch.tensor(bags),
                            n_bags, mode)
    assert got.dtype == tdt and got.shape == (n_bags, dim)
    _assert_close(got, want, dtype)
    assert bool((got[::17] == 0).all())


def test_skipped_entries_and_empty_inputs():
    """Negative ids and bags past n_bags are skipped, as pads are; an id
    past the table reads its last row (the JAX reference's gather clamps
    it) and counts in the mean; no rows give zeros of the right shape; a
    bad mode raises."""
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.standard_normal((10, 4)).astype(np.float32))
    idx = torch.tensor([0, 10, 3, -1, 2, 5], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 1, 3, 2], dtype=torch.int32)
    got = ops.embedding_bag(table, idx, bags, 3, "mean")
    want = torch.stack([(table[0] + table[9]) / 2, table[3], table[5]])
    assert torch.equal(got, want)
    jwant = jref.embedding_bag_ref(jnp.asarray(table.numpy()),
                                   jnp.asarray(idx.numpy()),
                                   jnp.asarray(bags.numpy()), 3, mode="mean")
    assert np.array_equal(got.numpy(), np.asarray(jwant))
    assert torch.equal(ops.segment_matmul(table, torch.full((10,), 7), 3),
                       torch.zeros(3, 4))
    empty = ops.embedding_bag(table, idx[:0], bags[:0], 5)
    assert torch.equal(empty, torch.zeros(5, 4))
    assert ops.segment_matmul(table[:0], idx[:0], 0).shape == (0, 4)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(table, idx, bags, 3, "max")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("placement", ["none", "interspersed", "unsorted"])
def test_embedding_bag_ids_past_the_table_match_jax(placement, dtype, mode):
    """Ids at and past the table's end (V, V + 5, 2**31 - 1 in int64)
    mixed among valid ids and pads: each reads the last row, as the JAX
    reference's gather clamps it, and counts in the mean."""
    tdt, _, jdt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    n_bags, bag, v, dim = 500, 8, 300, 16
    idx = rng.integers(0, v, n_bags * bag).astype(np.int64)
    idx[_segments(rng, idx.size, 2, placement, pad_share=0.2) < 0] = -1
    past = rng.choice(idx.size, idx.size // 10, replace=False)
    idx[past] = rng.choice([v, v + 5, 2 ** 31 - 1], past.size)
    bags = np.repeat(np.arange(n_bags, dtype=np.int64), bag)
    if placement == "unsorted":
        order = rng.permutation(idx.size)
        idx, bags = idx[order], bags[order]
    bags = np.where(idx >= 0, bags, -1)
    table = jnp.asarray(rng.standard_normal((v, dim)), jdt)
    want = jref.embedding_bag_ref(table, jnp.asarray(idx.astype(np.int32)),
                                  jnp.asarray(bags.astype(np.int32)),
                                  n_bags, mode=mode)
    ttable = torch.tensor(np.asarray(table.astype(jnp.float32))).to(tdt)
    for it in (torch.int64, torch.int32):
        got = ops.embedding_bag(ttable, torch.tensor(idx).to(it),
                                torch.tensor(bags).to(it), n_bags, mode)
        assert got.dtype == tdt and got.shape == (n_bags, dim)
        _assert_close(got, want, dtype)


def _layout_sum(rows: torch.Tensor, keys: torch.Tensor, n: int):
    """The kernels' arithmetic over their layout, one segment at a time:
    +0, then each listed row added in turn, in f32."""
    perm, bounds = segment_layout(keys, n)
    out = torch.zeros((n, rows.shape[1]))
    for s in range(n):
        acc = torch.zeros(rows.shape[1])
        for i in perm[bounds[s]:bounds[s + 1]].tolist():
            acc = acc + rows[i].float()
        out[s] = acc
    return out, perm, bounds


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_kernel_layout_gives_the_plain_bits(placement):
    """`segment_layout` lists each segment's rows in input order with
    every skipped row in the overflow bin; summing them in that order is
    the plain version, bit for bit (large values so that the order
    matters)."""
    rng = np.random.default_rng(5)
    e, n = 700, 90
    seg = torch.tensor(_segments(rng, e, n, placement))
    seg[::50] = n + 3                               # past the last segment
    msg = torch.tensor((rng.standard_normal((e, 6)) *
                        10.0 ** rng.integers(-3, 4, (e, 1))).astype(np.float32))
    keys = segment_keys(seg, n)
    assert keys.dtype == torch.int32
    got, perm, bounds = _layout_sum(msg, keys, n)
    assert torch.equal(got, tref.segment_matmul_ref(msg, seg, n))
    assert bounds[0] == 0 and bounds[-1] == int(((seg >= 0) & (seg < n)).sum())
    assert bool((keys[perm[bounds[-1]:]] == n).all())
    for s in range(n):                      # input order within a segment
        rows = perm[bounds[s]:bounds[s + 1]]
        assert bool((rows[1:] > rows[:-1]).all())
    keys64 = segment_keys(seg.long(), n)
    assert torch.equal(keys64, keys)


@pytest.mark.parametrize("d,es,ptr,want", [
    (32, 4, 0, (4, 8)),          # BST's dim: 8 lanes x 16 bytes a row
    (100, 4, 0, (4, 32)),        # ogb_products: 25 lanes, one warp
    (100, 2, 0, (4, 32)),        # bf16 rows of 200 bytes: 8-byte loads
    (32, 2, 0, (8, 4)),
    (6, 4, 0, (2, 4)),
    (7, 4, 0, (1, 8)),
    (32, 4, 8, (2, 16)),         # a base 8 bytes past 16-byte alignment
    (300, 4, 0, (4, 32)),        # past one pass: lanes loop over columns
])
def test_lane_plan(d, es, ptr, want):
    assert lane_plan(d, es, ptr) == want
