"""The schedule of the affinity kernels (`csrc/affinity.cu`) emulated step
for step in torch on the CPU, against the plain version `kernels.ref`
`affinity_ref` / `pinned_dot`, and the plans of the `affinity` and
`lsh_hash` kernels. Tolerance 0: outputs are compared bit for bit (each
float32 multiply and add below is one torch elementwise op, rounded on its
own, as the kernels' __fmul_rn / __fadd_rn are).

- The pack kernel: rows leaf-major ([l, c] = row[32 c + l], zeros past d)
  and |row|^2 as 32 running sums over all 4 ng chunks, then the halving
  tree.
- A quad's dots: thread s owns the leaves l = s mod 4, walked as two
  halves (l = s + 4h, then l + 16, l + 8, l + 24) folded on a two-deep
  stack; the xor shuffles 2 and 1 leave thread s with column s of the
  quad's 8 x 4 tile.
- The tile kernel: the tiles of a launch (all of them, or I <= J on the
  symmetric route), the warp blocks and quads that cover a tile once, and
  the stores, in place and (symmetric, I != J) transposed.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.affinity import SMEM_MAX, TILES
from repro_torch.kernels.affinity import plan as affinity_plan
from repro_torch.kernels.lsh_hash import PROBE_MAX_N
from repro_torch.kernels.lsh_hash import SMEM_MAX as LSH_SMEM_MAX
from repro_torch.kernels.lsh_hash import plan as lsh_plan

def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def pack(rows: torch.Tensor, pad: int):
    """pack_kernel: (r, d) -> leaf-major (pad, 32, 4 ng) rows, zero past d
    and past r, and their |row|^2."""
    r, d = rows.shape
    ng = -(-d // 128)
    full = torch.zeros((pad, 128 * ng))
    full[:r, :d] = rows
    lm = full.reshape(pad, 4 * ng, 32).transpose(1, 2)
    acc = lm[:, :, 0] * lm[:, :, 0]
    for c in range(1, 4 * ng):
        acc = acc + lm[:, :, c] * lm[:, :, c]
    return lm, ref._tree32(acc)


def leaf(a_lm, b_lm, l: int):
    """Running sum l of every (row, column) pair: the first chunk's
    product, then the other chunks' in turn."""
    acc = a_lm[:, None, l, 0] * b_lm[None, :, l, 0]
    for c in range(1, a_lm.shape[-1]):
        acc = acc + a_lm[:, None, l, c] * b_lm[None, :, l, c]
    return acc


def quad_subtree(a_lm, b_lm, s: int):
    """Thread s's subtree (leaves l = s mod 4) for every pair, as
    quad_subtree walks it."""
    lo = None
    for h in range(2):
        l = s + 4 * h
        st0 = leaf(a_lm, b_lm, l)
        st1 = st0 + leaf(a_lm, b_lm, l + 16)
        st0 = leaf(a_lm, b_lm, l + 8)
        half = st1 + (st0 + leaf(a_lm, b_lm, l + 24))
        if h == 0:
            lo = half
        else:
            v = lo + half
    return v


def quad_reduce(v):
    """compute_tile's shuffles over a quad's 8 x 4 tile: v[s][r][t] is
    thread s's subtree sum of pair (r, t). xor 2: thread s keeps the
    column pair 2 (s >> 1) + u and adds what its partner sends (its other
    pair); xor 1: it keeps column s. Returns, per thread, its 8 values and
    their column."""
    def keep2(s, r, u):
        return v[s][r][2 + u] if s & 2 else v[s][r][u]

    def send2(s, r, u):
        return v[s][r][u] if s & 2 else v[s][r][2 + u]
    w = [[[keep2(s, r, u) + send2(s ^ 2, r, u) for u in range(2)]
          for r in range(8)] for s in range(4)]

    def keep1(s, r):
        return w[s][r][1] if s & 1 else w[s][r][0]

    def send1(s, r):
        return w[s][r][0] if s & 1 else w[s][r][1]
    return [([keep1(s, r) + send1(s ^ 1, r) for r in range(8)], s)
            for s in range(4)]


def tile_dots(a_lm, b_lm):
    """Every (row, column) dot of a tile as the quads compute it: the
    four subtrees, then the xor levels (2, then 1)."""
    v = [quad_subtree(a_lm, b_lm, s) for s in range(4)]
    return (v[0] + v[2]) + (v[1] + v[3])


def affinity(a2, b2, dot, k: float):
    """common.cuh `affinity`: exp(-k sqrt(max((a2 + b2) - 2 dot, 0)))."""
    d2 = (a2 + b2) - 2.0 * dot
    return torch.sqrt(torch.clamp_min(d2, 0.0)).mul_(-k).exp_()


def tile_of(t: int, per_b: int, ti: int, tj: int, sym: bool):
    """affinity.cu `tile_of`: (batch entry, I, J) of tile t."""
    b, r = divmod(t, per_b)
    if not sym:
        return b, r // tj, r % tj
    tt = 2.0 * ti + 1.0
    i = int((tt - math.sqrt(tt * tt - 8.0 * r)) * 0.5)

    def off(x):
        return x * ti - x * (x - 1) // 2
    while i > 0 and off(i) > r:
        i -= 1
    while off(i + 1) <= r:
        i += 1
    return b, i, i + (r - off(i))


def tile_cover(bt: int):
    """compute_tile's (row, column) of each (warp, warp block, lane, r) of
    a bt x bt tile: the column lane s keeps after the shuffles."""
    wide = bt // 16
    seen = []
    for warp in range(8):
        for wb in range(warp, wide * wide, 8):
            for lane in range(32):
                s, quad = lane & 3, lane >> 2
                sub = quad >> 2
                r0 = 16 * (wb // wide)
                c0 = 16 * (wb % wide) + 4 * (quad & 3)
                for r in range(8):
                    row = r0 + 4 * sub + (r & 3) + 8 * (r >> 2)
                    seen.append((row, c0 + s))
    return seen


def emulate(v: torch.Tensor, c: torch.Tensor, k: float, bt: int,
            sym: bool) -> torch.Tensor:
    """The whole launch on the CPU: pack, the tiles of tile_of, each
    tile's dots and affinities, the stores (mirrored on the symmetric
    route). Entries no store reaches stay NaN."""
    m, n = v.shape[0], c.shape[0]
    ti, tj = -(-m // bt), -(-n // bt)
    qp, q2 = pack(v, ti * bt)
    cp, c2 = (qp, q2) if sym else pack(c, tj * bt)
    per_b = ti * (ti + 1) // 2 if sym else ti * tj
    out = torch.full((m, n), float("nan"))
    for t in range(per_b):
        _, i, j = tile_of(t, per_b, ti, tj, sym)
        rs, cs = slice(i * bt, i * bt + bt), slice(j * bt, j * bt + bt)
        a = affinity(q2[rs, None], c2[None, cs],
                     tile_dots(qp[rs], cp[cs]), k)
        rows, cols = min(bt, m - i * bt), min(bt, n - j * bt)
        out[i * bt:i * bt + rows, j * bt:j * bt + cols] = a[:rows, :cols]
        if sym and i != j:
            out[j * bt:j * bt + cols, i * bt:i * bt + rows] = \
                a[:rows, :cols].T
    return out


def _rows(rng, shape):
    """f32 rows over a wide range of magnitudes, with +-0 entries."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape)
    x[rng.uniform(size=shape) < 0.05] = 0.0
    x[rng.uniform(size=shape) < 0.05] = -0.0
    return torch.tensor(x.astype(np.float32))


@pytest.mark.parametrize("n", [1, 37, 64, 257, 300])
@pytest.mark.parametrize("d", [7, 100, 128])
def test_symmetric_route_equals_plain(n, d):
    """The symmetric route (tiles I <= J, off-diagonal tiles stored twice)
    gives affinity_ref's bits, with every entry stored."""
    rng = np.random.default_rng(n * 1000 + d)
    v = torch.tensor(rng.normal(size=(n, d)).astype(np.float32)) * 2.0
    k = 0.3 / math.sqrt(d)
    want = ref.affinity_ref(v, v, k)
    for bt in (affinity_plan(n, n, d, True).tile, 16):
        got = emulate(v, v, k, bt, sym=True)
        assert not bool(torch.isnan(got).any())
        assert bits_equal(got, want)
        assert bits_equal(got, got.T)


@pytest.mark.parametrize("m,n,d", [(1, 300, 7), (130, 257, 100),
                                   (240, 1, 128), (37, 64, 128),
                                   (20, 33, 256)])
def test_general_route_equals_plain(m, n, d):
    rng = np.random.default_rng(m + n + d)
    q = _rows(rng, (m, d))
    c = _rows(rng, (n, d))
    got = emulate(q, c, 0.02, 16, sym=False)
    assert bits_equal(got, ref.affinity_ref(q, c, 0.02))


@pytest.mark.parametrize("d", [7, 100, 128, 256])
def test_quad_leaf_split_equals_pinned_dot(d):
    """Four threads, each a residue class of the 32 leaves (two halves of
    four on a two-deep stack), then xor 2 and xor 1: thread s ends with
    column s of the 8 x 4 tile, equal to the pinned dot (and, where d
    adds no zero chunks, to its very bits)."""
    rng = np.random.default_rng(d)
    q, c = _rows(rng, (8, d)), _rows(rng, (4, d))
    q[0] = -torch.abs(q[0]) - 1.0   # a pair whose products are all -0
    c[0] = 0.0
    qp, q2 = pack(q, 8)
    cp, c2 = pack(c, 4)
    v = [quad_subtree(qp, cp, s) for s in range(4)]
    want = ref.pinned_dot(q, c)
    for vals, col in quad_reduce([[[v[s][r, t] for t in range(4)]
                                   for r in range(8)] for s in range(4)]):
        got = torch.stack(vals)
        assert torch.equal(got, want[:, col])
        assert bits_equal(q2 + c2[col] - 2.0 * got,
                          q2 + c2[col] - 2.0 * want[:, col])
        if d % 128 == 0:
            assert bits_equal(got, want[:, col])
    assert bits_equal(q2, ref.pinned_sum(q * q))


@pytest.mark.parametrize("bt", TILES)
def test_tile_is_covered_once(bt):
    seen = tile_cover(bt)
    assert len(seen) == len(set(seen)) == bt * bt
    assert {r for r, _ in seen} == set(range(bt))


@pytest.mark.parametrize("ti,tj,sym", [(1, 1, True), (5, 5, True),
                                       (625, 625, True), (4, 1, False),
                                       (3, 7, False)])
def test_tiles_of_a_launch(ti, tj, sym):
    per_b = ti * (ti + 1) // 2 if sym else ti * tj
    tiles = [tile_of(t, per_b, ti, tj, sym) for t in range(2 * per_b)]
    assert len(set(tiles)) == len(tiles)
    for b in range(2):
        mine = {(i, j) for bb, i, j in tiles if bb == b}
        want = {(i, j) for i in range(ti) for j in range(tj)
                if not sym or i <= j}
        assert mine == want


def test_affinity_plan_routes_and_tiles():
    # affinity_matrix's call at the full-matrix shape: q is c
    pl = affinity_plan(40_000, 40_000, 128, True)
    assert (pl.route, pl.tile, pl.stages, pl.ng, pl.ld) == \
        ("symmetric", 64, 2, 1, 132)
    assert pl.tiles == 625 * 626 // 2
    assert pl.smem == 4 * (2 * (2 * 64 * 132 + 128) + 64 * 65)
    pl = affinity_plan(40_000, 40_000, 128, False)
    assert (pl.route, pl.tiles) == ("general", 625 * 625)
    # a LID column (affinity_column) and a ragged block: general
    assert affinity_plan(240, 1, 128, False)[:3] == ("general", 64, 2)
    assert affinity_plan(3, 3, 128, False).route == "general"
    # wide rows: one stage, then smaller tiles
    assert affinity_plan(560, 1, 256, False)[1:3] == (64, 1)
    assert affinity_plan(5, 33, 700, False)[1:3] == (32, 1)
    assert affinity_plan(7, 9, 1792, False)[1:3] == (16, 1)
    for m, n, d in ((1, 1, 1), (65_537, 32_800, 16), (40_000, 40_000, 7)):
        assert affinity_plan(m, n, d, False).smem <= SMEM_MAX
    with pytest.raises(ValueError):
        affinity_plan(8, 8, 1793, False)
    with pytest.raises(ValueError):
        affinity_plan(8, 0, 16, False)


@pytest.mark.parametrize("n", [0, 1, 7, 3_584, 16_384, 16_385, 100_003,
                               1_000_000])
def test_lsh_plan_by_n(n):
    """The store build (10^6 points) takes the stream route, 128 points a
    block and 4 a thread; the CIVS probes (<= 3,584 support rows) the
    probe route, 32 points a block and one a thread: enough blocks to
    spread over the SMs. Two blocks of either fit an SM."""
    pl = lsh_plan(n, 128, 4, 8)
    assert 2 * pl.smem <= 232_448
    if n > PROBE_MAX_N:
        # 32 point groups x 8 projection groups of 4
        assert pl == ("stream", 128, 256, 4 * ((32 + 128) * 132 + 128 * 33))
    else:
        # 32 points x 8 projection groups of 4
        assert pl == ("probe", 32, 256, 4 * ((32 + 32) * 132 + 32 * 33))
    if n == 3_584:      # 112 blocks: one an SM of the H100's 132
        assert -(-n // pl.pts) == 112


def test_lsh_plan_other_widths():
    # ragged tables and widths keep the routes; threads follow the groups
    assert lsh_plan(100_003, 24, 3, 5)[:3] == ("stream", 128, 128)
    assert lsh_plan(777, 24, 3, 5)[:3] == ("probe", 32, 128)
    # wide points: fewer a block, then the probe route's, then no plan
    assert lsh_plan(1_000_000, 1_536, 4, 8)[:2] == ("stream", 4)
    assert lsh_plan(1_000, 1_600, 4, 8).pts < 32
    for n, d in ((1_000_000, 1_536), (1_000, 1_600), (5, 7)):
        assert lsh_plan(n, d, 4, 8).smem <= LSH_SMEM_MAX
    with pytest.raises(ValueError):
        lsh_plan(1_000_000, 2_000, 4, 8)
    with pytest.raises(ValueError):
        lsh_plan(10, 16, 1, 60_000)
