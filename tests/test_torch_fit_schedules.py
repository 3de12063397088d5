"""The summation schedules of the fit kernels `csrc/affinity_matvec.cu` and
`csrc/lid_sweep.cu`, emulated step for step in torch on the CPU, against
the pinned orders of `repro_torch.kernels.ref` that the kernels claim to
reproduce. Tolerance 0: outputs are compared bit for bit (`bits_equal`);
a dot of a ragged d may differ from `pinned_dot` only in the sign of a
zero (below). Each float32 multiply and add below is one torch elementwise
op, rounded on its own, as the kernels' __fmul_rn / __fadd_rn are.

- A dot's 32 running sums (lane l: the products at t = l, l+32, ...) are
  read from LEAF-MAJOR rows ([l, c] = row[32 c + l], zeros past d), over
  all 4 ceil(ceil(d / 32) / 4) chunks: the zero chunks past d add +0, which
  can turn a -0 sum into +0 and nothing else, and the distance
  (|a|^2 + |b|^2) - 2 dot is the same for either zero.
- Leaves met in bit-reversed order and folded on a stack (merge with the
  completed left siblings, as many as the leaf's number has trailing one
  bits) give the halving tree's sum: `_tree32` and `tree_matvec`.
- The leaves l = t mod 4 form a complete subtree of the 32-leaf tree; two
  xor shuffles (2, 1) over the four threads finish it (lid_sweep's quads).
- The columns j = r mod G of `tree_matvec`'s tree form complete subtrees,
  met four at a time; xor shuffles G/2 .. 1 finish it (affinity_matvec).
- lid_sweep's argmax key orders scores as torch.argmax does.

The plans that pick these schedules (`affinity_matvec.plan`,
`lid_sweep.plan`) are checked here too, and so are `csrc/roi_filter.cu`'s
ring route (chunks of rows through shared-memory stages, 8 rows a warp
reduced by a reduce-scatter over the lanes) and `roi_filter.plan`.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.affinity_matvec import MAX_N, column_classes, \
    leaf_groups
from repro_torch.kernels.affinity_matvec import plan as matvec_plan
from repro_torch.kernels.lid_sweep import plan as sweep_plan
from repro_torch.kernels import roi_filter as roi


def bitrev(p: int, bits: int) -> int:
    return int(format(p, f"0{bits}b")[::-1], 2) if bits else 0


def trailing_ones(p: int) -> int:
    n = 0
    while p & 1:
        n, p = n + 1, p >> 1
    return n


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def chunks(d: int) -> int:
    """The chunks a kernel adds for each leaf: all of the float4 groups."""
    return 4 * leaf_groups(d)


def fold(leaves):
    """The halving tree over 2^D leaves met in bit-reversed order, on a
    stack: leaf p merges with the completed left siblings (stack[0] first)
    and is pushed at the depth of its trailing one bits."""
    stack = {}
    for p, v in enumerate(leaves):
        merges = trailing_ones(p)
        for lvl in range(merges):
            v = stack[lvl] + v
        stack[merges] = v
    return stack[len(leaves).bit_length() - 1]


def leaf_major(rows: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., 32, 4 ng): [l, c] = row[32 c + l], zero past d."""
    d = rows.shape[-1]
    ng = leaf_groups(d)
    padded = torch.nn.functional.pad(rows, (0, 128 * ng - d))
    return padded.reshape(*rows.shape[:-1], 4 * ng, 32).transpose(-1, -2)


def leaf_sum(a_lm, b_lm, l: int, nch: int):
    """Running sum l: chunk 0's product, then chunks 1 .. nch-1 in turn."""
    acc = a_lm[..., l, 0] * b_lm[..., l, 0]
    for c in range(1, nch):
        acc = acc + a_lm[..., l, c] * b_lm[..., l, c]
    return acc


def walk32(a_lm, b_lm, nch: int):
    """affinity_matvec's dot: the 32 leaves in bit-reversed order, folded
    on a stack (the kernel's four quarters of eight leaves, l = brev2(qq)
    mod 4, are this sequence's complete subtrees)."""
    return fold([leaf_sum(a_lm, b_lm, bitrev(p, 5), nch) for p in range(32)])


def quad_dot(a_lm, b_lm, nch: int):
    """lid_sweep's dot: thread t of a quad folds its leaves l = t + 4u
    (u in bit-reversed order) on a 3-deep stack; then v += shfl_xor(v, 2),
    v += shfl_xor(v, 1). Returns the four threads' results."""
    v = [fold([leaf_sum(a_lm, b_lm, t + 4 * bitrev(p, 3), nch)
               for p in range(8)]) for t in range(4)]
    v = [v[t] + v[t ^ 2] for t in range(4)]
    return [v[t] + v[t ^ 1] for t in range(4)]


def quad_sq(rows):
    """|row|^2 by a quad (lid_sweep's |v|^2, affinity_matvec's |q|^2 and
    |c|^2): the quad schedule on the row and itself."""
    lm = leaf_major(rows)
    return quad_dot(lm, lm, chunks(rows.shape[-1]))


def class_schedule(prod: torch.Tensor, n: int):
    """affinity_matvec's j-sum of prod (..., n): thread r of a row group
    owns the columns j = r + G u, meets them in bit-reversed order of u tc
    at a time (summed as a subtree), folds the groups on a stack, then the
    xor shuffles G/2 .. 1. Returns the 16 threads' values."""
    g_cls, u, tc = column_classes(n)
    ubits = u.bit_length() - 1
    zero = torch.zeros(prod.shape[:-1])
    lanes = []
    for r in range(16):
        sums = []
        for grp in range(u // tc):
            ps = []
            for tt in range(tc):
                j = r + g_cls * bitrev(grp * tc + tt, ubits)
                ps.append(prod[..., j] if r < g_cls and j < n else zero)
            if tc == 4:
                sums.append((ps[0] + ps[1]) + (ps[2] + ps[3]))
            elif tc == 2:
                sums.append(ps[0] + ps[1])
            else:
                sums.append(ps[0])
        lanes.append(fold(sums))
    off = g_cls // 2
    while off:
        lanes = [lanes[r] + lanes[r ^ off] for r in range(16)]
        off //= 2
    return lanes


def _rows(rng, shape, zeros=True):
    """f32 rows over a wide range of magnitudes, with +-0 entries, so that
    any other order of the adds would round differently."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, size=shape)
    if zeros:
        x[rng.uniform(size=shape) < 0.05] = 0.0
        x[rng.uniform(size=shape) < 0.05] = -0.0
    return torch.tensor(x.astype(np.float32))


def _dot_rows(rng, n, d):
    """Rows of wide magnitudes with +-0 entries, and a pair whose products
    are all -0 (a negative row against a zero row): a dot of -0."""
    a, b = _rows(rng, (n, d)), _rows(rng, (n, d))
    a[0] = -torch.abs(a[0]) - 1.0
    b[0] = 0.0
    return a, b


def _distance_bits_equal(dot, want, a2, b2):
    """The dots agree in value (a zero's sign aside) and the distances
    (|a|^2 + |b|^2) - 2 dot agree bit for bit."""
    assert torch.equal(dot, want)
    assert bits_equal(a2 + b2 - 2.0 * dot, a2 + b2 - 2.0 * want)


@pytest.mark.parametrize("d", [16, 96, 100, 128, 256])
def test_quad_residue_subtrees_equal_pinned_dot(d):
    rng = np.random.default_rng(d)
    a, b = _dot_rows(rng, 40, d)
    want = ref.pinned_dot(a, b).diagonal()
    got = quad_dot(leaf_major(a), leaf_major(b), chunks(d))
    a2, b2 = ref.pinned_sum(a * a), ref.pinned_sum(b * b)
    for lane in got:
        _distance_bits_equal(lane, want, a2, b2)
        if d % 128 == 0:          # no zero chunks: the very bits
            assert bits_equal(lane, want)
    # the leaf-major rows hold every element once, zeros past d
    lm = leaf_major(a)
    assert torch.equal(lm[..., :, :-(-d // 32)].transpose(-1, -2)
                       .reshape(40, -1)[:, :d], a)


@pytest.mark.parametrize("d", [16, 96, 100, 128, 256])
def test_register_tile_walk_equals_pinned_dot(d):
    rng = np.random.default_rng(100 + d)
    q, c = _dot_rows(rng, 12, d)
    c = c[:9]
    got = walk32(leaf_major(q)[:, None], leaf_major(c)[None], chunks(d))
    want = ref.pinned_dot(q, c)
    _distance_bits_equal(got, want, ref.pinned_sum(q * q)[:, None],
                         ref.pinned_sum(c * c)[None, :])
    if d % 128 == 0:
        assert bits_equal(got, want)
    for lane in quad_sq(q):
        assert bits_equal(lane, ref.pinned_sum(q * q))


@pytest.mark.parametrize("leaves", [1, 2, 8, 32, 256])
def test_bit_reversed_stack_equals_halving_tree(leaves):
    rng = np.random.default_rng(leaves)
    acc = _rows(rng, (64, leaves))
    bits = leaves.bit_length() - 1
    got = fold([acc[:, bitrev(p, bits)] for p in range(leaves)])
    if leaves == 32:
        assert bits_equal(got, ref._tree32(acc))
    assert bits_equal(got, ref.tree_matvec(acc[:, None, :],
                                           torch.ones(64, leaves))[:, 0])


@pytest.mark.parametrize("n", [240, 112, 200, 37, 560, 16, 9, 5, 3, 2, 1])
def test_column_classes_equal_tree_matvec(n):
    rng = np.random.default_rng(n)
    prod = _rows(rng, (24, n))
    want = ref.tree_matvec(prod, torch.ones(n))
    lanes = class_schedule(prod, n)
    g_cls = column_classes(n)[0]
    for r in range(g_cls):
        assert bits_equal(lanes[r], want)


@pytest.mark.parametrize("m,n,d", [(240, 240, 128), (240, 112, 128),
                                   (30, 200, 100), (5, 37, 16)])
def test_matvec_schedule_equals_plain(m, n, d):
    """The whole affinity_matvec kernel emulated: |q|^2, |c|^2 by quads,
    dots by the register tile's walk, the plain version's elementwise
    formula, the class schedule of the j-sum."""
    rng = np.random.default_rng(m + n + d)
    q = torch.tensor(rng.normal(size=(m, d)).astype(np.float32))
    half = min(m, n // 2)   # columns equal to rows: distance 0
    c = torch.cat([q[:half], torch.tensor(
        rng.normal(size=(n - half, d)).astype(np.float32))])
    q_idx = torch.arange(m, dtype=torch.int32)
    c_idx = torch.arange(n, dtype=torch.int32)
    w = torch.tensor(rng.uniform(0, 1, n).astype(np.float32))
    w[::7] = 0.0
    k = 0.3
    q2 = quad_sq(q)[0][:, None]
    c2 = quad_sq(c)[0][None, :]
    dot = walk32(leaf_major(q)[:, None], leaf_major(c)[None], chunks(d))
    dist = torch.sqrt(torch.clamp_min(q2 + c2 - 2.0 * dot, 0.0))
    a = dist.mul_(-k).exp_()
    a = torch.where(q_idx[:, None] == c_idx[None, :], 0.0, a)
    got = class_schedule(a * w, n)[0]
    want = ref.affinity_matvec_ref(q, q_idx, c, c_idx, w, k)
    assert bits_equal(got, want)


def _score_key(s: float) -> int:
    """lid_sweep.cu's key: 0 for no candidate (score -inf), else the bits
    of the score |r| (never NaN) plus one."""
    if s == -np.inf:
        return 0
    return int(np.float32(s).view(np.uint32)) + 1


@pytest.mark.parametrize("seed", range(6))
def test_argmax_key_equals_torch_argmax(seed):
    """The warp argmax over the lanes padded to a multiple of 32 (pads: no
    candidate, key 0): lane l starts at its first slot l and moves to a
    later slot j = l mod 32 only on a larger key; then the largest key and
    the lowest slot that holds it. Ties, -inf rows and +0 included."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 300))
    pool = np.array([-np.inf, 0.0, 1e-6, 0.5, 2.0, np.inf], np.float32)
    s = pool[rng.integers(0, len(pool), cap)]
    if seed == 0:
        s[:] = -np.inf
    capp = -(-cap // 32) * 32
    keys = [_score_key(v) for v in s] + [0] * (capp - cap)
    best, bj = [0] * 32, list(range(32))
    for j in range(capp):
        if keys[j] > best[j % 32]:
            best[j % 32], bj[j % 32] = keys[j], j
    top = max(best)
    i = min(j for k, j in zip(best, bj) if k == top)
    assert i == int(torch.argmax(torch.tensor(s)))


@pytest.mark.parametrize("bsz,cluster", [(1, 8), (7, 8), (16, 8), (32, 4),
                                         (40, 2), (100, 1)])
def test_sweep_plan_cluster_by_batch(bsz, cluster):
    pl = sweep_plan(bsz, 240, 128)
    assert (pl.route, pl.cluster) == ("smem", cluster)
    assert pl.rows_per == -(-240 // cluster)
    assert pl.threads == min(256, -(-4 * pl.rows_per // 32) * 32)
    assert pl.smem <= 232448


def test_sweep_plan_grows_the_cluster_then_reads_in_place():
    # 240 x 256 rows do not fit one block: two blocks a seed hold them
    assert sweep_plan(132, 240, 256)[:2] == ("smem", 2)
    assert sweep_plan(32, 240, 256)[:2] == ("smem", 4)
    assert sweep_plan(4, 560, 256)[:2] == ("smem", 8)
    assert sweep_plan(132, 560, 256)[:2] == ("smem", 4)
    assert sweep_plan(2, 48, 16)[:2] == ("smem", 2)   # >= 16 rows a block
    pl = sweep_plan(32, 2000, 1024)                   # 8 MB a seed
    assert (pl.route, pl.cluster) == ("global", 8)
    assert pl.smem == 4 * 7 * 2016
    with pytest.raises(ValueError):
        sweep_plan(1, 8500, 16)


def test_matvec_plan():
    pl = matvec_plan(240, 240, 128)
    assert pl.route == "smem" and pl.rows == 64 and pl.gpp == pl.groups == 4
    assert (pl.classes, pl.ubits, pl.tc) == (16, 4, 4)
    pl = matvec_plan(240, 112, 128)
    assert (pl.classes, 1 << pl.ubits, pl.tc, pl.groups) == (16, 8, 4, 2)
    assert matvec_plan(1, 240, 128).rows == 8
    # d = 256 stages the columns in passes; d = 2048 reads them in place
    pl = matvec_plan(240, 560, 256)
    assert pl.route == "smem" and pl.gpp < pl.groups
    assert matvec_plan(240, 240, 2048).route == "global"
    assert all(matvec_plan(m, n, d).smem <= 232448
               for m in (1, 240) for n in (1, 37, 240) for d in (16, 700))
    with pytest.raises(ValueError):
        matvec_plan(8, MAX_N + 1, 16)


# ------------------------------------------------------------ roi_filter --
def _scatter_step(vals: torch.Tensor, off: int) -> torch.Tensor:
    """One reduce-scatter step of `reduce_rows8` over (groups, 32 lanes, N
    rows): a lane whose bit `off` is set keeps rows [N/2, N) and the other
    lane of its pair rows [0, N/2), each adding its partner's copy."""
    n = vals.shape[-1]
    lane = torch.arange(32)
    upper = ((lane & off) != 0)[None, :, None]
    lo, hi = vals[..., :n // 2], vals[..., n // 2:]
    keep = torch.where(upper, hi, lo)
    give = torch.where(upper, lo, hi)
    return keep + give[:, lane ^ off]


def ring_emulate(vc, center, radius, valid, stage_rows, blocks,
                 stages=roi.STAGES, warps=roi.RING_WARPS):
    """The ring route of `roi_filter_cuda` step for step: chunk c
    (stage_rows rows) goes to warp c mod W of the grid's W = blocks x warps
    warps, into that warp's stage (c div W) mod stages; each of the chunk's
    groups of 8 rows is reduced by its lanes: lane l sums each row's
    squares at t = l, l + 32, ... from the staged rows, then the
    reduce-scatter (offsets 16, 8, 4; 2, 1 within four lanes) leaves row k
    in lane 4k. Returns (dist, ok, neg) and how often each row was
    written."""
    bsz, per_seed, d = vc.shape
    flat = vc.reshape(-1, d)
    rows = flat.shape[0]
    dist = torch.full((rows,), float("nan"))
    written = torch.zeros(rows, dtype=torch.int64)
    n_chunks = -(-rows // stage_rows)
    n_warps = blocks * warps
    seen = set()
    for c in range(n_chunks):
        warp, turn = c % n_warps, c // n_warps
        stage = turn % stages
        assert (warp, turn) not in seen and warp // warps < blocks
        seen.add((warp, turn))
        r0 = c * stage_rows
        nr = min(stage_rows, rows - r0)
        nbytes = nr * d * flat.element_size()
        # the bulk copy's bytes are a multiple of 16; the tail by hand
        assert nbytes - nbytes // 16 * 16 < 16 and stage < stages
        staged = torch.zeros((stage_rows, d), dtype=flat.dtype)
        staged[:nr] = flat[r0:r0 + nr]
        for g0 in range(0, nr, 8):
            grp = staged[g0:g0 + 8].float()                   # (8, d)
            ids = torch.arange(r0 + g0, r0 + g0 + 8)
            seed = torch.clamp(ids, max=rows - 1) // per_seed
            cen = center[seed]
            acc = None
            for t0 in range(0, d, 32):
                t = torch.arange(t0, t0 + 32)
                diff = grp[:, t.clamp(max=d - 1)] - cen[:, t.clamp(max=d - 1)]
                sq = torch.where(t[None] < d, diff * diff, 0.0)   # (8, 32)
                acc = sq if acc is None else acc + sq
            vals = acc.t()[None]                           # (1, 32 lanes, 8)
            for off in (16, 8, 4):
                vals = _scatter_step(vals, off)
            s = vals[0, :, 0]
            s = s + s[torch.arange(32) ^ 2]
            s = s + s[torch.arange(32) ^ 1]
            for k in range(8):
                row = r0 + g0 + k
                if g0 + k < nr:
                    dist[row] = torch.sqrt(s[4 * k])
                    written[row] += 1
    r = radius[torch.arange(rows) // per_seed]
    ok = valid.reshape(-1) & (dist <= r)
    neg = torch.where(ok, -dist, float("-inf"))
    return (dist.reshape(bsz, per_seed), ok.reshape(bsz, per_seed),
            neg.reshape(bsz, per_seed)), written


def _nan_bits_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()) and \
        torch.equal(torch.signbit(a) | torch.isnan(a),
                    torch.signbit(b) | torch.isnan(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,per_seed,d", [
    (3, 37, 128), (2, 203, 100), (4, 29, 257), (1, 5, 100), (2, 61, 24)])
def test_roi_ring_schedule_equals_plain(dtype, bsz, per_seed, d):
    """The ring's stage order and reduce-scatter, bit for bit against
    `roi_filter_ref` (and on bf16 rows against the upcast rows): ragged
    row counts, groups that straddle seeds, a last chunk whose bytes are
    not a multiple of 16, and NaN / Inf in invalid rows, which must come
    out ok = False, neg = -inf and leave every other row alone."""
    rng = np.random.default_rng(bsz * 1000 + per_seed + d)
    vc = _rows(rng, (bsz, per_seed, d)).to(dtype)
    center = _rows(rng, (bsz, d))
    valid = torch.tensor(rng.uniform(size=(bsz, per_seed)) < 0.7)
    valid[0, 0] = False
    vc[0, 0, :3] = float("nan")
    vc[-1, -1] = float("inf")
    valid[-1, -1] = False
    dist_all = torch.sqrt(ref.pinned_sum(
        (vc.float() - center[:, None]) ** 2))
    radius = torch.quantile(dist_all[torch.isfinite(dist_all)], 0.5) * \
        torch.ones(bsz)
    # one block, so that each warp takes several chunks
    esize = vc.element_size()
    stage_rows = 8 if d * esize > 1024 else 16
    rows = bsz * per_seed
    got, written = ring_emulate(vc, center, radius, valid, stage_rows, 1)
    want = ref.roi_filter_ref(vc, center, radius, valid)
    assert bool((written == 1).all())
    assert _nan_bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert not bool(got[1][0, 0]) and got[2][0, 0] == float("-inf")
    assert not bool(got[1][-1, -1]) and got[2][-1, -1] == float("-inf")
    if dtype == torch.bfloat16:
        up = ring_emulate(vc.float(), center, radius, valid, stage_rows,
                          1)[0]
        assert all(_nan_bits_equal(a, b) for a, b in zip(got, up))
    # the plan's own stages on the same rows
    real = roi.plan(rows, d, dtype, min_rows=0)
    if real.route == "ring":
        # a block for every RING_WARPS chunks, at most the blocks the
        # card's SMs hold: here, two
        chunks = -(-rows // real.stage_rows)
        again, written = ring_emulate(
            vc, center, radius, valid, real.stage_rows,
            min(-(-chunks // roi.RING_WARPS), 2))
        assert bool((written == 1).all())
        assert all(_nan_bits_equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype,rows,want", [
    (torch.float32, 32 * 7168, ("ring", 8, 32768)),
    (torch.bfloat16, 32 * 7168, ("ring", 8, 16384)),
    (torch.float32, 32 * 900, ("ring", 8, 32768)),
    (torch.float32, roi.RING_MIN_ROWS - 1, ("rows", 0, 0)),
    (torch.bfloat16, 240, ("rows", 0, 0))])
def test_roi_filter_plan(dtype, rows, want):
    """The main path's 32 x 7,168 x 128 takes the ring: stages of one
    8-row group (4 KB of f32 rows, 2 KB of bf16), two a warp, four warps a
    block; below RING_MIN_ROWS, the rows."""
    pl = roi.plan(rows, 128, dtype)
    assert tuple(pl) == want


def test_roi_filter_plan_edges():
    """Rows not on 16 bytes and rows too wide for a stage take the rows
    route; a narrow row's stage holds the fewest rows (a multiple of 8)
    that reach STAGE_BYTES, up to STAGE_MAX_ROWS; every ring's block fits
    the 227 KB of shared memory an H100 block may ask."""
    n = 32 * 7168
    assert roi.plan(n, 128, aligned=False).route == "rows"
    assert roi.plan(n, 257).route == "rows"
    assert roi.plan(n, 257, torch.bfloat16).stage_rows == 8
    assert roi.plan(n, 24).stage_rows == 24
    assert roi.plan(n, 24, torch.bfloat16).stage_rows == 32
    assert roi.plan(n, 100, torch.bfloat16).stage_rows == 16
    for d in (1, 3, 24, 100, 128, 257, 512, 1000, 4096):
        for dt in (torch.float32, torch.bfloat16):
            pl = roi.plan(n, d, dt)
            if pl.route == "ring":
                assert pl.stage_rows % 8 == 0 and \
                    8 <= pl.stage_rows <= roi.STAGE_MAX_ROWS
                assert pl.smem == roi.RING_WARPS * roi.STAGES * \
                    pl.stage_rows * d * torch.empty((), dtype=dt).itemsize
                assert pl.smem <= 227 * 1024
