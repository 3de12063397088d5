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
`lid_sweep.plan`) are checked here too.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.affinity_matvec import MAX_N, column_classes, \
    leaf_groups
from repro_torch.kernels.affinity_matvec import plan as matvec_plan
from repro_torch.kernels.lid_sweep import plan as sweep_plan


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
