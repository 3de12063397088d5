"""The port's fused cluster assignment (`repro_torch.kernels.ops.
assign_clusters`, whose plain version `kernels.ref.assign_ref` runs on the
CPU) against the JAX package's `ops.assign_clusters` with backend="ref",
on the same numpy inputs.

Labels must be equal. Scores agree to rtol 1e-5: the port takes every
d-long sum and the sum over a cluster's supports in its pinned order, XLA
in its own, which moves a score by a few ulps (~4e-7 relative on these
inputs); the atol of 1e-6 covers scores that underflow towards 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.assign import LANE_ROWS, SMEM_MAX, plan, \
    tile_smem_bytes

SHAPES = [(16, 3, 8, 8), (100, 5, 24, 16), (257, 2, 33, 100), (1, 1, 4, 6),
          (5, 3, 40, 1500)]   # d past the old kernel's 1,184 (C2)


def _inputs(m, n_clusters, a, d, seed=13):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    sup_v = rng.normal(size=(n_clusters, a, d)).astype(np.float32)
    sup_w = rng.uniform(0, 1, (n_clusters, a)).astype(np.float32)
    sup_w /= sup_w.sum(axis=1, keepdims=True)
    dens = rng.uniform(0.4, 1.0, n_clusters).astype(np.float32)
    return q, sup_v, sup_w, dens


def _both(q, sup_v, sup_w, dens, k, thr, valid=None):
    """(port labels, port scores), (JAX labels, JAX scores) as numpy."""
    t = torch.as_tensor
    got = ops.assign_clusters(t(q), t(sup_v), t(sup_w), t(dens), k, thr,
                              None if valid is None else t(valid))
    want = jops.assign_clusters(jnp.asarray(q), jnp.asarray(sup_v),
                                jnp.asarray(sup_w), jnp.asarray(dens), k, thr,
                                None if valid is None else jnp.asarray(valid),
                                backend="ref")
    return [a.numpy() for a in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("threshold", [0.5, 0.0])
@pytest.mark.parametrize("m,n_clusters,a,d", SHAPES)
def test_assign_matches_jax(m, n_clusters, a, d, threshold):
    """threshold 0 accepts every argmax, so the labels check the argmax
    itself; 0.5 (tests/test_kernels.py) checks the density bar."""
    (gl, gs), (wl, ws) = _both(*_inputs(m, n_clusters, a, d), 0.5,
                               threshold)
    assert gl.dtype == np.int32 and gl.shape == (m,)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    if threshold == 0.0:
        assert (gl >= 0).all()


def test_assign_valid_mask_trap():
    """tests/test_kernels.py::test_assign_clusters_valid_mask: zero "pad"
    rows sit on clusters that hug the origin, so unmasked they DO get
    labels; masked they come out -1 and 0.0 exactly, and the valid rows are
    bitwise the unmasked call's."""
    rng = np.random.default_rng(15)
    n_clusters, a, d, m = 3, 8, 6, 10
    sup_v = rng.normal(scale=0.05, size=(n_clusters, a, d)).astype(np.float32)
    sup_w = np.full((n_clusters, a), 1.0 / a, np.float32)
    dens = rng.uniform(0.4, 0.9, n_clusters).astype(np.float32)
    q = rng.normal(scale=0.05, size=(m, d)).astype(np.float32)
    q[m // 2:] = 0.0
    valid = np.arange(m) < m // 2
    (ul, us), _ = _both(q, sup_v, sup_w, dens, 0.5, 0.5)
    (ml, ms), (wl, ws) = _both(q, sup_v, sup_w, dens, 0.5, 0.5, valid)
    assert (ul[m // 2:] >= 0).any()              # the trap
    np.testing.assert_array_equal(ml[:m // 2], ul[:m // 2])
    np.testing.assert_array_equal(ms[:m // 2], us[:m // 2])
    assert (ml[m // 2:] == -1).all() and (ms[m // 2:] == 0.0).all()
    np.testing.assert_array_equal(ml, wl)
    np.testing.assert_allclose(ms, ws, rtol=1e-5, atol=1e-6)


def test_assign_poisoned_pad_rows_never_reach_valid_rows():
    """`repro.analysis.contracts` POISON_CHECKS for assign_clusters: NaN and
    Inf in the masked rows leave the valid rows' labels and scores
    bitwise unchanged, and the masked rows come out -1 and 0.0."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 8)).astype(np.float32)
    sup_v = rng.normal(size=(4, 8, 8)).astype(np.float32)
    sup_w = rng.uniform(0.1, 1.0, size=(4, 8)).astype(np.float32)
    dens = rng.uniform(0.5, 1.0, size=(4,)).astype(np.float32)
    valid = torch.ones(32, dtype=torch.bool)
    valid[24:] = False
    clean = torch.as_tensor(q.copy())
    clean[24:] = 0.0
    dirty = torch.as_tensor(q.copy())
    dirty[24:28] = float("nan")
    dirty[28:] = float("inf")
    args = (torch.as_tensor(sup_v), torch.as_tensor(sup_w),
            torch.as_tensor(dens), 0.5, 0.1, valid)
    bl, bs = ops.assign_clusters(clean, *args)
    lab, sc = ops.assign_clusters(dirty, *args)
    assert torch.equal(bl[:24], lab[:24]) and torch.equal(bs[:24], sc[:24])
    assert bool((lab[24:] == -1).all()) and bool((sc[24:] == 0.0).all())
    assert bool((lab[:24] >= 0).any())


def test_assign_no_clusters_and_no_queries():
    """C = 0 labels every query -1 with score 0 and launches nothing, as
    the JAX package's `Tenant.assign_np` does; so does m = 0."""
    before = ops.launch_counts()
    labels, scores = ops.assign_clusters(
        torch.ones(5, 6), torch.zeros(0, 8, 6), torch.zeros(0, 8),
        torch.zeros(0), 0.7, 0.5)
    assert labels.dtype == torch.int32
    assert labels.tolist() == [-1] * 5 and scores.tolist() == [0.0] * 5
    labels, scores = ops.assign_clusters(
        torch.ones(0, 6), torch.ones(2, 8, 6), torch.ones(2, 8),
        torch.ones(2), 0.7, 0.5)
    assert labels.shape == (0,) and scores.shape == (0,)
    assert ops.launch_counts() == before


def test_assign_rejects_mismatched_dimension():
    q, sup_v, sup_w, dens = _inputs(4, 2, 5, 6)
    with pytest.raises(ValueError, match="dimension"):
        ops.assign_clusters(torch.as_tensor(q[:, :5]), torch.as_tensor(sup_v),
                            torch.as_tensor(sup_w), torch.as_tensor(dens),
                            0.5, 0.5)


def test_plain_version_sums_in_the_pinned_order(monkeypatch):
    """The best score is the `pinned_sum` over a of w * exp(-k dist), the
    distances from the pinned expansion; and cutting the queries into
    blocks of one row (as a full-width table does) changes no bit."""
    q, sup_v, sup_w, dens = (torch.as_tensor(a)
                             for a in _inputs(40, 3, 45, 37, seed=3))
    labels, best = ref.assign_ref(q, sup_v, sup_w, dens, 0.25, 0.0)
    per_cluster = torch.stack([ref.pinned_sum(
        ref.affinity_ref(q, sup_v[c], 0.25) * sup_w[c]) for c in range(3)],
        dim=1)
    assert torch.equal(best, per_cluster.max(dim=1).values)
    assert torch.equal(labels.long(), per_cluster.argmax(dim=1))
    monkeypatch.setattr(ref, "_ASSIGN_PAIRS", 1)
    one_row = ref.assign_ref(q, sup_v, sup_w, dens, 0.25, 0.0)
    assert torch.equal(one_row[0], labels) and torch.equal(one_row[1], best)


@pytest.mark.parametrize("d", [6, 128, 448, 449, 700, 1500, 2048, 4096])
@pytest.mark.parametrize("m", [1, 3, 4, 16, 17, 64, 77, 4096])
def test_assign_plan_picks_by_rows_and_takes_any_d(m, d):
    """The kernel plan from host ints: the lanes kernel for up to 16 rows
    (a power of two of them a warp) and wherever the tiles kernel's rows
    would not fit in shared memory; the tiles kernel for more rows, about
    three blocks a SM. No d raises (C2: the old plan did past d = 1,184)."""
    p = plan(m, 2048, 240, d)
    if m <= LANE_ROWS or tile_smem_bytes(d) > SMEM_MAX:
        assert p.kernel == "lanes" and p.rows in (1, 2, 4, 8, 16)
        assert min(m, LANE_ROWS) <= p.rows < 2 * min(m, LANE_ROWS)
    else:
        assert p.kernel == "tiles" and 1 <= p.slices <= 2048
        assert p.smem == tile_smem_bytes(d) <= SMEM_MAX
        assert -(-m // 64) * p.slices >= 3 * 132 or p.slices == 2048
    assert (plan(m, 2048, 240, d).kernel == "tiles") == (m > 16 and d <= 448)


def _transpose_tree(x: torch.Tensor) -> torch.Tensor:
    """`transpose_tree` of csrc/assign.cu on (32 lanes, V) values: each
    step of the halving tree keeps the half of a lane's values that its
    lane bit names and adds the partner lane's copy of that half; one
    value left, the steps add it across lanes. -> (32,) lane values."""
    lane = torch.arange(32)
    for step in range(5):
        off = 16 >> step
        partner = lane ^ off
        upper = ((lane & off) != 0)[:, None]
        if x.shape[1] > 1:
            half = x.shape[1] // 2
            keep = torch.where(upper, x[:, half:], x[:, :half])
            send = torch.where(upper, x[:, :half], x[:, half:])
            x = keep + send[partner]
        else:
            x = x + x[partner]
    return x[:, 0]


def _lanes_emulated(q, sup_v, sup_w, k, rows):
    """The scores of `assign_lanes_kernel` in f32 on the CPU, lane by lane:
    a warp per (cluster, group of `rows` queries), lane l holding terms
    t = l (mod 32) of every dot as d streams in chunks of 32 columns, G =
    32 / rows supports at a time, the transposing reductions, and the sum
    over a in running sums of residues g G + k kept per lane."""
    m, d = q.shape
    n_c, a_cap, _ = sup_v.shape
    g_sup = 32 // rows
    lg = g_sup.bit_length() - 1
    nch = -(-d // 32)
    lane = torch.arange(32)
    my_i, my_k = lane >> lg, lane & (g_sup - 1)
    pad = torch.nn.functional.pad
    scores = torch.empty((m, n_c))
    for i0 in range(0, m, rows):
        qg = pad(q[i0:i0 + rows], (0, 32 * nch - d, 0, rows - q[i0:i0 + rows].shape[0]))
        qc = qg.view(rows, nch, 32)
        acc = None
        for ch in range(nch):
            pr = (qc[:, ch] * qc[:, ch]).T                  # (32, rows)
            acc = pr if ch == 0 else acc + pr
        q2 = _transpose_tree(acc)
        for c in range(n_c):
            a32_n = -(-a_cap // 32) * 32
            sv = pad(sup_v[c], (0, 32 * nch - d, 0, a32_n - a_cap))
            w = pad(sup_w[c], (0, a32_n - a_cap))
            sc = sv.view(a32_n, nch, 32)
            run = [None] * rows
            for a32 in range(0, a_cap, 32):
                for g in range(rows):
                    a0 = a32 + g * g_sup
                    dot = sq = None
                    for ch in range(nch):
                        s_ch = sc[a0:a0 + g_sup, ch].T          # (32, G)
                        q_ch = qc[:, ch].T                      # (32, rows)
                        prd = (q_ch[:, :, None] * s_ch[:, None, :]).reshape(32, -1)
                        prs = s_ch * s_ch
                        dot = prd if ch == 0 else dot + prd
                        sq = prs if ch == 0 else sq + prs
                    dv = _transpose_tree(dot)
                    s2 = _transpose_tree(sq)[my_k << (5 - lg)]
                    d2 = (q2 + s2) - 2.0 * dv
                    aff = torch.exp(-k * torch.sqrt(torch.clamp_min(d2, 0.0)))
                    a = a0 + my_k
                    p = torch.where(a < a_cap, aff * w[a], 0.0)
                    run[g] = p if a32 == 0 else run[g] + p
            off = 16
            while off >= g_sup:
                for g in range(off // g_sup):
                    run[g] = run[g] + run[g + off // g_sup]
                off //= 2
            v = run[0]
            while off > 0:
                v = v + v[lane ^ off]
                off //= 2
            for i in range(min(rows, m - i0)):
                scores[i0 + i, c] = v[i * g_sup]
    return scores


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("m,a_cap,d", [(3, 45, 40), (16, 33, 6), (5, 70, 100)])
def test_lane_kernel_order_is_the_pinned_order(m, a_cap, d, rows):
    """An emulation of the lanes kernel's arithmetic (lane-parallel dots,
    transposing reductions, the sum over a in per-lane residues) gives
    the plain version's scores bit for bit: its order is the pinned one."""
    q, sup_v, sup_w, _ = (torch.as_tensor(x) for x in
                          _inputs(m, 3, a_cap, d, seed=m + a_cap))
    k = float(np.float32(0.3))
    want = torch.stack([ref.pinned_sum(
        ref.affinity_ref(q, sup_v[c], k) * sup_w[c]) for c in range(3)],
        dim=1)
    got = _lanes_emulated(q, sup_v, sup_w, k, rows)
    assert torch.equal(got, want)
