"""The port's CUDA kernels against their plain PyTorch versions, on the
card. `roi_filter`, `affinity_matvec`, `lid_sweep`, `assign` and `affinity`
sum in the pinned order of `repro_torch.kernels.ref` with separate
multiplies and adds, so their outputs must be bit-equal. `lsh_hash` sums
in its own order: its keys may differ only where z / seg_len lies within
1e-4 of an integer (`kernels.lsh_hash.key_flips`), and on these inputs at
most one pair in 10,000 may. Small shapes with ragged tails;
chip_smoke.py checks the main path's shapes.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed: `PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py`. Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.affinity import affinity_matrix, estimate_k
from repro_torch.core.iid import iid_solve, uniform_on
from repro_torch.core.lid import LIDState, lid_solve, lid_solve_unfused, \
    refresh_ax
from repro_torch.core.peeling import ds_detect, iid_detect
from repro_torch.core.rd import replicator_solve
from repro_torch.kernels import ops
from repro_torch.kernels.lsh_hash import key_flips

K = 0.45


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda", 0)


def _states(dev, bsz=3, cap=48, d=16, n_valid=None):
    """Full-range LID states of clustered rows, x at slot 0, exact Ax."""
    rng = np.random.default_rng(bsz * 100 + cap + d)
    centers = rng.normal(size=(bsz, 4, d)) * 3.0
    pts = centers[:, rng.integers(0, 4, cap)] + rng.normal(size=(bsz, cap, d))
    n_valid = cap if n_valid is None else n_valid
    mask = torch.zeros((bsz, cap), dtype=torch.bool, device=dev)
    mask[:, :n_valid] = True
    v = torch.where(mask[..., None],
                    torch.tensor(pts, dtype=torch.float32, device=dev), 0.0)
    idx = torch.arange(cap, dtype=torch.int32, device=dev).repeat(bsz, 1)
    x = torch.zeros((bsz, cap), device=dev)
    x[:, 0] = 1.0
    st = LIDState(idx, mask, v, x, torch.zeros_like(x),
                  torch.zeros(bsz, dtype=torch.int32, device=dev),
                  torch.zeros(bsz, dtype=torch.bool, device=dev))
    return refresh_ax(st, K, backend="ref")


def _both(fn):
    return fn("kernel"), fn("ref")


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(p, q) for p, q in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(777, 24), (5000, 128), (3, 100)])
def test_lsh_hash_matches_plain(dev, n, d):
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32) * 4,
                     device=dev)
    proj = torch.tensor(rng.normal(size=(3, 5, d)).astype(np.float32),
                        device=dev)
    bias = torch.tensor(rng.uniform(0, 2, (3, 5)).astype(np.float32),
                        device=dev)
    got, want = _both(lambda b: ops.lsh_hash(x, proj, bias, 2.0, backend=b))
    n_flip, near = key_flips(x, proj, bias, 2.0, got, want)
    assert near and n_flip <= 1e-4 * got.numel(), n_flip


@pytest.mark.cuda
@pytest.mark.parametrize("per_seed,d", [(350, 24), (7168, 128), (5, 100)])
def test_roi_filter_bitwise(dev, per_seed, d):
    rng = np.random.default_rng(per_seed)
    vc = torch.tensor(rng.normal(size=(2, per_seed, d)).astype(np.float32),
                      device=dev)
    center = torch.tensor(rng.normal(size=(2, d)).astype(np.float32),
                          device=dev)
    radius = torch.tensor([np.sqrt(2 * d), 0.9 * np.sqrt(2 * d)],
                          dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.integers(0, 2, (2, per_seed)).astype(bool),
                         device=dev)
    assert _equal(*_both(lambda b: ops.roi_filter(vc, center, radius, valid,
                                                  backend=b)))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n,d", [(48, 37, 16), (240, 112, 128),
                                     (130, 130, 100)])
def test_affinity_matvec_bitwise(dev, cap, n, d):
    st = _states(dev, cap=cap, d=d)
    w = st.x[:, :n] + 0.1
    assert _equal(*_both(lambda b: ops.affinity_matvec(
        st.v_beta, st.beta_idx, st.v_beta[:, :n], st.beta_idx[:, :n], w, K,
        backend=b)))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d,refresh", [(48, 16, 0), (48, 16, 2),
                                           (240, 128, 0), (240, 256, 4),
                                           (100, 30, 3)])
def test_lid_sweep_bitwise(dev, cap, d, refresh):
    st = _states(dev, cap=cap, d=d, n_valid=cap - 5)
    got, want = _both(lambda b: ops.lid_sweep(
        st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
        st.converged, K, n_steps=8, max_iters=64, tol=1e-5,
        refresh_every=refresh, backend=b))
    assert int(want[2].min()) > 1, "the states did not iterate"
    assert _equal(got, want)


def _assign_inputs(dev, m, n_clusters, a_cap, d, seed=0):
    """Clustered supports and a query mix: rows near the supports, rows
    between clusters, far noise. k is set from the data's scale so that
    scores spread and some labels clear the threshold."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 10.0
    sup_v = centers[:, None] + rng.normal(size=(n_clusters, a_cap, d))
    sup_w = rng.uniform(0.0, 1.0, (n_clusters, a_cap))
    sup_w[:, 1::7] = 0.0                               # some zero weights
    sup_w /= sup_w.sum(1, keepdims=True)
    pick = rng.integers(0, n_clusters, m)
    q = centers[pick] + rng.normal(size=(m, d)) * rng.choice(
        [0.5, 1.0, 3.0], size=(m, 1))
    q[: m // 8] = rng.uniform(-60, 60, (m // 8, d)) + 300.0
    k = float(np.float32(1.0 / np.sqrt(2.0 * d)))
    dens = rng.uniform(0.3, 0.9, n_clusters)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return t(q), t(sup_v), t(sup_w), t(dens), k


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_clusters,a_cap,d", [
    (64, 2048, 240, 128),    # one full-width serving batch
    (77, 37, 240, 128),      # ragged m: a second, partial query tile
    (5, 9, 240, 256),        # A * d * 4 past 227 KB: supports stream
    (3, 4, 33, 700),         # d too wide for 64-query tiles: 16-row tiles
    (1, 1, 4, 6)])
def test_assign_bitwise(dev, m, n_clusters, a_cap, d):
    q, sup_v, sup_w, dens, k = _assign_inputs(dev, m, n_clusters, a_cap, d)
    for thr in (0.5, 0.05):
        got, want = _both(lambda b: ops.assign_clusters(
            q, sup_v, sup_w, dens, k, thr, backend=b))
        assert _equal(got, want)
        assert bool(torch.isfinite(got[1]).all())
    assert int((got[0] >= 0).sum()) > 0 or m < 8


@pytest.mark.cuda
def test_assign_masked_batch_bitwise(dev):
    """A 64-slot batch with 40 real rows and NaN-poisoned pad rows: pads
    come out -1 and 0.0, real rows bitwise the unpadded call's, and the
    kernel equals its plain version."""
    q, sup_v, sup_w, dens, k = _assign_inputs(dev, 64, 300, 240, 128)
    valid = torch.arange(64, device=dev) < 40
    dirty = q.clone()
    dirty[40:] = float("nan")
    got, want = _both(lambda b: ops.assign_clusters(
        dirty, sup_v, sup_w, dens, k, 0.1, valid, backend=b))
    assert _equal(got, want)
    assert bool((got[0][40:] == -1).all()) and bool((got[1][40:] == 0).all())
    alone = ops.assign_clusters(q[:40], sup_v, sup_w, dens, k, 0.1)
    assert _equal((got[0][:40], got[1][:40]), alone)


@pytest.mark.cuda
def test_kernel_counts_and_no_fallback(dev):
    """"auto" on a CUDA tensor launches the kernel (the count moves);
    "ref" never does."""
    st = _states(dev)
    before = ops.launch_counts()
    ops.affinity_matvec(st.v_beta, st.beta_idx, st.v_beta, st.beta_idx,
                        st.x, K, backend="ref")
    assert ops.launch_counts() == before
    ops.affinity_matvec(st.v_beta, st.beta_idx, st.v_beta, st.beta_idx,
                        st.x, K)
    assert ops.launch_counts()["affinity_matvec"] == \
        before["affinity_matvec"] + 1
    q, sup_v, sup_w, dens, k = _assign_inputs(dev, 8, 3, 16, 12)
    before = ops.launch_counts()
    ops.assign_clusters(q, sup_v, sup_w, dens, k, 0.5, backend="ref")
    assert ops.launch_counts() == before
    ops.assign_clusters(q, sup_v, sup_w, dens, k, 0.5)
    ops.assign_clusters(q, sup_v[:0], sup_w[:0], dens[:0], k, 0.5)  # C = 0
    assert ops.launch_counts()["assign"] == before["assign"] + 1
    before = ops.launch_counts()
    ops.affinity(st.v_beta, st.v_beta, K, backend="ref")
    assert ops.launch_counts() == before
    ops.affinity(st.v_beta, st.v_beta, K)
    ops.affinity(st.v_beta[:, :0], st.v_beta, K)               # m = 0
    assert ops.launch_counts()["affinity"] == before["affinity"] + 1
    with pytest.raises(TypeError, match="float32"):
        ops.affinity(st.v_beta.half(), st.v_beta.half(), K)
    with pytest.raises(NotImplementedError, match="p=1.0"):
        ops.affinity(st.v_beta, st.v_beta, K, p=1.0)


def _equal_nan(a, b):
    """Bit-equal where both are numbers, NaN at the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,m,n,d", [
    ((), 1, 300, 7), ((), 130, 257, 100),     # the JAX test's ragged shapes
    ((), 64, 2000, 128),                      # full tiles, several panels
    ((), 240, 1, 128), ((), 560, 1, 256),     # a LID column
    ((), 5, 33, 700),                         # d too wide: 16-row tiles
    ((3,), 48, 1, 16)])                       # a batch of columns
def test_affinity_bitwise(dev, lead, m, n, d):
    rng = np.random.default_rng(m * n + d)
    q = torch.tensor(rng.normal(size=(*lead, m, d)).astype(np.float32),
                     device=dev)
    c = torch.tensor(rng.normal(size=(*lead, n, d)).astype(np.float32),
                     device=dev)
    got, want = _both(lambda b: ops.affinity(q, c, 0.37, backend=b))
    assert got.shape == (*lead, m, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_affinity_nan_rows(dev):
    """NaN in a row of q or c comes out where the plain version puts it:
    the clamp at 0 lets NaN through (torch.clamp_min), as fmaxf would not.
    """
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(70, 40)).astype(np.float32),
                     device=dev)
    c = torch.tensor(rng.normal(size=(90, 40)).astype(np.float32),
                     device=dev)
    q[3, 7] = float("nan")
    c[11] = float("nan")
    got, want = _both(lambda b: ops.affinity(q, c, 0.5, backend=b))
    assert bool(torch.isnan(got[3]).all()) and bool(
        torch.isnan(got[:, 11]).all())
    assert _equal_nan(got, want)


@pytest.mark.cuda
def test_affinity_matrix_symmetric(dev):
    """affinity_matrix is bitwise symmetric with a zero diagonal, through
    the kernel and through the plain version, and the two are equal."""
    rng = np.random.default_rng(6)
    v = torch.tensor(rng.normal(size=(333, 24)).astype(np.float32) * 3,
                     device=dev)
    got, want = _both(lambda b: affinity_matrix(v, 0.2, backend=b))
    for a in (got, want):
        assert torch.equal(a, a.T)
        assert bool((torch.diagonal(a) == 0).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d", [(48, 16), (240, 128), (560, 256)])
def test_lid_solve_unfused_equals_fused(dev, cap, d):
    """lid_solve_unfused (its columns from the affinity kernel) equals
    lid_solve (the lid_sweep kernel) bit for bit."""
    st = _states(dev, bsz=4, cap=cap, d=d, n_valid=cap - 3)
    fused = lid_solve(st, K, max_iters=200)
    unfused = lid_solve_unfused(st, K, max_iters=200)
    assert int(unfused.n_iters.max()) > 2
    for name in ("x", "ax", "n_iters", "converged"):
        assert torch.equal(getattr(fused, name), getattr(unfused, name)), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("detect", [iid_detect, ds_detect])
def test_peel_kernel_matrix_equals_plain(dev, detect):
    """A peel on the kernel's matrix equals one on the plain version's."""
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(4, 8)) * 20.0
    pts = np.concatenate([centers[i] + rng.normal(size=(25, 8))
                          for i in range(4)]
                         + [rng.uniform(-40, 40, (60, 8))])
    v = torch.tensor(pts.astype(np.float32), device=dev)
    k = estimate_k(v)                 # 0.0269: four clusters of density 0.86
    got, want = _both(lambda b: detect(affinity_matrix(v, k, backend=b)))
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.densities, want.densities)
    assert got.n_rounds == want.n_rounds and len(got.densities) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("solve", [iid_solve, replicator_solve],
                         ids=["iid", "rd"])
def test_solver_graphs_change_no_bit(dev, solve):
    """Chunks replayed from a CUDA graph equal the eager loop bitwise, for
    any chunk size, up to a budget that ends mid-chunk."""
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(3, 6)) * 10.0
    pts = np.concatenate([c + rng.normal(size=(40, 6)) for c in centers]
                         + [rng.uniform(-30, 30, (80, 6))])
    a = affinity_matrix(torch.tensor(pts.astype(np.float32), device=dev),
                        0.2)
    act = torch.tensor(rng.random(len(pts)) < 0.8, device=dev)
    x0 = uniform_on(act)
    want = solve(a, x0, max_iters=3000, active=act, chunk=1, graphs=False)
    assert int(want.n_iters) > 10
    for chunk, budget in ((1, 3000), (16, 3000), (64, 3000), (16, 37)):
        got = solve(a, x0, max_iters=budget, active=act, chunk=chunk)
        ref = want if budget == 3000 else solve(
            a, x0, max_iters=budget, active=act, graphs=False)
        for name in ("x", "density", "n_iters", "converged"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), \
                (chunk, budget, name)
