"""The port's CUDA kernels against their plain PyTorch versions, on the
card. `roi_filter`, `affinity_matvec`, `lid_sweep`, `assign`, `affinity`,
`embedding_bag` and `segment_matmul` sum in the pinned orders of
`repro_torch.kernels.ref` with separate multiplies and adds, so their
outputs must be bit-equal. `lsh_hash` sums
in its own order: its keys may differ only where z / seg_len lies within
1e-4 of an integer (`kernels.lsh_hash.key_flips`), and on these inputs at
most one pair in 10,000 may. Small shapes with ragged tails;
chip_smoke.py checks the main path's shapes. The online path (one-lane
re-convergences) runs through the kernels and the plain versions to
bit-equal states, and so do the GNNs' forwards (every aggregation through
`segment_matmul`).

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
from repro_torch.kernels import ref as kref
from repro_torch.kernels.embedding_bag import embedding_bag_bwd_cuda
from repro_torch.kernels.flash_attention import (compare_with_plain,
                                                 flash_attention_bwd_cuda)
from repro_torch.kernels.lsh_hash import key_flips
from repro_torch.kernels.segment_matmul import segment_matmul_bwd_cuda

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
@pytest.mark.parametrize("n,d", [(777, 24), (5000, 128), (3, 100), (0, 128),
                                 (1, 24), (7, 100), (3584, 128),
                                 (100_003, 128), (100_003, 24)])
def test_lsh_hash_matches_plain(dev, n, d):
    """Both routes (probe up to 16,384 points, stream past it) within the
    key-flip rule; NaN pad rows after the points change none of their
    keys."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32) * 4,
                     device=dev)
    proj = torch.tensor(rng.normal(size=(3, 5, d)).astype(np.float32),
                        device=dev)
    bias = torch.tensor(rng.uniform(0, 2, (3, 5)).astype(np.float32),
                        device=dev)
    got, want = _both(lambda b: ops.lsh_hash(x, proj, bias, 2.0, backend=b))
    assert got.shape == (n, 3)
    n_flip, near = key_flips(x, proj, bias, 2.0, got, want)
    assert near and n_flip <= 1e-4 * got.numel(), n_flip
    pads = torch.full((5, d), float("nan"), device=dev)
    padded = ops.lsh_hash(torch.cat([x, pads]), proj, bias, 2.0)
    assert torch.equal(padded[:n], got)


@pytest.mark.cuda
def test_lsh_hash_routes_agree(dev):
    """The probe route (the CIVS probes) and the stream route (the store
    build) sum in one order: a point gets the same keys from both."""
    from repro_torch.kernels.lsh_hash import lsh_hash_cuda
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(20_000, 128)).astype(np.float32) * 4,
                     device=dev)
    proj = torch.tensor(rng.normal(size=(4, 8, 128)).astype(np.float32),
                        device=dev)
    bias = torch.tensor(rng.uniform(0, 2, (4, 8)).astype(np.float32),
                        device=dev)
    before = dict(lsh_hash_cuda.by_path)
    full = lsh_hash_cuda(x, proj, bias, 2.0)
    probe = lsh_hash_cuda(x[:3584].contiguous(), proj, bias, 2.0)
    assert torch.equal(probe, full[:3584])
    assert lsh_hash_cuda.by_path["stream"] == before["stream"] + 1
    assert lsh_hash_cuda.by_path["probe"] == before["probe"] + 1


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
@pytest.mark.parametrize("bsz,cap,n,d", [
    (3, 48, 37, 16), (3, 240, 112, 128), (3, 130, 130, 100),
    (1, 240, 240, 128), (7, 240, 200, 128), (32, 240, 112, 128),
    (3, 240, 240, 256), (2, 560, 560, 256), (2, 64, 37, 2048),
    (2, 9, 3, 16)])
def test_affinity_matvec_bitwise(dev, bsz, cap, n, d):
    """Every column-class layout (n 3 to 560), the column passes (d = 256,
    n = 560) and the route that reads rows in place (d = 2,048)."""
    st = _states(dev, bsz=bsz, cap=cap, d=d)
    w = st.x[:, :n] + 0.1
    assert _equal(*_both(lambda b: ops.affinity_matvec(
        st.v_beta, st.beta_idx, st.v_beta[:, :n], st.beta_idx[:, :n], w, K,
        backend=b)))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,cap,d,refresh", [
    (3, 48, 16, 0), (3, 48, 16, 2), (3, 240, 128, 0), (3, 240, 256, 4),
    (3, 100, 30, 3), (1, 240, 128, 0), (7, 240, 128, 4), (32, 240, 128, 0),
    (40, 240, 128, 0), (100, 240, 128, 0), (32, 200, 16, 4),
    (32, 200, 256, 0), (4, 560, 256, 0), (4, 560, 128, 4),
    (2, 2000, 256, 0)])
def test_lid_sweep_bitwise(dev, bsz, cap, d, refresh):
    """Every cluster size of `kernels.lid_sweep.plan` (8 at B = 1 and 7, 4
    at 32, 2 at 40, 1 at 100), ragged caps, d 16 to 256, the in-sweep
    refresh, and rows read in place (cap 2,000 x d 256)."""
    st = _states(dev, bsz=bsz, cap=cap, d=d, n_valid=cap - 5)
    got, want = _both(lambda b: ops.lid_sweep(
        st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
        st.converged, K, n_steps=8, max_iters=64, tol=1e-5,
        refresh_every=refresh, backend=b))
    assert int(want[2].min()) > 1, "the states did not iterate"
    assert _equal(got, want)


@pytest.mark.cuda
def test_lid_sweep_converged_lanes_unchanged(dev):
    """Lanes converged or at max_iters on entry come back unchanged, with
    n_iters as it was, beside a lane that still iterates."""
    st = _states(dev, bsz=3, cap=240, d=128)
    cv = torch.tensor([True, False, False], device=dev)
    it = torch.tensor([5, 64, 0], dtype=torch.int32, device=dev)
    x, ax, it_out, cv_out = ops.lid_sweep(
        st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, it, cv, K,
        n_steps=8, max_iters=64, tol=1e-5, backend="kernel")
    assert torch.equal(x[:2], st.x[:2]) and torch.equal(ax[:2], st.ax[:2])
    assert it_out.tolist()[:2] == [5, 64] and cv_out.tolist()[:2] == [
        True, False]
    assert int(it_out[2]) > 1


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
    (3, 4, 33, 700),         # a few rows at a wide d: the lanes kernel
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
@pytest.mark.parametrize("d", [6, 128, 700, 1500, 2048])
@pytest.mark.parametrize("m", [1, 4, 16, 64, 77, 4096])
def test_assign_plans_bitwise(dev, m, d):
    """Both scores kernels (`kernels.assign.plan`: lanes up to 16 rows and
    past d = 448, tiles otherwise) bit-equal to the plain version at every
    d (C2: the old kernel refused d > 1,184), masked and unmasked, with
    NaN-poisoned pad rows coming out -1 and 0.0."""
    from repro_torch.kernels.assign import plan
    q, sup_v, sup_w, dens, k = _assign_inputs(dev, m, 7, 45, d, seed=m + d)
    valid = torch.rand(m, generator=torch.Generator().manual_seed(d)) > 0.25
    valid = valid.to(dev)
    dirty = q.clone()
    dirty[~valid] = float("nan")
    before = ops.path_counts()["assign"]
    got, want = _both(lambda b: ops.assign_clusters(
        dirty, sup_v, sup_w, dens, k, 0.1, valid, backend=b))
    assert _equal(got, want)
    assert bool((got[0][~valid] == -1).all())
    assert bool((got[1][~valid] == 0).all())
    got, want = _both(lambda b: ops.assign_clusters(
        q, sup_v, sup_w, dens, k, 0.1, backend=b))
    assert _equal(got, want)
    assert int((got[0] >= 0).sum()) > 0
    kernel = plan(m, 7, 45, d).kernel
    assert ops.path_counts()["assign"][kernel] == before[kernel] + 2


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
    ((), 5, 33, 700),                         # d wide: 32-row tiles
    ((), 7, 9, 1792),                         # the widest: 16-row tiles
    ((3,), 48, 1, 16),                        # a batch of columns
    ((3,), 65, 257, 128), ((), 1000, 63, 256), ((), 1, 1, 7)])
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
@pytest.mark.parametrize("route", ["general", "symmetric"])
def test_affinity_nan_rows(dev, route):
    """NaN in a row of q or c comes out where the plain version puts it:
    the clamp at 0 lets NaN through (torch.clamp_min), as fmaxf would not.
    On the symmetric route (q is c) a NaN row poisons its row and column.
    """
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(70, 40)).astype(np.float32),
                     device=dev)
    c = torch.tensor(rng.normal(size=(90, 40)).astype(np.float32),
                     device=dev)
    q[3, 7] = float("nan")
    c[11] = float("nan")
    if route == "symmetric":
        c[70, 3] = float("nan")
        q = c
    before = ops.path_counts()["affinity"][route]
    got, want = _both(lambda b: ops.affinity(q, c, 0.5, backend=b))
    assert ops.path_counts()["affinity"][route] == before + 1
    assert bool(torch.isnan(got[3 if route == "general" else 70]).all())
    assert bool(torch.isnan(got[:, 11]).all())
    assert _equal_nan(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 257, 333, 1000])
@pytest.mark.parametrize("d", [7, 24, 128, 256])
def test_affinity_matrix_symmetric(dev, lead, n, d):
    """affinity_matrix (the symmetric route: q and c one tensor) is bitwise
    symmetric with a zero diagonal, through the kernel and through the
    plain version, and the two are equal; the same rows passed as two
    tensors (the general route) give the same bits."""
    rng = np.random.default_rng(n * 10 + d + len(lead))
    v = torch.tensor(rng.normal(size=(*lead, n, d)).astype(np.float32) * 3,
                     device=dev)
    k = 0.2 * 24 / d
    before = ops.path_counts()["affinity"]
    got, want = _both(lambda b: affinity_matrix(v, k, backend=b))
    for a in (got, want):
        assert torch.equal(a, a.transpose(-1, -2))
        assert bool((torch.diagonal(a, dim1=-2, dim2=-1) == 0).all())
    assert torch.equal(got, want)
    two = ops.affinity(v, v.clone(), k)
    two.diagonal(dim1=-2, dim2=-1).zero_()
    assert torch.equal(two, got)
    after = ops.path_counts()["affinity"]
    assert after["symmetric"] == before["symmetric"] + 1
    assert after["general"] == before["general"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,cap,d", [(4, 48, 16), (4, 240, 128),
                                       (4, 560, 256), (32, 240, 128)])
def test_lid_solve_unfused_equals_fused(dev, bsz, cap, d):
    """lid_solve_unfused (its columns from the affinity kernel) equals
    lid_solve (the lid_sweep kernel) bit for bit."""
    st = _states(dev, bsz=bsz, cap=cap, d=d, n_valid=cap - 3)
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


# ------------------------------------------------------- flash attention ----
# the CPU suite's shapes (tests/test_torch_attention.py): the JAX tests'
# eight cases, its kv_start cases, and the ported models' widths
FLASH_CASES = [
    dict(b=1, h=4, hkv=4, sq=128, sk=128, dh=32),
    dict(b=2, h=4, hkv=2, sq=64, sk=64, dh=16),
    dict(b=1, h=8, hkv=1, sq=100, sk=100, dh=32),
    dict(b=1, h=2, hkv=2, sq=1, sk=256, dh=64, q_offset=255),
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, window=32),
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, chunk=64),
    dict(b=1, h=4, hkv=2, sq=128, sk=128, dh=32, softcap=20.0),
    dict(b=1, h=4, hkv=4, sq=96, sk=192, dh=32, q_offset=96),
    dict(b=3, h=2, hkv=2, sq=64, sk=64, dh=16, pads=True),
    dict(b=3, h=4, hkv=2, sq=64, sk=64, dh=16, window=16, pads=True),
    dict(b=2, h=2, hkv=2, sq=64, sk=64, dh=16, chunk=32, pads=True),
    dict(b=2, h=2, hkv=1, sq=1, sk=128, dh=16, q_offset=127, pads=True),
    dict(b=3, h=8, hkv=2, sq=33, sk=40, dh=80, window=16, q_offset=7,
         pads=True),
    dict(b=3, h=8, hkv=8, sq=21, sk=21, dh=4, causal=False),
    dict(b=2, h=4, hkv=2, sq=17, sk=50, dh=128, softcap=50.0, q_offset=33,
         pads=True),
    dict(b=2, h=64, hkv=1, sq=5, sk=300, dh=256, window=40, q_offset=290,
         pads=True),                          # rep 64, the widest head
    dict(b=2, h=6, hkv=2, sq=70, sk=90, dh=80, chunk=16, q_offset=20,
         pads=True),                          # rep 3: tiles of 63 rows
]


def _flash_inputs(dev, cfg, dtype, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, h, hkv, sq, sk, dh = (cfg["b"], cfg["h"], cfg["hkv"], cfg["sq"],
                             cfg["sk"], cfg["dh"])
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for shape in ((b, h, sq, dh), (b, hkv, sk, dh),
                             (b, hkv, sk, dh)))
    kv_start = None
    if cfg.get("pads"):
        kv_start = torch.randint(0, sk // 2, (b,), generator=g,
                                 dtype=torch.int32).to(dev)
    kw = dict(causal=cfg.get("causal", True), window=cfg.get("window"),
              chunk=cfg.get("chunk"), softcap=cfg.get("softcap"))
    return q, k, v, cfg.get("q_offset", 0), kv_start, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", FLASH_CASES)
def test_flash_attention_matches_plain(dev, cfg, dtype):
    """The kernel against the plain version by the stated rule
    (`compare_with_plain`): rows that attend a key within tolerance, rows
    that attend none exactly 0."""
    q, k, v, off, ks, kw = _flash_inputs(dev, cfg, dtype)
    got, want = _both(lambda b: ops.flash_attention(q, k, v, off,
                                                    kv_start=ks, backend=b,
                                                    **kw))
    assert got.dtype == dtype and got.shape == q.shape
    att = kref.attention_mask(q.shape[2], k.shape[2], off, ks, device=dev,
                              causal=kw["causal"], window=kw["window"],
                              chunk=kw["chunk"]).any(-1)
    att = att.expand(q.shape[0], -1)          # (B, Sq): rows attending a key
    res = compare_with_plain(got, want, att)
    assert res["bad"] == 0 and res["masked_nonzero"] == 0, res


@pytest.mark.cuda
def test_flash_attention_views_counts_and_limits(dev):
    """q as a transposed view (the model's layout) gives the contiguous
    result bit for bit; "auto" launches (the count moves), "ref" does not;
    dh > 256 and mixed dtypes raise."""
    cfg = FLASH_CASES[12]
    q, k, v, off, ks, kw = _flash_inputs(dev, cfg, torch.bfloat16)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)   # strided view
    assert not qt.is_contiguous()
    before = ops.launch_counts()
    ops.flash_attention(q, k, v, off, kv_start=ks, backend="ref", **kw)
    assert ops.launch_counts() == before
    a = ops.flash_attention(q, k, v, off, kv_start=ks, **kw)
    b = ops.flash_attention(qt, k, v, off, kv_start=ks, **kw)
    assert torch.equal(a, b)
    assert ops.launch_counts()["flash_attention"] == \
        before["flash_attention"] + 2
    big = torch.zeros((1, 2, 3, 264), device=dev)
    with pytest.raises(ValueError, match="head_dim 264"):
        ops.flash_attention(big, big, big)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q, k.float(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-27b"])
def test_lm_generate_kernel_equals_plain(dev, arch):
    """A packed batch of the smoke configs served on the card through the
    kernel and through the plain version: the same greedy tokens (f32
    logits of the two agree to ~1e-6; the smoke models' top-2 gaps are
    wider)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.random import PRNGKey
    from repro_torch.serve import BatchServer, ServeConfig
    cfg = get_arch(arch).SMOKE_CONFIG
    params = init_params(PRNGKey(0), cfg, device=dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in (3, 12, 7)]
    out = {}
    for backend in ("kernel", "ref"):
        srv = BatchServer(params, cfg, batch_slots=4, device=dev,
                          backend=backend,
                          scfg=ServeConfig(max_new_tokens=10))
        for p in prompts:
            srv.submit(p)
        out[backend] = srv.serve()
    for rid in out["ref"]:
        assert np.array_equal(out["kernel"][rid], out["ref"][rid])


def _segment_ids(rng, e, n, placement):
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    k = e // 5
    if placement == "leading":
        seg[:k] = -1
    elif placement == "trailing":
        seg[e - k:] = -1
    elif placement == "interspersed":
        seg[rng.choice(e, k, replace=False)] = -1
    elif placement == "unsorted":
        seg = rng.permutation(seg)
        seg[rng.choice(e, k, replace=False)] = -1
    return seg


SEGMENT_PLACEMENTS = ["leading", "trailing", "interspersed", "unsorted"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("placement", SEGMENT_PLACEMENTS)
@pytest.mark.parametrize("e,n,d", [(5000, 1300, 100), (3000, 4000, 32),
                                   (777, 50, 7), (2000, 300, 300)])
def test_segment_matmul_bitwise(dev, e, n, d, placement, dtype):
    """Every pad placement; unvisited rows (most of (3000, 4000)) exactly
    0; widths of one pass (32, 100), scalar loads (7) and several passes
    (300). NaN in the pads' rows, which are never read."""
    rng = np.random.default_rng(e + n + d)
    seg = torch.tensor(_segment_ids(rng, e, n, placement), device=dev)
    msg = torch.tensor(rng.standard_normal((e, d)).astype(np.float32),
                       device=dev).to(dtype)
    msg[seg < 0] = float("nan")
    got, want = _both(lambda b: ops.segment_matmul(msg, seg, n, backend=b))
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, want)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit[seg[seg >= 0].long()] = True
    assert bool((got[~hit] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("placement", SEGMENT_PLACEMENTS)
def test_embedding_bag_bitwise(dev, placement, dtype, mode):
    """BST-like bags of 8 ids over a 131,072 x 32 table, pads at
    `placement` (their bags -1, as models/bst.py builds them), every 17th
    bag empty, ids past the table clamped to the last row, as the JAX
    reference does. "unsorted" takes the kernel's placement for bags out
    of order; the others its in-order layout."""
    rng = np.random.default_rng(7)
    n_bags, v = 4000, 131_072
    idx = rng.integers(0, v, n_bags * 8).astype(np.int32)
    idx[_segment_ids(rng, idx.size, 2, placement) < 0] = -1
    idx.reshape(n_bags, 8)[::17] = -1
    idx[::101] = v + 5
    bags = np.repeat(np.arange(n_bags, dtype=np.int32), 8)
    if placement == "unsorted":
        order = rng.permutation(idx.size)
        idx, bags = idx[order], bags[order]
    bags = np.where(idx >= 0, bags, -1)
    table = torch.tensor(rng.standard_normal((v, 32)).astype(np.float32),
                         device=dev).to(dtype)
    idx_t = torch.tensor(idx, device=dev)
    bags_t = torch.tensor(bags, device=dev)
    got, want = _both(lambda b: ops.embedding_bag(table, idx_t, bags_t,
                                                  n_bags, mode, backend=b))
    assert got.dtype == dtype and got.shape == (n_bags, 32)
    assert torch.equal(got, want)
    empty = np.ones(n_bags, bool)
    empty[bags[bags >= 0]] = False            # bags no valid entry names
    assert empty[::17].sum() > 200
    assert bool((got[torch.tensor(empty, device=dev)] == 0).all())


@pytest.mark.cuda
def test_segment_kernels_count_and_refuse(dev):
    """"auto" launches (the counts move), "ref" does not; other dtypes and
    modes raise."""
    table = torch.randn(50, 16, device=dev)
    idx = torch.arange(40, dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    ops.embedding_bag(table, idx, idx // 4, 10, backend="ref")
    ops.segment_matmul(table, idx[:50] % 7, 7, backend="ref")
    assert ops.launch_counts() == before
    ops.embedding_bag(table, idx, idx // 4, 10)
    ops.segment_matmul(table[:40], idx % 7, 7)
    after = ops.launch_counts()
    assert after["embedding_bag"] == before["embedding_bag"] + 1
    assert after["segment_matmul"] == before["segment_matmul"] + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.segment_matmul(table.half(), idx % 7, 7)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(table, idx, idx // 4, 10, "max")


# calls that kernel_plan sends to the wgmma kernel: (B, H, Hkv, Sq, Sk, dh,
# q_offset, kv_start, keywords)
WGMMA_CASES = [
    # danube's prefill cut to 1,024 queries, three rows left-padded
    (4, 32, 8, 1024, 1041, 80, 0, [0, 1017, 1015, 1013], dict(window=512)),
    # gemma2's local and full layers: dh 128, softcap 50, rep 2
    (2, 32, 16, 512, 529, 128, 0, [0, 300], dict(window=256, softcap=50.0)),
    (2, 32, 16, 512, 529, 128, 0, [0, 300], dict(softcap=50.0)),
    # chunked, not causal, and a prefill chunk after a cache with rep 3
    (2, 8, 2, 600, 617, 128, 0, [0, 77], dict(chunk=128)),
    (2, 4, 4, 300, 300, 64, 0, [0, 50], dict(causal=False)),
    (2, 6, 2, 70, 190, 48, 120, [0, 30], dict(window=100)),
    (1, 4, 1, 130, 140, 112, 3, [2], {}),
    (2, 8, 2, 300, 333, 16, 0, [0, 30], dict(chunk=64)),
    (2, 4, 2, 100, 130, 96, 0, [0, 17], dict(window=40)),
    # past 65,535 batch rows: the batch folded into grid.x
    (70_000, 2, 1, 8, 40, 32, 32, None, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: f"B{c[0]}-dh{c[5]}-{sorted(c[8])}")
def test_wgmma_prefill_matches_plain(dev, case):
    """The tensor-core kernel (bf16, dh a multiple of 16) against the plain
    version by `compare_with_plain`, rows attending nothing exactly 0, and
    two calls bitwise equal; it is the plan's kernel and its launches are
    counted by path."""
    from repro_torch.kernels.flash_attention import kernel_plan
    b, h, hkv, sq, sk, dh, off, ks, kw = case
    mask_kw = {x: kw[x] for x in ("window", "chunk", "causal") if x in kw}
    assert kernel_plan(b, h, hkv, sq, sk, dh, off, bf16=True,
                       **mask_kw).kernel == "wgmma"
    g = torch.Generator(device="cpu").manual_seed(sq + dh)
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
               for shape in ((b, h, sq, dh), (b, hkv, sk, dh),
                             (b, hkv, sk, dh)))
    kv_start = None if ks is None else torch.tensor(ks, dtype=torch.int32,
                                                    device=dev)
    before = ops.path_counts()["flash_attention"]["wgmma"]
    got, want = _both(lambda be: ops.flash_attention(
        q, k, v, off, kv_start=kv_start, backend=be, **kw))
    again = ops.flash_attention(q, k, v, off, kv_start=kv_start, **kw)
    assert ops.path_counts()["flash_attention"]["wgmma"] == before + 2
    assert torch.equal(got, again)
    rows = kref.attention_mask(sq, sk, off, kv_start, device=dev,
                               **mask_kw).any(-1).expand(b, -1)
    res = compare_with_plain(got, want, rows)
    assert res["bad"] == 0 and res["masked_nonzero"] == 0, res


@pytest.mark.cuda
def test_flash_attention_past_65535_rows(dev):
    """BST's attention (H = Hkv = 8, Sq = Sk = 21, dh = 4, not causal) at
    B = 70,000, past the 65,535 rows that grid.z holds: within the rule,
    and each row equal to the same rows run as a batch of their own."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v = (torch.randn((70_000, 8, 21, 4), generator=g).to(dev)
               for _ in range(3))
    got, want = _both(lambda b: ops.flash_attention(q, k, v, 0, causal=False,
                                                    backend=b))
    rows = torch.ones((70_000, 21), dtype=torch.bool, device=dev)
    res = compare_with_plain(got, want, rows)
    assert res["bad"] == 0, res
    tail = ops.flash_attention(q[65_530:], k[65_530:], v[65_530:], 0,
                               causal=False)
    assert torch.equal(got[65_530:], tail)


@pytest.mark.cuda
def test_bst_serve_kernel_matches_plain(dev):
    """SMOKE_CONFIG served on the card through the kernels and through the
    plain versions (a padded multi-hot field included): logits within
    1e-5 (the attention kernel's f32 rule carried through the block and
    the MLP), and both kernels launched."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import bst_batch
    from repro_torch.models import bst as bst_m
    from repro_torch.random import PRNGKey
    from repro_torch.train.steps import make_bst_retrieval_step, \
        make_bst_serve_step
    cfg = get_arch("bst").SMOKE_CONFIG
    params = bst_m.init_params(PRNGKey(0), cfg, device=dev)
    batch = bst_batch(2, batch=300, seq_len=cfg.seq_len,
                      item_vocab=cfg.item_vocab, cat_vocab=cfg.cat_vocab,
                      multi_vocab=cfg.multi_vocab, device=dev)
    batch["multi_ids"][::3, 1, 2:] = -1
    before = ops.launch_counts()
    got = make_bst_serve_step(cfg)(params, batch)
    after = ops.launch_counts()
    assert after["embedding_bag"] > before["embedding_bag"]
    assert after["flash_attention"] > before["flash_attention"]
    want = make_bst_serve_step(cfg, backend="ref")(params, batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    user = {k: batch[k][:1] for k in ("seq_items", "seq_cats",
                                      "dense_feats", "multi_ids")}
    user.update(cand_items=batch["target_item"],
                cand_cats=batch["target_cat"])
    got, want = (make_bst_retrieval_step(cfg, backend=b)(params, user)
                 for b in ("kernel", "ref"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- GNNs ----
GNN_CASES = [("gin-tu", torch.float32, False),
             ("graphsage-reddit", torch.float32, False),
             ("meshgraphnet", torch.bfloat16, False),
             ("graphcast", torch.float32, False),
             ("graphsage-reddit", torch.float32, True),
             ("meshgraphnet", torch.float32, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype,graph_level", GNN_CASES)
def test_gnn_forward_kernel_equals_plain(dev, arch, dtype, graph_level):
    """Each GNN's SMOKE_CONFIG forward on the card through the segment
    kernel and through backend="ref": bit-equal (the segment sum is the
    only op that differs, and the kernel is bit-equal to its plain
    version), the kernel launched once a layer (twice for SAGE's mean),
    and once more for the graph-level pool. A 2,000-node full graph with
    its -1 pad edges and edge features, or 16 molecules."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import molecule_batch, \
        synth_full_graph_batch
    from repro_torch.models import gnn as gnn_m
    from repro_torch.random import PRNGKey
    cfg = dataclasses.replace(get_arch(arch).SMOKE_CONFIG, dtype=dtype,
                              graph_level=graph_level)
    if graph_level:
        b = molecule_batch(16, 30, 64, cfg.d_in, cfg.n_out, 0, 1,
                           device=dev)
        g = gnn_m.GraphBatch(b["node_feat"], b["edge_src"], b["edge_dst"],
                             graph_ids=b["graph_ids"], n_graphs=16)
    else:
        b = synth_full_graph_batch(2000, 30_000, cfg.d_in, "node_mse",
                                   cfg.n_out, 3, with_edge_feat=True,
                                   device=dev)
        g = gnn_m.GraphBatch(b["node_feat"], b["edge_src"], b["edge_dst"],
                             b["edge_feat"])
    params = gnn_m.init_params(PRNGKey(0), cfg, device=dev)
    before = ops.launch_counts()["segment_matmul"]
    got = gnn_m.forward(params, cfg, g)
    per_layer = 2 if cfg.aggregator == "mean" else 1
    assert ops.launch_counts()["segment_matmul"] == before + \
        per_layer * cfg.n_layers + int(graph_level)
    want = gnn_m.forward(params, cfg, g, backend="ref")
    assert ops.launch_counts()["segment_matmul"] == before + \
        per_layer * cfg.n_layers + int(graph_level)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)


# ------------------------------------------------- split decode, BST path ----
# decode shapes that kernel_plan sends to the split kernel: (B, H, Hkv, Sq,
# Sk, dh, q_offset, kv_start, keywords); kv_start leaves whole chunks in
# the pad (row 1), all but a few slots (row 2), or everything (row 3);
# rep x Sq query rows of 1, 2, 3, 4 and 8 a kv head
SPLIT_CASES = [
    (4, 32, 8, 1, 2100, 80, 2099, [0, 1300, 2090, 2100], dict(window=1536)),
    (3, 8, 2, 1, 3000, 64, 2999, [0, 700, 2999], dict(chunk=1024)),
    (2, 16, 8, 1, 1200, 128, 1199, [0, 600], dict(softcap=30.0)),
    (2, 4, 4, 1, 900, 16, 700, [0, 500], dict(causal=False, window=400)),
    (2, 16, 2, 1, 1500, 64, 1499, [0, 900], dict()),
    (3, 6, 2, 1, 1700, 32, 1699, [0, 5, 1600], dict(window=1000)),
    (2, 8, 4, 2, 1400, 80, 1398, [0, 1000], dict(window=800)),
    # 17 chunks of 177 slots: two tiles a block, rescaled between them
    (4, 32, 8, 1, 3000, 80, 2999, [0, 10, 2000, 2990], dict()),
]


def _split_inputs(dev, case, dtype, seed=2):
    b, h, hkv, sq, sk, dh, off, ks, kw = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for shape in ((b, h, sq, dh), (b, hkv, sk, dh),
                             (b, hkv, sk, dh)))
    kv_start = torch.tensor(ks, dtype=torch.int32, device=dev)
    return q, k, v, off, kv_start, dict(dict(causal=True), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_decode_matches_plain(dev, case, dtype):
    """The split kernel (two launches: partials, then their combine in
    chunk order) against the plain version by the stated rule, with whole
    chunks in the pad and window / chunk / softcap masks; two calls give
    the same bits."""
    from repro_torch.kernels.flash_attention import kernel_plan
    q, k, v, off, ks, kw = _split_inputs(dev, case, dtype)
    b, h, sq, dh = q.shape
    plan = kernel_plan(b, h, k.shape[1], sq, k.shape[2], dh, off,
                       causal=kw["causal"], window=kw.get("window"),
                       chunk=kw.get("chunk"))
    assert plan.kernel == "split" and plan.n_split >= 2
    got, want = _both(lambda be: ops.flash_attention(q, k, v, off,
                                                     kv_start=ks, backend=be,
                                                     **kw))
    mask_kw = {x: kw.get(x) for x in ("causal", "window", "chunk")}
    att = kref.attention_mask(sq, k.shape[2], off, ks, device=dev,
                              **mask_kw).any(-1)
    res = compare_with_plain(got, want, att)
    assert res["bad"] == 0 and res["masked_nonzero"] == 0, res
    again = ops.flash_attention(q, k, v, off, kv_start=ks, **kw)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bst_attention_path_on_views(dev, dtype):
    """BST's attention (8 heads x 21 x 21 at dh 4, not causal) through the
    small kernel with q, k and v the model's transposed views of one
    (B, 21, 3, 32) projection: the rule against the plain version, the
    same bits as contiguous copies, and a GQA case with masks."""
    from repro_torch.kernels.flash_attention import kernel_plan
    g = torch.Generator(device="cpu").manual_seed(5)
    qkv = torch.randn((300, 21, 3, 32), generator=g).to(dev, dtype)
    q, k, v = (qkv[:, :, i].view(300, 21, 8, 4).transpose(1, 2)
               for i in range(3))
    assert not k.is_contiguous()
    assert kernel_plan(300, 8, 8, 21, 21, 4, causal=False).kernel == "small"
    got, want = _both(lambda be: ops.flash_attention(q, k, v, 0,
                                                     causal=False,
                                                     backend=be))
    rows = torch.ones((300, 21), dtype=torch.bool, device=dev)
    res = compare_with_plain(got, want, rows)
    assert res["bad"] == 0, res
    assert torch.equal(got, ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), 0, causal=False))
    q, k, v, off, ks, kw = _flash_inputs(dev, dict(b=3, h=6, hkv=2, sq=9,
                                                   sk=30, dh=12, window=5,
                                                   q_offset=21, pads=True),
                                         dtype)
    got, want = _both(lambda be: ops.flash_attention(q, k, v, off,
                                                     kv_start=ks, backend=be,
                                                     **kw))
    att = kref.attention_mask(9, 30, off, ks, device=dev, causal=True,
                              window=5).any(-1)
    res = compare_with_plain(got, want, att)
    assert res["bad"] == 0 and res["masked_nonzero"] == 0, res


def _graph_equals_eager(fn):
    """fn() captured in a CUDA graph and replayed: the same bits as an
    eager call (a host read inside fn would break the capture)."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["trailing", "unsorted"])
def test_graph_capture_of_bag_and_split_decode(dev, placement):
    """ops.embedding_bag (in order and not) and the split decode record
    into a CUDA graph, whose replay equals the eager calls: neither reads
    anything back to the host."""
    rng = np.random.default_rng(9)
    seg = torch.tensor(_segment_ids(rng, 6000, 700, placement), device=dev)
    idx = torch.tensor(rng.integers(0, 5000, 6000).astype(np.int32),
                       device=dev)
    idx[seg < 0] = -1
    table = torch.randn((5000, 32), device=dev)
    assert _graph_equals_eager(lambda: ops.embedding_bag(table, idx, seg,
                                                         700))
    q, k, v, off, ks, kw = _split_inputs(dev, SPLIT_CASES[0], torch.bfloat16)
    assert _graph_equals_eager(lambda: ops.flash_attention(
        q, k, v, off, kv_start=ks, **kw))


@pytest.mark.cuda
def test_embedding_bag_layout_edges(dev):
    """The on-card layout with no entries, with only pads, with no bags,
    with bags out of order at the 4,096-entry pass blocks' edges, and
    with int64 ids: equal to the plain version."""
    table = torch.randn((300, 16), device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    assert torch.equal(ops.embedding_bag(table, none, none, 7),
                       torch.zeros((7, 16), device=dev))
    pads = torch.full((5000,), -1, dtype=torch.int32, device=dev)
    ids = torch.arange(5000, dtype=torch.int32, device=dev) % 300
    for i, b in ((pads, ids), (ids, pads), (pads, pads)):
        assert torch.equal(ops.embedding_bag(table, i, b, 9, "mean"),
                           torch.zeros((9, 16), device=dev))
    assert ops.embedding_bag(table, ids, ids, 0).shape == (0, 16)
    bags = torch.arange(12_288, device=dev) // 3
    for swap in (4095, 4096, 8191):     # one pair out of order at an edge
        b = bags.clone()
        b[swap], b[swap + 1] = bags[swap + 1] + 1, bags[swap]
        i = torch.arange(12_288, device=dev) % 301      # 300 clamps
        for it in (torch.int32, torch.int64):
            got, want = _both(lambda be: ops.embedding_bag(
                table, i.to(it), b.to(it), 4200, "mean", backend=be))
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_sea_is_bitwise_across_runs(dev):
    """SEA's transpose product goes through ops.segment_matmul, which adds
    in input order, so two runs on the card give the same bits."""
    from repro_torch.core.baselines import sea
    from repro_torch.data import make_blobs_with_noise
    spec = make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=60,
                                 d=8, seed=7, overlap_pairs=0)
    pts = torch.tensor(spec.points, device=dev)
    k = estimate_k(pts)
    g = sea.build_knn_graph(pts, k, 16)
    x = torch.rand(pts.shape[0], device=dev)
    before = ops.launch_counts()["segment_matmul"]
    a, b = sea._spmv(g, x), sea._spmv(g, x)
    assert torch.equal(a, b)
    assert ops.launch_counts()["segment_matmul"] == before + 2
    runs = [sea.sea_detect(spec.points, k, device=dev) for _ in range(2)]
    assert np.array_equal(runs[0].labels, runs[1].labels)
    assert np.array_equal(runs[0].densities, runs[1].densities)


def _online_pair(dev, tmp_path):
    """tests/test_online.py's fixture fitted on the card, and two
    OnlineClusterings over it there: the kernels' ("auto") and the plain
    versions' ("ref")."""
    from repro_torch.core.alid import ALIDConfig
    from repro_torch.core.engine import fit
    from repro_torch.core.online import OnlineClustering
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    from repro_torch.random import PRNGKey
    spec = make_blobs_with_noise(n_clusters=3, cluster_size=40, n_noise=80,
                                 d=16, seed=7, overlap_pairs=0)
    cfg = ALIDConfig(a_cap=56, delta=64,
                     lsh=auto_lsh_params(spec.points, probe=128),
                     seeds_per_round=16, max_rounds=24, exhaustive=True)
    base = fit(spec.points, cfg, PRNGKey(0), device=dev)
    assert base.n_clusters > 0
    return [OnlineClustering(
        base, spec.points,
        cfg._replace(spec=cfg.spec._replace(backend=backend)),
        ckpt_dir=str(tmp_path / backend), auto_flush=False, device=dev)
        for backend in ("auto", "ref")]


@pytest.mark.cuda
def test_online_kernel_path_equals_plain(dev, tmp_path):
    """An insert of jittered members and a support-member delete through
    the kernels (affinity_matvec and lid_sweep, one lane a call) leave the
    state bit-equal to the plain versions' on the card."""
    kern, plain = _online_pair(dev, tmp_path)
    target = int(np.argmax(kern.densities))
    members = kern.sup_idx[target][kern.sup_w[target] > 0]
    rng = np.random.default_rng(0)
    delta = (kern.points[members[:8]]
             + 0.01 * rng.standard_normal((8, kern.d))).astype(np.float32)
    before = ops.launch_counts()
    for oc in (kern, plain):
        oc.insert(delta)
        oc.delete([int(members[1])])
    after = ops.launch_counts()
    assert after["lid_sweep"] > before["lid_sweep"]
    assert after["affinity_matvec"] > before["affinity_matvec"]
    assert kern.stats.absorbed > 0
    assert kern.stats.snapshot() == plain.stats.snapshot()
    for name in ("points", "alive", "labels", "sup_idx", "sup_w", "sup_v",
                 "densities", "live"):
        assert np.array_equal(getattr(kern, name), getattr(plain, name)), \
            name
    assert kern.verify() == []


@pytest.mark.cuda
def test_online_noop_guard_through_the_kernel(dev, tmp_path):
    """One lane of the lid_sweep kernel (a cluster of 8 blocks): a stored
    support with a far candidate takes no step and returns x bit for bit,
    so a far insert changes no stored bit; a delete then re-insert of
    points outside every ball restores the state bitwise."""
    from repro_torch.core.online import _warm_lid
    kern, _ = _online_pair(dev, tmp_path)
    cfg = kern.cfg
    c = int(np.argmax(kern.densities))
    idx, w, v = (kern.sup_idx[c].copy(), kern.sup_w[c].copy(),
                 kern.sup_v[c].copy())
    slot = int(np.flatnonzero(idx < 0)[0])
    idx[slot], v[slot] = 10_000, 200.0
    before = ops.launch_counts()["lid_sweep"]
    x, _, _ = _warm_lid(*(torch.tensor(a, device=dev)
                          for a in (idx, idx >= 0, v, w)), kern.k,
                        cfg.t_lid, cfg.tol, cfg.p, cfg.support_eps, "auto",
                        cfg.sweep_steps, cfg.refresh_every)
    assert ops.launch_counts()["lid_sweep"] == before + 1
    assert np.array_equal(x.cpu().numpy(), w)

    snap = {k: getattr(kern, k).copy() for k in
            ("labels", "sup_idx", "sup_w", "sup_v", "densities", "live")}
    kern.insert(np.full((2, kern.d), 200.0, np.float32))
    kern._refresh_rois()
    live = np.flatnonzero(kern.live)
    ids = np.flatnonzero((kern.labels < 0) & kern.alive)
    dist = np.sqrt(((kern.points[ids].astype(np.float64)[:, None]
                     - kern._roi_center[live][None]) ** 2).sum(-1))
    far = ids[(dist > kern._roi_radius[live][None] * 1.05 + 0.5).all(1)][:5]
    assert far.size == 5
    rows = kern.points[far].copy()
    kern.delete(far)
    assert np.array_equal(kern.insert(rows), far)
    for name, arr in snap.items():
        assert np.array_equal(getattr(kern, name)[:len(arr)], arr), name


# ------------------------------------------- the streamed engine's pipeline --
def _big_store(tmp_path, n=120_000, d=64, shards=8):
    from repro_torch import random as trandom
    from repro_torch.core.source import InMemorySource
    from repro_torch.core.store import build_store_streamed
    from repro_torch.lsh.pstable import LSHParams
    pts = np.random.default_rng(5).normal(0, 10, (n, d)).astype(np.float32)
    return build_store_streamed(InMemorySource(pts),
                                LSHParams(seg_len=40.0),
                                trandom.PRNGKey(1), n_shards=shards,
                                scratch_dir=str(tmp_path), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 7])
def test_pipeline_uploads_equal_source_bytes(dev, tmp_path, depth):
    """Stream/event ordering: over many passes in shuffled routed orders,
    with device work queued behind every bundle, each bundle read on the
    compute stream equals the host bundle's bytes (points, keys, perm and
    global map), at ring depths 1, 2 and 7."""
    from repro_torch.core.pipeline import ShardPipeline
    store = _big_store(tmp_path)
    try:
        pipe = ShardPipeline(store, cache_bytes=0, prefetch_depth=depth,
                             device=dev)
        want = [tuple(torch.as_tensor(a.astype(np.float32 if a.dtype ==
                                                np.float32 else np.int64),
                                      device=dev)
                      for a in pipe.fetch_bundle(s))
                for s in range(store.n_shards)]
        rng = np.random.default_rng(depth)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        seen = 0
        for _ in range(12):
            routed = rng.permutation(store.n_shards)[:rng.integers(3, 9)]
            for _, s, bundle in pipe.stream(routed):
                # queued work between the copy and the check, so that a
                # missing wait would read a bundle still in flight
                busy = bundle[0] @ bundle[0].T[:, :512]
                bad += int(busy.shape[0] != bundle[0].shape[0])
                for got, ref in zip(bundle, want[s]):
                    bad += (~torch.eq(got, ref)).sum()
                seen += 1
        torch.cuda.synchronize()
        assert seen > 12 * 3 and int(bad) == 0
    finally:
        store.scratch.close()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2, 7])
def test_pipeline_device_peak_within_depth_plus_one(dev, tmp_path, depth):
    """The streamed shards hold at most (depth + 1) bundles on the card
    (two in the synchronous path), plus a margin of one bundle for the
    uint32 / int32 -> int64 conversions of an upload in flight."""
    from repro_torch.core.pipeline import ShardPipeline
    store = _big_store(tmp_path)
    try:
        pipe = ShardPipeline(store, cache_bytes=1 << 32,
                             prefetch_depth=depth, device=dev)
        one = sum(t.numel() * t.element_size() for t in next(
            iter(pipe.stream([0])))[2])
        pipe.release()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(4):
            for _, s, bundle in pipe.stream(range(store.n_shards)):
                (bundle[0] * 2.0).sum()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        assert peak <= (max(depth, 1) + 1 + 1) * one + (8 << 20), \
            (peak, one, depth)
    finally:
        store.scratch.close()


@pytest.mark.cuda
def test_sharded_and_streamed_fits_equal_replicated_on_card(dev, tmp_path):
    """Through the kernels on the card, with probe covering every bucket,
    the sharded and streamed engines (every pipeline configuration) give
    the replicated engine's clustering: canonical labels and round counts
    equal, densities within rtol 1e-6; no streamed run takes a pipeline
    fallback. (Label numbers follow the winning seed rows among density
    near-ties, which the order of a support's slots can move by an
    ulp.)"""
    from repro_torch import random as trandom
    from repro_torch.core.alid import ALIDConfig, EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    from repro_torch.lsh.pstable import build_lsh
    from repro_torch.utils import canonical_labels
    spec = make_blobs_with_noise(8, 40, 1_200, d=32, seed=2)
    lshp = auto_lsh_params(spec.points, probe=128, seg_scale=1.0)
    tables = build_lsh(torch.as_tensor(spec.points, device=dev), lshp,
                       trandom.PRNGKey(0))
    assert max(int(torch.unique(t, return_counts=True)[1].max())
               for t in tables.sorted_keys) <= lshp.probe
    cfg = ALIDConfig(a_cap=72, delta=96, lsh=lshp, seeds_per_round=16,
                     max_rounds=16)
    want = fit(spec.points, cfg, trandom.PRNGKey(0), device=dev)
    assert want.n_clusters > 0
    for espec in (EngineSpec(engine="sharded", n_shards=6),
                  EngineSpec(engine="streamed", n_shards=6, cache_bytes=0,
                             prefetch_depth=0, scratch_dir=None),
                  EngineSpec(engine="streamed", n_shards=6,
                             scratch_dir=str(tmp_path)),
                  EngineSpec(engine="streamed", n_shards=6, prefetch_depth=7,
                             cache_bytes=0, scratch_dir=str(tmp_path))):
        engine = make_engine(espec, device=dev)
        try:
            got = fit(spec.points, cfg._replace(spec=espec),
                      trandom.PRNGKey(0), engine=engine)
            if espec.engine == "streamed":
                assert engine.stats.fallbacks(
                    prefetched=espec.prefetch_depth > 0) == {}
        finally:
            engine.close()
        np.testing.assert_array_equal(canonical_labels(got.labels),
                                      canonical_labels(want.labels))
        assert got.n_rounds == want.n_rounds
        np.testing.assert_allclose(np.sort(got.densities),
                                   np.sort(want.densities), rtol=1e-6)


# ------------------------------------------------- bf16 point storage ----
def _bf16(t: torch.Tensor) -> torch.Tensor:
    return ops.to_storage(t, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(777, 24), (3584, 128), (5, 101),
                                 (100_003, 128), (100_003, 24),
                                 (20_000, 101)])
def test_lsh_hash_bf16_matches_plain(dev, n, d):
    """bf16 points on both routes (probe up to 16,384 points, stream past
    it; d = 101 loads a point element by element): the keys of the upcast
    f32 points from the f32 kernel, bit for bit, and the plain version's
    within the key-flip rule."""
    rng = np.random.default_rng(n + d)
    x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32) * 4,
                     device=dev)
    proj = torch.tensor(rng.normal(size=(3, 5, d)).astype(np.float32),
                        device=dev)
    bias = torch.tensor(rng.uniform(0, 2, (3, 5)).astype(np.float32),
                        device=dev)
    xb = _bf16(x)
    got, want = _both(lambda b: ops.lsh_hash(xb, proj, bias, 2.0, backend=b))
    assert torch.equal(got, ops.lsh_hash(xb.float(), proj, bias, 2.0))
    n_flip, near = key_flips(xb.float(), proj, bias, 2.0, got, want)
    assert near and n_flip <= 1e-4 * max(got.numel(), 1), n_flip


@pytest.mark.cuda
@pytest.mark.parametrize("per_seed,d", [(350, 24), (7168, 128), (5, 101)])
def test_roi_filter_bf16_bitwise(dev, per_seed, d):
    rng = np.random.default_rng(per_seed + 1)
    vc = _bf16(torch.tensor(rng.normal(size=(2, per_seed, d)).astype(
        np.float32), device=dev))
    center = torch.tensor(rng.normal(size=(2, d)).astype(np.float32),
                          device=dev)
    radius = torch.tensor([np.sqrt(2 * d), 0.9 * np.sqrt(2 * d)],
                          dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.integers(0, 2, (2, per_seed)).astype(bool),
                         device=dev)
    got, want = _both(lambda b: ops.roi_filter(vc, center, radius, valid,
                                               backend=b))
    assert _equal(got, want)
    assert _equal(got, ops.roi_filter(vc.float(), center, radius, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,cap,n,d", [
    (3, 48, 37, 16), (32, 240, 240, 128), (32, 240, 112, 128),
    (2, 560, 560, 256), (2, 64, 37, 2048), (2, 9, 3, 101)])
def test_affinity_matvec_bf16_bitwise(dev, bsz, cap, n, d):
    """bf16 rows on the smem route (the fit's shapes, passes at d = 256)
    and the global route (d = 2,048): the plain version's bits, and the
    f32 kernel's on the upcast rows."""
    st = _states(dev, bsz=bsz, cap=cap, d=d)
    v = _bf16(st.v_beta)
    w = st.x[:, :n] + 0.1
    c, ci = v[:, :n].contiguous(), st.beta_idx[:, :n].contiguous()
    got, want = _both(lambda b: ops.affinity_matvec(
        v, st.beta_idx, c, ci, w, K, backend=b))
    assert _equal(got, want)
    assert _equal(got, ops.affinity_matvec(v.float(), st.beta_idx,
                                           c.float(), ci, w, K))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,cap,d,refresh", [
    (3, 48, 16, 2), (32, 240, 128, 0), (1, 240, 128, 0), (7, 240, 128, 4),
    (4, 560, 256, 0), (2, 2000, 256, 0), (3, 100, 101, 3)])
def test_lid_sweep_bf16_bitwise(dev, bsz, cap, d, refresh):
    """bf16 support blocks on every cluster size and both routes (rows
    read in place at cap 2,000 x d 256), with and without the in-sweep
    refresh: the plain version's bits, and the f32 kernel's on the upcast
    rows."""
    st = _states(dev, bsz=bsz, cap=cap, d=d, n_valid=cap - 5)
    v = _bf16(st.v_beta)
    st = refresh_ax(st._replace(v_beta=v), K, backend="ref")

    def sweep(rows, b="auto"):
        return ops.lid_sweep(rows, st.beta_idx, st.beta_mask, st.x, st.ax,
                             st.n_iters, st.converged, K, n_steps=8,
                             max_iters=64, tol=1e-5, refresh_every=refresh,
                             backend=b)
    got, want = sweep(v, "kernel"), sweep(v, "ref")
    assert int(want[2].min()) > 1, "the states did not iterate"
    assert _equal(got, want)
    assert _equal(got, sweep(v.float()))


@pytest.mark.cuda
def test_bf16_mixed_pairs_raise_before_launching(dev):
    """A call whose rows mix f32 and bf16 in a way no engine produces
    raises a TypeError naming the pair, and launches nothing."""
    st = _states(dev, bsz=2, cap=48, d=16)
    v = _bf16(st.v_beta)
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="q is torch.bfloat16 and c is "
                                        "torch.float32"):
        ops.affinity_matvec(v, st.beta_idx, st.v_beta, st.beta_idx, st.x, K)
    with pytest.raises(TypeError, match="center is torch.bfloat16"):
        ops.roi_filter(st.v_beta, v[:, 0], torch.ones(2, device=dev),
                       st.beta_mask)
    with pytest.raises(TypeError, match="proj torch.bfloat16"):
        ops.lsh_hash(v[0], v[:, :3].contiguous().reshape(2, 3, 16),
                     torch.ones((2, 3), device=dev), 1.0)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_bf16_fits_bitwise_across_engines_and_backends(dev, tmp_path):
    """At bf16 storage the replicated fit through the kernels equals its
    backend="ref" fit, and the sharded and streamed engines equal it, bit
    for bit (labels, rounds, densities); the four fit kernels launch."""
    from repro_torch import random as trandom
    from repro_torch.core.alid import ALIDConfig, EngineSpec
    from repro_torch.core.engine import fit
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    spec = make_blobs_with_noise(8, 40, 1_200, d=32, seed=2)
    lshp = auto_lsh_params(spec.points, probe=128, seg_scale=1.0)
    cfg = ALIDConfig(a_cap=72, delta=96, lsh=lshp, seeds_per_round=16,
                     max_rounds=16)
    ops.reset_launch_counts()
    runs = {}
    for name, espec in (
            ("kernel", EngineSpec(dtype="bfloat16")),
            ("ref", EngineSpec(dtype="bfloat16", backend="ref")),
            ("sharded", EngineSpec(engine="sharded", n_shards=6,
                                   dtype="bfloat16")),
            ("streamed", EngineSpec(engine="streamed", n_shards=6,
                                    scratch_dir=str(tmp_path),
                                    dtype="bfloat16"))):
        runs[name] = fit(spec.points, cfg._replace(spec=espec),
                         trandom.PRNGKey(0), device=dev)
        if name == "kernel":
            counts = ops.launch_counts()
            assert all(counts[k] > 0 for k in ("lsh_hash", "roi_filter",
                                               "affinity_matvec",
                                               "lid_sweep")), counts
    want = runs["kernel"]
    assert want.n_clusters > 0
    for name, got in runs.items():
        np.testing.assert_array_equal(got.labels, want.labels, err_msg=name)
        np.testing.assert_array_equal(got.densities, want.densities,
                                      err_msg=name)
        assert got.n_rounds == want.n_rounds, name


# ------------------------------------------- the contract checker, golden --
@pytest.mark.cuda
def test_contract_check_on_card(dev):
    """The checker's runtime pass on the card: all ten ops shape-checked
    ref against kernel, the ten poison scenarios on both backends, and
    every kernel's dynamic + static shared bytes within the 232,448 a block
    at the main path's full-width shapes."""
    from repro_torch.analysis import check, contracts
    from repro_torch.kernels import _build
    ops.reset_launch_counts()
    report = check.run_checks(check.find_repo_root(), passes=("contracts",),
                              device=dev)
    assert report.ok, "\n" + report.summary()
    info = report.pass_info["contracts"]
    assert info["ops_shape_checked"] == 10
    assert info["poison_runs_by_backend"] == {"ref": 10, "kernel": 10}
    assert set(info["static_smem_by_source"]) == set(
        _build.STATIC_SMEM_SOURCES)
    assert all(b <= contracts.SMEM_BUDGET
               for b in info["smem_bytes_by_op"].values())
    # the nine forward kernels; the checker runs no backward
    assert all(n > 0 for name, n in ops.launch_counts().items()
               if not name.endswith("_bwd"))


@pytest.mark.cuda
def test_golden_ops_and_small_fit_on_card(dev):
    """The kernels' ops and the small fit + predict through them hold to
    the JAX package's golden outputs (tests/golden_torch)."""
    from repro_torch.core.alid import EngineSpec
    from repro_torch.utils import golden
    assert golden.check_ops(dev, backend="kernel") == {
        c: [] for c in golden.load("ops")[1]["cases"]}
    for spec in (EngineSpec(), EngineSpec(engine="sharded", n_shards=5)):
        problems, _ = golden.check_fit("fit_small", spec, device=dev)
        assert problems == []


# ------------------------------------------------------------- backward --
BWD_CASES = [
    # (B, H, Hkv, S, dh, dtype, mask): the tiles route at GQA 1 / 4 / 8,
    # every mask kind, dh 80 / 128 / 256, and the small route
    (2, 4, 4, 70, 16, torch.float32, dict(causal=True)),
    (1, 8, 2, 200, 80, torch.float32, dict(causal=True, window=64)),
    (1, 8, 1, 150, 128, torch.bfloat16, dict(causal=True, chunk=64,
                                               softcap=50.0)),
    (1, 4, 4, 100, 256, torch.bfloat16, dict(causal=True)),
    (3, 4, 4, 21, 4, torch.float32, dict(causal=False)),
    (2, 8, 2, 17, 16, torch.bfloat16, dict(causal=True, softcap=10.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_matches_plain(dev, case):
    """dq, dk, dv of the backward kernel against `attention_bwd_ref` by
    `compare_with_plain`'s rule (f32 rtol 2e-5 atol 1e-5; bf16 one ulp),
    two calls bitwise equal, and the autograd path through
    ops.flash_attention equal to the direct call."""
    b, h, hkv, s, dh, dt, kw = case
    g = torch.Generator(device="cpu").manual_seed(s * 7 + dh)
    q, k, v, do = (torch.randn(shape, generator=g).to(dev, dt) for shape in
                   ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh),
                    (b, h, s, dh)))
    out = ops.flash_attention(q, k, v, 0, **kw)
    got = flash_attention_bwd_cuda(q, k, v, out, do, **kw)
    want = kref.attention_bwd_ref(q, k, v, out, do, **kw)
    rows = torch.ones((b, s), dtype=torch.bool, device=dev)
    for x, y in zip(got, want):
        assert compare_with_plain(x, y, rows)["bad"] == 0
    again = flash_attention_bwd_cuda(q, k, v, out, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = ops.launch_counts()["flash_attention_bwd"]
    ops.flash_attention(qq, kk, vv, 0, **kw).backward(do)
    assert ops.launch_counts()["flash_attention_bwd"] > before
    for x, y in zip((qq.grad, kk.grad, vv.grad), got):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_bwd_kernels_match_plain(dev, dtype):
    """segment_matmul's backward (the row gather) and embedding_bag's (the
    table's segment sum, sum and mean, -1 pads, ids past the table dropped)
    bit-equal to their plain versions, and through autograd."""
    rng = np.random.default_rng(5)
    n, e, d = 300, 5000, 100
    seg = torch.tensor(rng.integers(-1, n + 3, e), device=dev)
    dout = torch.tensor(rng.normal(size=(n, d)), device=dev).to(dtype)
    got = segment_matmul_bwd_cuda(dout, seg, e)
    assert torch.equal(got, kref.segment_matmul_bwd_ref(dout, seg, e))
    msg = torch.zeros((e, d), device=dev, dtype=dtype, requires_grad=True)
    ops.segment_matmul(msg, seg, n).backward(dout)
    assert torch.equal(msg.grad, got)
    v, dim, nb = 700, 32, 400
    idx = torch.tensor(rng.integers(-1, v + 3, nb * 8), device=dev)
    bags = torch.arange(nb, device=dev).repeat_interleave(8)
    d_bags = torch.tensor(rng.normal(size=(nb, dim)), device=dev).to(dtype)
    for mode in ("sum", "mean"):
        got = embedding_bag_bwd_cuda(d_bags, idx, bags, v, mode)
        assert torch.equal(got, kref.embedding_bag_bwd_ref(
            d_bags, idx, bags, v, mode))
        table = torch.zeros((v, dim), device=dev, dtype=dtype,
                            requires_grad=True)
        ops.embedding_bag(table, idx, bags, nb, mode).backward(d_bags)
        assert torch.equal(table.grad, got)


@pytest.mark.cuda
def test_train_steps_repeat_bitwise_on_card(dev):
    """The LM (danube's smoke config in bf16, remat), GIN and BST train
    steps through the kernels: two runs from the same state give the same
    params and optimizer state bit for bit, and remat on and off the same
    LM gradients."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import lm_batch
    from repro_torch.data.recsys import bst_batch
    from repro_torch.data.graphs import synth_full_graph_batch
    from repro_torch.random import PRNGKey
    from repro_torch.train import steps as S
    from repro_torch.train.optimizers import OptConfig, tree_leaves, \
        tree_map
    opt = OptConfig(lr=1e-3, warmup=1, decay_steps=4)
    lm = dataclasses.replace(get_arch("h2o-danube-1.8b").SMOKE_CONFIG,
                             dtype=torch.bfloat16, remat=True)
    gin = get_arch("gin-tu").SMOKE_CONFIG
    bst = get_arch("bst").SMOKE_CONFIG
    cases = [
        ("lm", lm, S.make_lm_train_step(lm, opt),
         lm_batch(0, batch=2, seq_len=64, vocab=lm.vocab, device=dev)),
        ("gnn", gin, S.make_gnn_train_step(gin, opt, "node_ce"),
         synth_full_graph_batch(200, 900, gin.d_in, "node_ce", gin.n_out, 1,
                                device=dev)),
        ("recsys", bst, S.make_bst_train_step(bst, opt),
         bst_batch(1, batch=32, seq_len=bst.seq_len,
                   item_vocab=bst.item_vocab, cat_vocab=bst.cat_vocab,
                   multi_vocab=bst.multi_vocab, device=dev))]
    ops.reset_launch_counts()
    for kind, cfg, step, batch in cases:
        params, state = S.init_train_state(PRNGKey(0), kind, cfg, opt,
                                           device=dev)
        runs = []
        for _ in range(2):
            p, s = tree_map(torch.clone, params), tree_map(torch.clone,
                                                           state)
            runs.append(step(p, s, batch)[:2])
        for a, b in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
            assert torch.equal(a, b), kind
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] > 0 and counts["segment_matmul"] > 0
    assert counts["segment_matmul_bwd"] > 0 and \
        counts["embedding_bag_bwd"] > 0
    params, _ = S.init_train_state(PRNGKey(0), "lm", lm, opt, device=dev)
    toks = cases[0][3]
    grads = [S.value_and_grad(lambda p: S.lm_loss(
        p, dataclasses.replace(lm, remat=r), toks), params)[1]
        for r in (True, False)]
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)
