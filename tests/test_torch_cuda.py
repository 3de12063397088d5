"""The port's CUDA kernels against their plain PyTorch versions, on the
card. `roi_filter`, `affinity_matvec`, `lid_sweep`, `assign`, `affinity`,
`embedding_bag` and `segment_matmul` sum in the pinned orders of
`repro_torch.kernels.ref` with separate multiplies and adds, so their
outputs must be bit-equal. `lsh_hash` sums
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
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import compare_with_plain
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
