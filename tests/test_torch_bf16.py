"""bf16 point storage in the port (`EngineSpec(dtype="bfloat16")`) against
the JAX package's, on the CPU.

bf16 storage means three things in both packages: the points are rounded
to bf16 once, k is estimated from the UNROUNDED sample, and every distance,
affinity and LID contraction is f32 math on the rounded rows (each op
widens its storage inputs, exactly). So a port bf16 run is held against the
JAX package's f32 run on the bf16-rounded rows with k pinned to the JAX
bf16 fit's k, under the f32 parity contract of tests/test_torch_engine.py
(canonical labels equal, sorted densities within rtol 1e-6, `n_rounds`
equal).

The JAX package's own backends disagree at bf16: its Pallas
`affinity_matvec` computes the affinity in f32, its `affinity_matvec_ref`
rounds the (m, n) block to bf16 before the matvec. The port (plain version
and CUDA kernel) takes the kernel's semantics, so it differs from JAX
`ref` at bf16 in that op by up to 2^-9 relative (measured 4.3e-4 to
8.4e-4 on blocks of the fit's shape,
`test_affinity_matvec_differs_from_jax_ref_within_2_9`), and a port bf16
fit is held to a JAX `ref` bf16 fit only to equal labels and densities
within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lid as jlid
from repro.core import online as jonline
from repro.core.alid import ALIDConfig as JConfig, EngineSpec as JSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.kernels import ref as jref
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.convert import clustering_from_dict
from repro_torch.core import lid as tlid
from repro_torch.core import online as tonline
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit
from repro_torch.core.store import _round_to_storage
from repro_torch.kernels import ops
from repro_torch.lsh.pstable import LSHParams

CAP, D = 48, 16
K = 0.45


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rounded(a) -> np.ndarray:
    """f32 rows rounded to bf16 by the JAX package, as f32."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))


def _bf16(a) -> torch.Tensor:
    """f32 rows as a port bf16 tensor (the port's rounding)."""
    return ops.to_storage(torch.tensor(np.asarray(a, np.float32)),
                          "bfloat16")


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------- rounding --
_SPECIAL = {
    # a half-way tie rounds to even, either way, for both signs
    "ties": [0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000, 0x7F7F8000,
             0x00018000, 0x3F80C000, 0x3F804000],
    # subnormals stay subnormal (no flush to zero), and round
    "subnormals": [0x00000001, 0x00008000, 0x000116C2, 0x800116C2,
                   0x00808000, 0x007FFFFF, 0x80000001],
    # inf stays, the largest finite values round up to inf
    "inf": [0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF],
    # every NaN becomes the quiet NaN 0x7FC0 with its sign
    "nan": [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001,
            0x7FFFFFFF, 0xFFFFFFFF],
}


@pytest.mark.parametrize("case", sorted(_SPECIAL) + ["random"])
def test_rounding_matches_jax_bitwise(case):
    """The port's f32 -> bf16 rounding (`ops.to_storage`, and the host
    slabs' `store._round_to_storage`) is `jnp.astype(jnp.bfloat16)` bit for
    bit."""
    if case == "random":
        bits = np.random.default_rng(0).integers(
            0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    else:
        bits = np.asarray(_SPECIAL[case], np.uint32)
    vals = bits.view(np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)).view(np.uint16)
    got = _bf16(vals).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    slab = _round_to_storage(vals.reshape(1, -1).copy(), "bfloat16")
    np.testing.assert_array_equal(_bits(slab[0]), _bits(_rounded(vals)))


# ------------------------------------------------------------ the four ops --
def _live_np(seed: int = 0):
    """tests/test_lid_sweep.py's live state at f32 (4 clusters, full range,
    x at slot 0), its rows rounded to bf16, Ax refreshed on the rounded
    rows by the JAX package: (the f32 rows, the rounded rows as f32, the
    JAX bf16 state)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, D)) * 3.0
    pts = np.concatenate(
        [c + rng.normal(size=(CAP // 4, D)) for c in centers]).astype(
            np.float32)
    v16 = jnp.asarray(pts).astype(jnp.bfloat16)
    st = jlid.init_state(v16, jnp.int32(0), CAP)._replace(
        beta_idx=jnp.arange(CAP, dtype=jnp.int32),
        beta_mask=jnp.ones(CAP, bool), v_beta=v16)
    st = jlid.refresh_ax(st, jnp.float32(K), backend="ref")
    return pts, np.asarray(v16.astype(jnp.float32)), st


def _port_sweep(v, st, **kw):
    """The port's sweep of one lane from the JAX state `st` over rows v."""
    return ops.lid_sweep(
        v[None], torch.tensor(np.asarray(st.beta_idx))[None],
        torch.tensor(np.asarray(st.beta_mask))[None],
        torch.tensor(np.asarray(st.x))[None],
        torch.tensor(np.asarray(st.ax))[None],
        torch.tensor(np.asarray(st.n_iters)).reshape(1),
        torch.tensor(np.asarray(st.converged)).reshape(1), K, tol=1e-5,
        **kw)


@pytest.mark.parametrize("refresh_every", [0, 2])
def test_lid_sweep_bf16_is_f32_on_upcast_rows(refresh_every):
    """The plain sweep on bf16 rows gives, bit for bit, the sweep on their
    upcast f32 rows; against the JAX oracle on the same bf16 state (which
    upcasts once too) its steps agree as at f32 (tests/test_torch_kernels.
    py): x and Ax to rtol 1e-5, n_iters and converged equal."""
    _, v32, st = _live_np(1)
    kw = dict(n_steps=1, max_iters=64, refresh_every=refresh_every)
    got = _port_sweep(_bf16(v32), st, **kw)
    want32 = _port_sweep(torch.tensor(v32), st, **kw)
    for g, w in zip(got, want32):
        assert torch.equal(g, w)
    jx, jax_, jit, jcv = jref.lid_sweep_ref(
        st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
        st.converged, jnp.float32(K), 1, 64, 1e-5, 2.0, refresh_every)
    np.testing.assert_allclose(_np(got[0][0]), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got[1][0]), np.asarray(jax_), rtol=1e-5,
                               atol=1e-6)
    assert int(got[2][0]) == int(jit) and bool(got[3][0]) == bool(jcv)


def _matvec_case(seed=10, m=96, n=57, d=24):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    q_idx = rng.integers(-1, max(m, n), m).astype(np.int32)
    c_idx = rng.integers(-1, max(m, n), n).astype(np.int32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    return q, q_idx, c, c_idx, w


def test_affinity_matvec_bf16_matches_jax_on_upcast_rows():
    """At bf16 the port computes the affinity in f32 on the upcast rows:
    bitwise its own f32 op on those rows, and JAX `ref` on them to rtol
    1e-6 (XLA sums the distance's d-sums in its own order)."""
    q, q_idx, c, c_idx, w = _matvec_case()
    ti, tci, tw = map(torch.tensor, (q_idx, c_idx, w))
    got = ops.affinity_matvec(_bf16(q), ti, _bf16(c), tci, tw, 0.37)
    up = ops.affinity_matvec(torch.tensor(_rounded(q)), ti,
                             torch.tensor(_rounded(c)), tci, tw, 0.37)
    assert got.dtype == torch.float32 and torch.equal(got, up)
    want = np.asarray(jref.affinity_matvec_ref(
        jnp.asarray(_rounded(q)), jnp.asarray(q_idx),
        jnp.asarray(_rounded(c)), jnp.asarray(c_idx), jnp.asarray(w),
        jnp.float32(0.37)))
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_affinity_matvec_differs_from_jax_ref_within_2_9(seed):
    """The accepted divergence (ROADMAP C): JAX `ref` rounds the affinity
    block to bf16 before its matvec, the port does not (the JAX Pallas
    kernel's semantics). Every term a_j w_j is non-negative and rounding
    moves a_j by at most 2^-9 of itself, so an output differs by at most
    2^-9 (~1.95e-3) relative, f32 rounding aside. On these (240, 128) x
    (112, 128) blocks of the fit's shape (4 blobs, simplex weights) the
    two differ by 4.3e-4 to 8.4e-4 relative: the outputs do differ."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 128)) * 3.0
    q = np.concatenate([ctr + rng.normal(size=(60, 128))
                        for ctr in centers]).astype(np.float32)
    c, idx = q[:112], np.arange(240, dtype=np.int32)
    w = rng.uniform(0, 1, 112).astype(np.float32)
    w /= w.sum()
    got = _np(ops.affinity_matvec(_bf16(q), torch.tensor(idx), _bf16(c),
                                  torch.tensor(idx[:112]), torch.tensor(w),
                                  0.37))
    want = np.asarray(jref.affinity_matvec_ref(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(c).astype(jnp.bfloat16), jnp.asarray(idx[:112]),
        jnp.asarray(w), jnp.float32(0.37)))
    rel = np.abs(got - want) / np.abs(want)
    assert 1e-5 < rel.max() <= 2.0 ** -9 * (1 + 1e-3), rel.max()


def test_roi_filter_bf16_matches_jax_and_upcast_rows():
    rng = np.random.default_rng(12)
    vc = rng.normal(size=(3, 777, 16)).astype(np.float32)
    center = rng.normal(size=(3, 16)).astype(np.float32)
    valid = rng.integers(0, 2, (3, 777)).astype(bool)
    radius = np.float32(0.9 * 4.0)
    got = ops.roi_filter(_bf16(vc), torch.tensor(center), float(radius),
                         torch.tensor(valid))
    up = ops.roi_filter(torch.tensor(_rounded(vc)), torch.tensor(center),
                        float(radius), torch.tensor(valid))
    for g, u in zip(got, up):
        assert torch.equal(g, u)
    for b in range(3):
        wd, wv, wn = (np.asarray(a) for a in jref.roi_filter_ref(
            jnp.asarray(vc[b]).astype(jnp.bfloat16), jnp.asarray(center[b]),
            radius, jnp.asarray(valid[b])))
        np.testing.assert_allclose(_np(got[0][b]), wd, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(got[1][b]).astype(bool), wv)
        np.testing.assert_allclose(_np(got[2][b])[wv], wn[wv], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("n,d,L,m", [(300, 32, 4, 8), (128, 128, 1, 2)])
def test_lsh_hash_bf16_keys_match_jax_and_upcast_rows(n, d, L, m):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    proj = rng.normal(size=(L, m, d)).astype(np.float32)
    bias = rng.uniform(0, 1, size=(L, m)).astype(np.float32)
    tp, tb = torch.tensor(proj), torch.tensor(bias)
    got = ops.lsh_hash(_bf16(x), tp, tb, 0.7)
    assert torch.equal(got, ops.lsh_hash(torch.tensor(_rounded(x)), tp, tb,
                                         0.7))
    want = np.asarray(jref.lsh_hash_ref(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(proj),
        jnp.asarray(bias), 0.7))
    np.testing.assert_array_equal(_np(got).astype(np.int32), want)


def test_mixed_storage_pairs_raise_on_the_kernel_path(monkeypatch):
    """A kernel call whose rows mix f32 and bf16 in a way no engine
    produces raises a TypeError naming the pair, before anything launches
    (on the CPU the kernel path is forced; the check precedes the card's)."""
    from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
    from repro_torch.kernels.lsh_hash import lsh_hash_cuda
    from repro_torch.kernels.roi_filter import roi_filter_cuda
    q = torch.ones((1, 4, 8))
    idx = torch.zeros((1, 4), dtype=torch.int32)
    w = torch.ones((1, 4))
    monkeypatch.setattr("repro_torch.kernels.affinity_matvec.require_cuda",
                        lambda *a: None)
    monkeypatch.setattr("repro_torch.kernels.roi_filter.require_cuda",
                        lambda *a: None)
    monkeypatch.setattr("repro_torch.kernels.lsh_hash.require_cuda",
                        lambda *a: None)
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="q is torch.float32 and c is "
                                        "torch.bfloat16"):
        affinity_matvec_cuda(q, idx, q.bfloat16(), idx, w, 0.5)
    with pytest.raises(TypeError, match="vc is torch.float32 and center is "
                                        "torch.bfloat16"):
        roi_filter_cuda(q, torch.ones((1, 8), dtype=torch.bfloat16),
                        torch.ones(1), torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(TypeError, match="x is torch.bfloat16 and proj "
                                        "torch.bfloat16"):
        lsh_hash_cuda(q[0].bfloat16(), torch.ones((2, 3, 8),
                                                  dtype=torch.bfloat16),
                      torch.ones((2, 3)), 1.0)
    assert ops.launch_counts() == before


# ------------------------------------------ tests/test_lid_sweep.py mirrored --
def _port_state(v: torch.Tensor) -> tlid.LIDState:
    st = tlid.init_state(v, torch.zeros(1, dtype=torch.int32), CAP)
    st = st._replace(beta_idx=torch.arange(CAP, dtype=torch.int32)[None],
                     beta_mask=torch.ones((1, CAP), dtype=torch.bool),
                     v_beta=v[None])
    return tlid.refresh_ax(st, K)


def test_bf16_storage_matches_f32_support():
    """tests/test_lid_sweep.py's case on the port: bf16 v_beta storage (f32
    accumulators) finds the SAME support set as f32 storage, densities
    within 5e-3; the bf16 solve equals the f32 solve on the upcast rows
    bit for bit, and its support is the JAX package's bf16 `ref` solve's,
    its density within 5e-4 (that solve starts from an Ax refreshed
    through the bf16-rounded affinity block: the divergence above)."""
    pts, v32, jst = _live_np(0)
    r32 = tlid.lid_solve(_port_state(torch.tensor(pts)), K, max_iters=200)
    r16 = tlid.lid_solve(_port_state(_bf16(pts)), K, max_iters=200)
    up = tlid.lid_solve(_port_state(torch.tensor(v32)), K, max_iters=200)
    assert r16.v_beta.dtype == torch.bfloat16
    assert r16.x.dtype == torch.float32 and r16.ax.dtype == torch.float32
    assert torch.equal(r16.x, up.x) and torch.equal(r16.ax, up.ax)
    sup16 = _np(r16.beta_mask & (r16.x > 1e-6))[0]
    np.testing.assert_array_equal(sup16,
                                  _np(r32.beta_mask & (r32.x > 1e-6))[0])
    np.testing.assert_allclose(float(tlid.density(r16)[0]),
                               float(tlid.density(r32)[0]), rtol=5e-3)
    jr = jlid.lid_solve(jst, jnp.float32(K), max_iters=200, backend="ref")
    np.testing.assert_array_equal(
        sup16, np.asarray(jr.beta_mask & (jr.x > 1e-6)))
    np.testing.assert_allclose(float(tlid.density(r16)[0]),
                               float(jlid.density(jr)), rtol=5e-4)


def test_bf16_sweep_kernel_semantics_match_ref():
    """tests/test_lid_sweep.py's interpret-vs-ref case, held on the port
    against `ref`: the upcast-once-then-f32 contract. A sweep of 8 steps
    on bf16 rows equals the same sweep on the upcast rows bit for bit, and
    the JAX `ref` sweep on the bf16 state to rtol 1e-5."""
    _, v32, st = _live_np(0)
    got = _port_sweep(_bf16(v32), st, n_steps=8, max_iters=64)
    up = _port_sweep(torch.tensor(v32), st, n_steps=8, max_iters=64)
    for g, u in zip(got, up):
        assert torch.equal(g, u)
    want = jref.lid_sweep_ref(
        st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
        st.converged, jnp.float32(K), 8, 64, 1e-5, 2.0, 0)
    assert int(want[2]) > 1, "state did not iterate: test is vacuous"
    np.testing.assert_allclose(_np(got[0][0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    assert int(got[2][0]) == int(want[2])


# -------------------------------------------------------------------- fits --
@pytest.fixture(scope="module")
def fixture():
    """tests/test_lid_sweep.py::test_bf16_engine_parity_interpret's data
    and config, with the JAX package's bf16 ref fit, and its f32 ref fit on
    the bf16-rounded rows with k pinned to the bf16 fit's k."""
    blobs = make_blobs_with_noise(n_clusters=3, cluster_size=16, n_noise=40,
                                  d=8, seed=3, overlap_pairs=0)
    lshp = auto_lsh_params(blobs.points, probe=64)
    jcfg = JConfig(a_cap=24, delta=24, lsh=lshp, seeds_per_round=8,
                   max_rounds=10, t_lid=128)
    j16 = jfit(blobs.points, jcfg._replace(
        spec=JSpec(backend="ref", dtype="bfloat16")), jax.random.PRNGKey(0))
    j32 = jfit(_rounded(blobs.points), jcfg._replace(
        k=float(j16.k), spec=JSpec(backend="ref")), jax.random.PRNGKey(0))
    tcfg = ALIDConfig(a_cap=24, delta=24, lsh=LSHParams(*lshp),
                      seeds_per_round=8, max_rounds=10, t_lid=128)
    return blobs, tcfg, j16, j32


_SPECS = {"replicated": {}, "sharded": dict(n_shards=4),
          "streamed": dict(n_shards=4, chunk_size=23)}


@pytest.fixture(scope="module")
def port_fits(fixture):
    blobs, tcfg, _, _ = fixture
    return {engine: fit(blobs.points, tcfg._replace(spec=EngineSpec(
        engine=engine, dtype="bfloat16", **kw)), trandom.PRNGKey(0),
        device="cpu") for engine, kw in _SPECS.items()}


@pytest.mark.parametrize("engine", sorted(_SPECS))
def test_bf16_fit_is_the_f32_fit_on_rounded_rows(fixture, port_fits,
                                                 engine):
    """Each engine's bf16 fit against the JAX package's f32 fit on the
    rounded rows at the JAX bf16 fit's k, to the f32 parity contract; its
    supports are exported as f32 rows of the (unrounded) source, as in the
    JAX package."""
    blobs, _, j16, j32 = fixture
    got = port_fits[engine]
    assert j32.n_clusters > 0
    np.testing.assert_allclose(got.k, j16.k, rtol=1e-5)
    np.testing.assert_array_equal(canonical_labels(got.labels),
                                  canonical_labels(j32.labels))
    np.testing.assert_allclose(np.sort(got.densities),
                               np.sort(j32.densities), rtol=1e-6)
    assert got.n_rounds == j32.n_rounds
    assert got.support_v.dtype == np.float32
    sup = got.support_idx >= 0
    np.testing.assert_array_equal(
        got.support_v[sup], blobs.points[got.support_idx[sup]])


def test_bf16_fits_are_bit_identical_across_engines(port_fits):
    """Rounding happens once, before hashing: every engine sees the same
    keys and LID inputs, so the three bf16 fits are bitwise one."""
    rep = port_fits["replicated"]
    for engine in ("sharded", "streamed"):
        got = port_fits[engine]
        np.testing.assert_array_equal(got.labels, rep.labels)
        np.testing.assert_array_equal(_bits(got.densities),
                                      _bits(rep.densities))
        np.testing.assert_array_equal(got.support_w, rep.support_w)
        assert got.n_rounds == rep.n_rounds


def test_bf16_fit_against_jax_ref_bf16(fixture, port_fits):
    """Held to the JAX `ref` bf16 fit itself, whose matvec rounds the
    affinity block (the divergence above): canonical labels equal,
    densities within 5e-4."""
    _, _, j16, _ = fixture
    got = port_fits["replicated"]
    np.testing.assert_array_equal(canonical_labels(got.labels),
                                  canonical_labels(j16.labels))
    np.testing.assert_allclose(np.sort(got.densities),
                               np.sort(j16.densities), rtol=5e-4)


# ------------------------------------------------------------------ online --
ARRAYS = ("alive", "labels", "sup_idx", "live")


def _assert_same(j, t):
    """tests/test_torch_online.py's `_assert_same` with the port's host
    rows held after rounding: the port keeps the rows it was given (as the
    JAX package does at bf16), the JAX side was given rounded rows."""
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    for k in ("points", "sup_v"):
        np.testing.assert_array_equal(_bits(_rounded(getattr(t, k))),
                                      _bits(getattr(j, k)), err_msg=k)
    np.testing.assert_allclose(t.densities, j.densities, rtol=1e-5)
    np.testing.assert_allclose(t.sup_w, j.sup_w, rtol=0, atol=5e-4)
    assert t.stats.snapshot() == j.stats.snapshot()
    assert t.outliers == j.outliers and t._free == j._free
    assert t.epoch_id == j.epoch_id
    assert t.verify() == [] and j.verify() == []


def test_bf16_online_updates_match_jax_f32_on_rounded_rows(tmp_path):
    """`OnlineClustering` at bf16 on tests/test_online.py's fixture against
    the JAX package's at f32, every row given to the JAX side rounded to
    bf16, both over the JAX f32 fit of the rounded rows (so at its k): an
    8-row insert, a support-member delete, commit, rollback(0) and forward
    again. The port's warm re-convergences and routing balls run on its
    rows cast to bf16, which are the JAX side's rows."""
    blobs = make_blobs_with_noise(n_clusters=3, cluster_size=40, n_noise=80,
                                  d=16, seed=7, overlap_pairs=0)
    pts16 = _rounded(blobs.points)
    jcfg = JConfig(a_cap=56, delta=64,
                   lsh=auto_lsh_params(blobs.points, probe=128),
                   seeds_per_round=16, max_rounds=24, exhaustive=True,
                   spec=JSpec(backend="ref"))
    jbase = jfit(pts16, jcfg, jax.random.PRNGKey(0))
    assert jbase.n_clusters > 0
    tcfg = ALIDConfig(a_cap=56, delta=64, lsh=LSHParams(*jcfg.lsh),
                      seeds_per_round=16, max_rounds=24, exhaustive=True,
                      spec=EngineSpec(dtype="bfloat16"))
    j = jonline.OnlineClustering(jbase, pts16, jcfg,
                                 rng=jax.random.PRNGKey(5),
                                 ckpt_dir=str(tmp_path / "jax"),
                                 auto_flush=False)
    # the port's base holds the unrounded rows of its points, as a port
    # bf16 fit exports them (f32 rows of the source)
    tbase = jbase.to_dict()
    sup = tbase["support_idx"] >= 0
    tbase["support_v"] = (blobs.points[np.clip(tbase["support_idx"], 0,
                                               None)] * sup[..., None])
    t = tonline.OnlineClustering(clustering_from_dict(tbase),
                                 blobs.points, tcfg, rng=trandom.PRNGKey(5),
                                 ckpt_dir=str(tmp_path / "port"),
                                 auto_flush=False, device="cpu")
    _assert_same(j, t)
    target = int(np.argmax(t.densities))
    members = t.sup_idx[target][t.sup_w[target] > 0]
    delta = (blobs.points[members[:8]] + 0.01 * np.random.default_rng(
        0).standard_normal((8, t.d))).astype(np.float32)
    t.insert(delta)
    j.insert(_rounded(delta))
    assert t.stats.routed == 8 and t.stats.absorbed > 0
    _assert_same(j, t)
    for oc in (j, t):
        oc.delete([int(members[1])])
    assert t.stats.reconverges >= 2
    _assert_same(j, t)
    t.commit({"note": "delta"})
    j.commit({"note": "delta"})
    mutated = {k: np.array(getattr(t, k)) for k in
               ("labels", "sup_idx", "sup_w", "sup_v", "densities")}
    assert t.rollback(0) == 0 == j.rollback(0)
    _assert_same(j, t)
    t.rollback(1)
    j.rollback(1)
    for k, v in mutated.items():
        np.testing.assert_array_equal(getattr(t, k), v, err_msg=k)
    _assert_same(j, t)
