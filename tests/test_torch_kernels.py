"""The port's kernel layer (`repro_torch.kernels`) against the JAX package's.

On the CPU every op runs its plain PyTorch version; the JAX side runs its
jnp oracles (`repro.kernels.ref`, the "ref" backend). Tolerances:

- `tree_matvec` and the LSH keys are exact: equal inputs, equal bits.
- The p=2 distance expansion |q|^2 + |c|^2 - 2 q.c sums over d, the port
  in its pinned order (`kernels.ref.pinned_sum`) and XLA in its own, so
  affinities, matvecs and the LID state agree to f32 rounding: rtol 1e-5
  with atol 1e-5 on quantities of order 1, the shapes and tolerances of
  the JAX package's own kernel tests (tests/test_kernels.py,
  tests/test_lid_sweep.py).
- Integer outputs of the sweep (n_iters, converged) are equal.

The CUDA kernels themselves are compared with these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lid as jlid
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

CAP, D = 48, 16
K = 0.45

# the JAX oracles, compiled once per shape (op-by-op dispatch is slower);
# tree_matvec stays eager: under jit XLA's CPU backend may contract the
# products and the first level of adds into FMAs, which the pinned order
# (and the port, and its CUDA kernel) does not do
_j_matvec = jax.jit(jref.affinity_matvec_ref)
_j_roi = jax.jit(jref.roi_filter_ref)
_j_lsh = jax.jit(jref.lsh_hash_ref, static_argnums=(3,))


def _t(a, dtype=None):
    """numpy/jax array -> a CPU tensor (copied, so it is writable)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ tree_matvec --
@pytest.mark.parametrize("m,n", [(1, 1), (5, 7), (48, 48), (33, 130),
                                 (240, 112)])
def test_tree_matvec_bitwise(m, n):
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    want = np.asarray(jref.tree_matvec(jnp.asarray(a), jnp.asarray(w)))
    got = _np(ref.tree_matvec(_t(a), _t(w)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a leading seed batch reduces each lane in the same order
    got_b = _np(ref.tree_matvec(_t(np.stack([a, a])), _t(np.stack([w, w]))))
    np.testing.assert_array_equal(got_b[1].view(np.uint32),
                                  want.view(np.uint32))


# --------------------------------------------------------------- lsh hash --
@pytest.mark.parametrize("n,d,L,m", [(64, 8, 2, 4), (300, 32, 4, 8),
                                     (128, 128, 1, 2)])
def test_lsh_hash_keys_equal(n, d, L, m):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    proj = rng.normal(size=(L, m, d)).astype(np.float32)
    bias = rng.uniform(0, 1, size=(L, m)).astype(np.float32)
    want = np.asarray(_j_lsh(jnp.asarray(x), jnp.asarray(proj),
                             jnp.asarray(bias), 0.7))
    got = _np(ops.lsh_hash(_t(x), _t(proj), _t(bias), 0.7))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)          # zero flips


def test_mix_fold_wraps_mod_2_32():
    """The multiply-xor fold on int64 words equals uint32 arithmetic,
    including products far past 2**32."""
    rng = np.random.default_rng(4)
    h = rng.integers(0, 2 ** 32, size=(1000, 8), dtype=np.uint64)
    acc = np.full(1000, 0x811C9DC5, np.uint64)
    for j in range(8):
        acc = ((acc ^ h[:, j]) * np.uint64(0x9E3779B1)) & np.uint64(
            0xFFFFFFFF)
        acc ^= acc >> np.uint64(15)
    got = _np(ref.mix_fold(torch.tensor(h.astype(np.int64))))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  acc.astype(np.uint32))


# -------------------------------------------------------- affinity matvec --
@pytest.mark.parametrize("m,n,d", [(16, 16, 8), (96, 33, 16), (130, 257, 100),
                                   (192, 64, 128), (1, 7, 5)])
def test_affinity_matvec_matches_jax(m, n, d):
    rng = np.random.default_rng(10)
    q = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    q_idx = rng.integers(-1, max(m, n), m).astype(np.int32)
    c_idx = rng.integers(-1, max(m, n), n).astype(np.int32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    want = np.asarray(_j_matvec(
        jnp.asarray(q), jnp.asarray(q_idx), jnp.asarray(c),
        jnp.asarray(c_idx), jnp.asarray(w), jnp.float32(0.37)))
    got = _np(ops.affinity_matvec(_t(q), _t(q_idx), _t(c), _t(c_idx), _t(w),
                                  0.37))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the seed batch: lane b equals the unbatched op
    got_b = _np(ops.affinity_matvec(_t(np.stack([q, q])),
                                    _t(np.stack([q_idx, q_idx])),
                                    _t(np.stack([c, c])),
                                    _t(np.stack([c_idx, c_idx])),
                                    _t(np.stack([w, w])), 0.37))
    np.testing.assert_allclose(got_b[1], want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- ROI filter --
@pytest.mark.parametrize("n,d", [(64, 8), (777, 16), (4096, 32), (3, 100)])
def test_roi_filter_matches_jax(n, d):
    rng = np.random.default_rng(12)
    vc = rng.normal(size=(n, d)).astype(np.float32)
    center = rng.normal(size=(d,)).astype(np.float32)
    valid = rng.integers(0, 2, n).astype(bool)
    radius = np.float32(0.9 * np.sqrt(d))
    wd, wv, wn = (np.asarray(a) for a in _j_roi(
        jnp.asarray(vc), jnp.asarray(center), radius, jnp.asarray(valid)))
    gd, gv, gn = (_np(a) for a in ops.roi_filter(_t(vc), _t(center),
                                                 float(radius), _t(valid)))
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.isinf(gn), np.isinf(wn))
    np.testing.assert_allclose(gn[wv], wn[wv], rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- LID sweep --
def _live_np(seed: int = 0):
    """tests/test_lid_sweep.py's live state: 4 clusters, full range, x at
    slot 0, Ax refreshed, as numpy (v, idx, mask, x, ax)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, D)) * 3.0
    pts = np.concatenate(
        [c + rng.normal(size=(CAP // 4, D)) for c in centers])
    v = jnp.asarray(pts, jnp.float32)
    st = jlid.init_state(v, jnp.int32(0), CAP)._replace(
        beta_idx=jnp.arange(CAP, dtype=jnp.int32),
        beta_mask=jnp.ones(CAP, bool), v_beta=v)
    st = jlid.refresh_ax(st, jnp.float32(K), backend="ref")
    return st


_jax_sweep_jit = jax.jit(jref.lid_sweep_ref,
                         static_argnums=(8, 9, 10, 11, 12))


def _jax_sweep(st, n_steps=8, max_iters=64, refresh_every=0, it=None,
               cv=None, x=None, ax=None):
    return _jax_sweep_jit(
        st.v_beta, st.beta_idx, st.beta_mask,
        st.x if x is None else x, st.ax if ax is None else ax,
        st.n_iters if it is None else it,
        st.converged if cv is None else cv, jnp.float32(K), n_steps,
        max_iters, 1e-5, 2.0, refresh_every)


def _port_args(states):
    """Stack JAX LIDStates into the port's batched sweep arguments."""
    return (_t(np.stack([np.asarray(s.v_beta) for s in states])),
            _t(np.stack([np.asarray(s.beta_idx) for s in states])),
            _t(np.stack([np.asarray(s.beta_mask) for s in states])),
            _t(np.stack([np.asarray(s.x) for s in states])),
            _t(np.stack([np.asarray(s.ax) for s in states])),
            _t(np.stack([np.asarray(s.n_iters) for s in states])),
            _t(np.stack([np.asarray(s.converged) for s in states])))


def _port_sweep(args, n_steps=8, max_iters=64, refresh_every=0):
    return ops.lid_sweep(*args, K, n_steps=n_steps, max_iters=max_iters,
                         tol=1e-5, refresh_every=refresh_every)


def _argmax_margin(st_x, st_ax, mask, tol=1e-5) -> float:
    """Relative gap between the two best C1 u C2 scores |r| of a state: a
    near-zero gap is an argmax near-tie."""
    x, ax = np.asarray(st_x, np.float64), np.asarray(st_ax, np.float64)
    r = np.where(mask, ax - (x * ax).sum(), 0.0)
    ok = mask & ((r > tol) | ((r < -tol) & (x > 0)))
    s = np.sort(np.abs(r[ok]))[::-1]
    return 1.0 if s.size < 2 else float((s[0] - s[1]) / s[0])


@pytest.mark.parametrize("refresh_every", [0, 2])
def test_lid_sweep_steps_match_jax(refresh_every):
    """Each LID step of the port against the JAX oracle's step from the SAME
    state, chained along the JAX trajectory. A step's argmax over |r| is a
    discontinuous function of rounding: where the two best scores lie within
    1e-4 of each other, either package may pick either slot (both are
    valid LID steps, and the paths then reach the same fixed point, see
    tests/test_torch_core.py). Such near-tie steps are counted, must stay
    rare, and are not compared; every other step must agree."""
    compared = ties = 0
    for seed in range(4):
        st = _live_np(seed)
        x, ax, it, cv = st.x, st.ax, st.n_iters, st.converged
        mask = np.asarray(st.beta_mask)
        for _ in range(24):
            want = _jax_sweep(st, n_steps=1, refresh_every=refresh_every,
                              it=it, cv=cv, x=x, ax=ax)
            args = _port_args([st._replace(x=x, ax=ax, n_iters=it,
                                           converged=cv)])
            got = _port_sweep(args, n_steps=1, refresh_every=refresh_every)
            if _argmax_margin(x, ax, mask) < 1e-4:
                ties += 1
            else:
                compared += 1
                np.testing.assert_allclose(_np(got[0][0]), np.asarray(want[0]),
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(_np(got[1][0]), np.asarray(want[1]),
                                           rtol=1e-5, atol=1e-6)
                assert int(got[2][0]) == int(want[2])
                assert bool(got[3][0]) == bool(want[3])
            x, ax, it, cv = want
            if bool(cv):
                break
    assert compared >= 40 and ties <= compared // 10, (compared, ties)


def test_lid_sweep_lanes_equal_single_seeds():
    """Seeds as lanes: a batch of four gives each lane the bits of that
    seed run alone (the semantics of the JAX package's vmap): every sum of
    the sweep is pinned, none depends on the batch."""
    states = [_live_np(s) for s in range(4)]
    batch = _port_sweep(_port_args(states), n_steps=8)
    for b, st in enumerate(states):
        one = _port_sweep(_port_args([st]), n_steps=8)
        for a, c in zip(batch, one):
            assert torch.equal(a[b], c[0])


def test_lid_sweep_converged_state_is_noop():
    st = _live_np()
    done = jlid.lid_solve(st, jnp.float32(K), max_iters=200, backend="ref")
    args = _port_args([done])
    again = _port_sweep(args)
    assert torch.equal(again[0], args[3]) and torch.equal(again[1], args[4])
    assert int(again[2][0]) == int(done.n_iters)
    assert bool(again[3][0])


def test_lid_sweep_op_level_chunking_bit_neutral():
    """One n_steps=8 sweep == eight n_steps=1 sweeps, bitwise."""
    args = _port_args([_live_np(0), _live_np(1)])
    one = _port_sweep(args, n_steps=8, max_iters=8)
    v, idx, mask, x, ax, it, cv = args
    for _ in range(8):
        x, ax, it, cv = _port_sweep((v, idx, mask, x, ax, it, cv),
                                    n_steps=1, max_iters=8)
    for a, b in zip(one, (x, ax, it, cv)):
        assert torch.equal(a, b)


def test_lid_sweep_max_iters_is_cumulative():
    args = _port_args([_live_np()])
    x, ax, it, cv = _port_sweep(args, n_steps=8, max_iters=10)
    assert int(it[0]) == 8 and not bool(cv[0])
    x, ax, it, cv = _port_sweep(args[:3] + (x, ax, it, cv), n_steps=8,
                                max_iters=10)
    assert int(it[0]) == 10


# --------------------------------------------- padded-tail poison checks --
def _bits_equal(a, b) -> bool:
    return np.array_equal(_np(a).view(np.uint8), _np(b).view(np.uint8))


def test_poison_affinity_matvec_q_and_c_side():
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(32, 8)).astype(np.float32))
    c = _t(rng.normal(size=(64, 8)).astype(np.float32))
    qi = torch.arange(32, dtype=torch.int32)
    ci = torch.arange(64, dtype=torch.int32)
    w = _t(rng.uniform(0.1, 1.0, 64).astype(np.float32))
    # q side: pad rows are row-selected away, so NaN may sit there
    q_dirty = q.clone()
    q_dirty[24:] = float("nan")
    base = ops.affinity_matvec(q, qi, c, ci, w, 0.5)
    out = ops.affinity_matvec(q_dirty, qi, c, ci, w, 0.5)
    assert _bits_equal(base[:24], out[:24])
    # c side: pad rows are weight-0 terms, so their garbage must be finite
    w_pad = w.clone()
    w_pad[48:] = 0.0
    c_junk = c.clone()
    c_junk[48:] = 1e6
    base = ops.affinity_matvec(q, qi, c, ci, w_pad, 0.5)
    out = ops.affinity_matvec(q, qi, c_junk, ci, w_pad, 0.5)
    assert _bits_equal(base, out)


def test_poison_roi_filter():
    rng = np.random.default_rng(0)
    vc = rng.normal(size=(64, 8)).astype(np.float32)
    center = _t(rng.normal(size=(8,)).astype(np.float32))
    valid = torch.ones(64, dtype=torch.bool)
    valid[48:] = False
    clean, dirty = vc.copy(), vc.copy()
    clean[48:] = 0.0
    dirty[48:56] = np.nan
    dirty[56:] = np.inf
    b = ops.roi_filter(_t(clean), center, 2.5, valid)
    o = ops.roi_filter(_t(dirty), center, 2.5, valid)
    for x, y in zip(b, o):
        assert _bits_equal(x[:48], y[:48])
    assert not bool(o[1][48:].any())
    assert bool((o[2][48:] == float("-inf")).all())


def test_poison_lsh_hash():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    proj = _t(rng.normal(size=(2, 4, 8)).astype(np.float32))
    bias = _t(rng.uniform(0, 1, size=(2, 4)).astype(np.float32))
    clean = np.concatenate([x, np.zeros((8, 8), np.float32)])
    dirty = clean.copy()
    dirty[32:] = np.nan
    base = ops.lsh_hash(_t(clean), proj, bias, 0.7)
    out = ops.lsh_hash(_t(dirty), proj, bias, 0.7)
    assert torch.equal(base[:32], out[:32])


@pytest.mark.parametrize("refresh_every,finite", [(0, False), (2, True)])
def test_poison_lid_sweep_pad_rows(refresh_every, finite):
    """Masked-off rows never reach valid slots: NaN/Inf with the refresh
    off (pure selection), large finite garbage with it on (weight-0
    terms), as `repro.analysis.contracts` requires of the JAX kernel."""
    r = np.random.default_rng(3)
    n_valid, pad, d = 24, 8, 8
    cap = n_valid + pad
    v = r.normal(size=(cap, d)).astype(np.float32)
    mask = np.zeros((cap,), bool)
    mask[:n_valid] = True
    clean, dirty = v.copy(), v.copy()
    clean[n_valid:] = 0.0
    if finite:
        dirty[n_valid:] = 1e6
    else:
        dirty[n_valid:n_valid + 4] = np.nan
        dirty[n_valid + 4:] = np.inf
    x = np.zeros((cap,), np.float32)
    x[0] = 1.0
    ax = np.zeros((cap,), np.float32)
    ax[:n_valid] = np.exp(-0.5 * np.sqrt(((clean[:n_valid] - clean[0]) ** 2)
                                         .sum(-1)))
    ax[0] = 0.0
    rest = (_t(np.arange(cap, dtype=np.int32))[None], _t(mask)[None],
            _t(x)[None], _t(ax)[None], torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.bool))
    kw = dict(n_steps=16, max_iters=64, tol=1e-5, refresh_every=refresh_every)
    base = ops.lid_sweep(_t(clean)[None], *rest, 0.5, **kw)
    out = ops.lid_sweep(_t(dirty)[None], *rest, 0.5, **kw)
    assert int(base[2][0]) >= 2, "scenario converged immediately"
    for a, b in zip(base, out):
        assert _bits_equal(a, b)
