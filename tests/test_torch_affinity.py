"""The port's affinity op and its users (`core.affinity`'s block, matrix
and column; `core.lid.lid_solve_unfused`) against the JAX package on the
CPU, plus the port's own bit-level contracts.

Tolerances:
- The op and the affinity helpers agree with the JAX package's
  `ref.affinity_ref` and interpret-mode `affinity_pallas` to rtol 1e-5,
  atol 1e-4, the bar of tests/test_kernels.py: the distance expansion's
  d-sums are taken in the port's pinned order and in XLA's own.
- Zero diagonals, zeroed self entries, symmetry, row blocking and the
  fused-vs-unfused LID loops are exact (bitwise).
- A converged unfused LID state matches the JAX package's by support set
  (equal) and density (rtol 1e-5); their step sequences may part at an
  argmax near-tie (ROADMAP C) and still reach the same fixed point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affinity as jaff
from repro.core import lid as jlid
from repro.kernels import ref as jref
from repro.kernels.affinity import affinity_pallas
from repro_torch.convert import lid_state_from_numpy
from repro_torch.core import affinity as taff
from repro_torch.core import lid as tlid
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

K = 0.37
SHAPES = [(16, 16, 8), (100, 50, 32), (130, 257, 100), (128, 128, 128),
          (1, 300, 7)]


def _qc(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_affinity_op_matches_jax(m, n, d):
    q, c = _qc(m, n, d)
    got = ops.affinity(torch.tensor(q), torch.tensor(c), K).numpy()
    want_ref = np.asarray(jref.affinity_ref(jnp.asarray(q), jnp.asarray(c),
                                            jnp.float32(K)))
    want_pallas = np.asarray(affinity_pallas(
        jnp.asarray(q), jnp.asarray(c), jnp.float32(K), bm=64, bn=64,
        interpret=True))
    assert got.shape == (m, n) and got.dtype == np.float32
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_affinity_op_batched_is_per_lane():
    """A leading batch dim gives each lane's unbatched result, bitwise."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.normal(size=(3, 20, 9)).astype(np.float32))
    c = torch.tensor(rng.normal(size=(3, 7, 9)).astype(np.float32))
    got = ops.affinity(q, c, K)
    for b in range(3):
        assert torch.equal(got[b], ops.affinity(q[b], c[b], K))


def _points(n=90, d=12, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 4.0
    return (centers[rng.integers(0, 3, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def test_affinity_block_and_matrix_match_jax():
    v = _points()
    # disjoint rows: at a self pair the expansion's cancellation leaves
    # sqrt(rounding) ~ 3e-3 of distance, differently in each package
    got_b = taff.affinity_block(torch.tensor(v[17:]), torch.tensor(v[:17]), K)
    want_b = jaff.affinity_block(jnp.asarray(v[17:]), jnp.asarray(v[:17]), K,
                                 backend="ref")
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5,
                               atol=1e-4)
    a = taff.affinity_matrix(torch.tensor(v), K)
    want = np.asarray(jaff.affinity_matrix(jnp.asarray(v), K, backend="ref"))
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-4)
    assert bool((torch.diagonal(a) == 0).all())
    assert torch.equal(a, a.T)
    # in-place diagonal zeroing == the JAX package's a * (1 - eye), bitwise
    full = taff.affinity_block(torch.tensor(v), torch.tensor(v), K)
    assert torch.equal(a, full * (1.0 - torch.eye(len(v))))


def test_affinity_column_matches_jax():
    v = _points()
    idx = np.arange(len(v), dtype=np.int32)
    idx[5] = 9                        # a duplicate occurrence of id 9
    for i in (9, 0, 40):
        got = taff.affinity_column(torch.tensor(v), torch.tensor(idx),
                                   torch.tensor(v[i]), i, K)
        want = jaff.affinity_column(jnp.asarray(v), jnp.asarray(idx),
                                    jnp.asarray(v[i]), jnp.int32(i), K,
                                    backend="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)
        assert bool((got[torch.tensor(idx) == i] == 0).all())
    # batched: one column per lane, each the unbatched call's
    lanes = torch.tensor([3, 9])
    vb = torch.tensor(v).expand(2, -1, -1)
    ib = torch.tensor(idx).expand(2, -1)
    cols = taff.affinity_column(vb, ib, torch.tensor(v)[lanes], lanes, K)
    for b, i in enumerate((3, 9)):
        assert torch.equal(cols[b], taff.affinity_column(
            torch.tensor(v), torch.tensor(idx), torch.tensor(v[i]), i, K))


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_row_blocks_change_no_bit(monkeypatch, p):
    """The plain distance and affinity taken a few rows at a time are
    bitwise the unblocked results (each entry is computed on its own)."""
    q, c = _qc(77, 45, 40, seed=3)
    q, c = torch.tensor(q), torch.tensor(c)
    whole_d = tref.pairwise_distance_ref(q, c, p)
    whole_a = tref.affinity_ref(q, c, K, p)
    if p == 2.0:
        q2 = tref.pinned_sum(q * q)[:, None]
        c2 = tref.pinned_sum(c * c)[None]
        d2 = q2 + c2 - 2.0 * tref.pinned_dot(q, c)
        unblocked = torch.sqrt(torch.clamp_min(d2, 0.0))
        assert torch.equal(whole_d, unblocked)
        assert torch.equal(whole_a, torch.exp(-K * unblocked))
    width = 32 if p == 2.0 else 40
    monkeypatch.setattr(tref, "_DIST_ELEMS", 45 * width * 4)  # 4-row blocks
    assert torch.equal(tref.pairwise_distance_ref(q, c, p), whole_d)
    assert torch.equal(tref.affinity_ref(q, c, K, p), whole_a)
    monkeypatch.setattr(tref, "_DIST_ELEMS", 1)               # 1-row blocks
    assert torch.equal(tref.affinity_ref(q, c, K, p), whole_a)


CAP, D = 48, 16
LID_K = 0.45


def _live_state(seed=0):
    """tests/test_lid_sweep.py's live state (full range, refreshed Ax), in
    the JAX package."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, D)) * 3.0
    pts = np.concatenate(
        [c + rng.normal(size=(CAP // 4, D)) for c in centers])
    v = jnp.asarray(pts, jnp.float32)
    st = jlid.init_state(v, jnp.int32(0), CAP)._replace(
        beta_idx=jnp.arange(CAP, dtype=jnp.int32),
        beta_mask=jnp.ones(CAP, bool), v_beta=v)
    return jlid.refresh_ax(st, jnp.float32(LID_K), backend="ref")


def _port_state(seeds=(0, 1, 2)):
    """The JAX package's live states as the port's lanes."""
    sts = [_live_state(s) for s in seeds]
    fields = [np.stack([np.asarray(getattr(s, f)) for s in sts])
              for f in jlid.LIDState._fields]
    return sts, lid_state_from_numpy(*fields)


@pytest.mark.parametrize("sweep_steps", [1, 3, 8, 200])
def test_fused_solve_equals_unfused(sweep_steps):
    """The port's lid_solve (sweep chunks) equals its lid_solve_unfused (one
    step at a time, columns from the affinity op) bit for bit, as
    tests/test_lid_sweep.py holds the JAX package's pair."""
    _, st = _port_state()
    got = tlid.lid_solve(st, LID_K, max_iters=200, sweep_steps=sweep_steps)
    want = tlid.lid_solve_unfused(st, LID_K, max_iters=200)
    assert int(want.n_iters.max()) > 2
    for name in ("x", "ax", "n_iters", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_unfused_budget_and_done_lanes():
    """n_iters stops at max_iters exactly, and a lane entered converged
    with its budget spent is left bitwise unchanged."""
    _, st = _port_state()
    out = tlid.lid_solve_unfused(st, LID_K, max_iters=3)
    assert out.n_iters.tolist() == [3, 3, 3]
    again = tlid.lid_solve_unfused(out, LID_K, max_iters=3)
    for name in ("x", "ax", "n_iters"):
        assert torch.equal(getattr(again, name), getattr(out, name))


def test_unfused_matches_jax():
    """Each lane of the port's unfused loop reaches the JAX package's
    lid_solve_unfused fixed point: same support, density rtol 1e-5."""
    sts, st = _port_state()
    got = tlid.lid_solve_unfused(st, LID_K, max_iters=200)
    for b, jst in enumerate(sts):
        want = jlid.lid_solve_unfused(jst, jnp.float32(LID_K), max_iters=200,
                                      backend="ref")
        wx = np.asarray(want.x)
        gx = got.x[b].numpy()
        assert set(np.where(gx > 1e-6)[0]) == set(np.where(wx > 1e-6)[0])
        np.testing.assert_allclose(float(tlid.density(got)[b]),
                                   float(jlid.density(want)), rtol=1e-5)
        assert bool(got.converged[b]) == bool(want.converged)
