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

SHAPES = [(16, 3, 8, 8), (100, 5, 24, 16), (257, 2, 33, 100), (1, 1, 4, 6)]


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
