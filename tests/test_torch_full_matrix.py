"""The port's full-matrix path (`core.iid`, `core.rd`, `core.peeling`,
`launch.full_matrix`) against the JAX package on the CPU.

Tolerances:
- On the same matrix, IID and RD reach the JAX package's supports
  (equal) and densities (rtol 1e-5): torch and XLA take the matvec and
  x.Ax sums in different orders.
- The peels on tests/test_baselines.py's `easy` fixture give equal
  canonical labels and round counts, densities rtol 1e-5.
- The chunked loops are bitwise equal to one iteration per host check,
  and the active-set restriction is bitwise equal to the JAX package's
  a * outer(active, active).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import iid as jiid
from repro.core import peeling as jpeel
from repro.core import rd as jrd
from repro.core.affinity import affinity_matrix as jaffinity_matrix
from repro.core.affinity import estimate_k as jestimate_k
from repro.data import make_blobs_with_noise as jblobs
from repro.data import synthetic as jsynthetic
from repro.utils import metrics as jmetrics
from repro_torch.core import iid as tiid
from repro_torch.core import lid as tlid
from repro_torch.core import peeling as tpeel
from repro_torch.core import rd as trd
from repro_torch.core.affinity import affinity_matrix, estimate_k
from repro_torch.data import make_blobs_with_noise, make_regime_dataset
from repro_torch.launch import full_matrix
from repro_torch.utils import avg_f1_score, canonical_labels, label_agreement


@pytest.fixture(scope="module")
def easy():
    """tests/test_baselines.py's fixture, with the JAX package's k and
    matrix, and the port's matrix at that k."""
    spec = make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=60,
                                 d=8, seed=7, overlap_pairs=0)
    pts = jnp.asarray(spec.points)
    k = float(jestimate_k(pts))
    ja = jaffinity_matrix(pts, k, backend="ref")
    ta = affinity_matrix(torch.tensor(spec.points), k)
    return spec, k, ja, ta


def test_estimate_k_and_matrix(easy):
    spec, k, ja, ta = easy
    np.testing.assert_allclose(estimate_k(torch.tensor(spec.points)), k,
                               rtol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-4)


SOLVERS = [(jiid.iid_solve, tiid.iid_solve, 1000, 1e-5),
           (jrd.replicator_solve, trd.replicator_solve, 2000, 1e-7)]


@pytest.mark.parametrize("jsolve,tsolve,iters,tol", SOLVERS,
                         ids=["iid", "rd"])
def test_solver_matches_jax(easy, jsolve, tsolve, iters, tol):
    _, _, ja, _ = easy
    n = ja.shape[0]
    a = torch.tensor(np.asarray(ja))
    for x0 in (np.full(n, 1.0 / n, np.float32),
               np.asarray(jiid.uniform_on(jnp.arange(n) % 3 == 0))):
        want = jsolve(ja, jnp.asarray(x0), max_iters=iters, tol=tol)
        got = tsolve(a, torch.tensor(x0), max_iters=iters, tol=tol)
        assert set(np.where(got.x.numpy() > 1e-6)[0]) == \
            set(np.where(np.asarray(want.x) > 1e-6)[0])
        np.testing.assert_allclose(float(got.density), float(want.density),
                                   rtol=1e-5)
        assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("tsolve", [tiid.iid_solve, trd.replicator_solve],
                         ids=["iid", "rd"])
def test_chunks_and_active_set_change_no_bit(easy, tsolve):
    """Chunks of S iterations per host check equal S = 1 bitwise, and the
    active-set restriction equals the masked matrix bitwise."""
    _, _, _, a = easy
    n = a.shape[0]
    act = torch.tensor(np.random.default_rng(0).random(n) < 0.6)
    x0 = tiid.uniform_on(act)
    masked = a * (act[:, None] & act[None, :]).float()
    want = tsolve(masked, x0, max_iters=3000, chunk=1)
    assert int(want.n_iters) > 10
    for chunk in (1, 7, 64, 5000):
        got = tsolve(a, x0, max_iters=3000, active=act, chunk=chunk)
        for name in ("x", "density", "n_iters", "converged"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (chunk, name)
    capped = tsolve(a, x0, max_iters=9, active=act, chunk=4)
    assert int(capped.n_iters) == 9 and not bool(capped.converged)


def test_uniform_on_matches_jax():
    mask = np.random.default_rng(1).random(50) < 0.3
    assert np.array_equal(tiid.uniform_on(torch.tensor(mask)).numpy(),
                          np.asarray(jiid.uniform_on(jnp.asarray(mask))))


@pytest.mark.parametrize("detect", ["iid_detect", "ds_detect"])
def test_peel_matches_jax(easy, detect):
    """On the same matrix, and on each package's own matrix at the same k:
    canonical labels and rounds equal, densities rtol 1e-5."""
    spec, _, ja, ta = easy
    want = getattr(jpeel, detect)(ja)
    for a in (torch.tensor(np.asarray(ja)), ta):
        got = getattr(tpeel, detect)(a)
        assert np.array_equal(canonical_labels(got.labels),
                              canonical_labels(want.labels))
        assert got.n_rounds == want.n_rounds
        np.testing.assert_allclose(got.densities, want.densities, rtol=1e-5)
    floor = 0.75 if detect == "iid_detect" else 0.7   # tests/test_baselines
    assert avg_f1_score(spec.labels, got.labels) > floor


def test_peel_masks_like_jax(easy):
    """The port's peel hands its solver the active set; one that is handed
    a * outer(active, active) instead, as the JAX package's is, gives the
    same labels, densities and rounds bit for bit."""
    _, _, _, a = easy
    calls = []

    def masked_iid(m, x0, max_iters, active):
        calls.append(int(active.sum()))
        return tiid.iid_solve(m * (active[:, None] & active[None, :]).float(),
                              x0, max_iters=max_iters)

    got = tpeel.iid_detect(a)
    want = tpeel.peel_full_matrix(a, masked_iid)
    assert len(calls) == want.n_rounds > 1
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.densities, want.densities)
    assert got.n_rounds == want.n_rounds


def _lid_state(pts, beta, cap, ax):
    m = len(beta)
    pad = cap - m
    return tlid.LIDState(
        beta_idx=torch.tensor(np.concatenate(
            [beta, np.full(pad, -1)]).astype(np.int32))[None],
        beta_mask=torch.tensor(np.arange(cap) < m)[None],
        v_beta=torch.cat([pts[torch.tensor(beta)],
                          torch.zeros((pad, pts.shape[1]))])[None],
        x=torch.cat([torch.full((m,), 1.0 / m), torch.zeros(pad)])[None],
        ax=torch.cat([ax, torch.zeros(pad)])[None],
        n_iters=torch.zeros(1, dtype=torch.int32),
        converged=torch.zeros(1, dtype=torch.bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lid_equals_iid_on_full_range(seed):
    """tests/test_lid_vs_iid.py in the port: LID on the full index range
    and IID on the full matrix, from the barycenter, reach the same dense
    subgraph (density rtol 1e-4; supports differ by <= 2 boundary members
    of tiny weight), and the JAX package's IID density (rtol 1e-4)."""
    spec = make_blobs_with_noise(n_clusters=3, cluster_size=15, n_noise=15,
                                 d=8, seed=seed, overlap_pairs=0)
    pts = torch.tensor(spec.points)
    n = pts.shape[0]
    k = estimate_k(pts)
    a = affinity_matrix(pts, k)
    x0 = torch.full((n,), 1.0 / n)
    iid = tiid.iid_solve(a, x0, max_iters=5000, tol=1e-6)
    st = _lid_state(pts, np.arange(n), n, a @ x0)
    lid = tlid.lid_solve(st, k, max_iters=5000, tol=1e-6)
    np.testing.assert_allclose(float(tlid.density(lid)[0]),
                               float(iid.density), rtol=1e-4)
    sup_iid = set(np.where(iid.x.numpy() > 1e-5)[0].tolist())
    sup_lid = set(lid.beta_idx[0][lid.x[0] > 1e-5].tolist())
    assert len(sup_iid ^ sup_lid) <= 2, (sup_iid, sup_lid)
    jpts = jnp.asarray(spec.points)
    jk = float(jestimate_k(jpts))
    want = jiid.iid_solve(jaffinity_matrix(jpts, jk, backend="ref"),
                          jnp.full((n,), 1.0 / n), max_iters=5000, tol=1e-6)
    np.testing.assert_allclose(float(iid.density), float(want.density),
                               rtol=1e-4)


def test_lid_on_subrange_matches_iid_on_submatrix():
    """tests/test_lid_vs_iid.py's second equivalence: LID on a strict,
    padded subrange equals IID on that submatrix; the padding stays 0."""
    spec = make_blobs_with_noise(n_clusters=2, cluster_size=20, n_noise=10,
                                 d=8, seed=5, overlap_pairs=0)
    pts = torch.tensor(spec.points)
    k = estimate_k(pts)
    beta = np.where(spec.labels == 0)[0][:16]
    a_sub = affinity_matrix(pts[torch.tensor(beta)], k)
    m = len(beta)
    x0 = torch.full((m,), 1.0 / m)
    iid = tiid.iid_solve(a_sub, x0, max_iters=2000, tol=1e-6)
    lid = tlid.lid_solve(_lid_state(pts, beta, 24, a_sub @ x0), k,
                         max_iters=2000, tol=1e-6)
    np.testing.assert_allclose(float(tlid.density(lid)[0]),
                               float(iid.density), rtol=1e-4)
    assert float(lid.x[0, m:].abs().max()) == 0.0


@pytest.mark.parametrize("solver", ["iid", "ds"])
def test_full_matrix_cli(easy, solver, capsys):
    """launch.full_matrix on the CPU runs the path the JAX package's
    benchmarks/common.py::run_full_matrix runs: same rounds, canonical
    labels and AVG-F on the easy fixture."""
    spec = easy[0]
    out = full_matrix.main(["--device", "cpu", "--solver", solver,
                            "--n-clusters", "4", "--cluster-size", "25",
                            "--n-noise", "60", "--d", "8", "--seed", "7",
                            "--overlap-pairs", "0"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[full-matrix] solver={solver} device=cpu "
                           "n=160 d=8 ")
    pts = jnp.asarray(spec.points)
    ja = jaffinity_matrix(pts, float(jestimate_k(pts)), backend="ref")
    want = (jpeel.iid_detect if solver == "iid" else jpeel.ds_detect)(ja)
    res = out["result"]
    assert res.n_rounds == want.n_rounds == out["rounds"]
    assert np.array_equal(canonical_labels(res.labels),
                          canonical_labels(want.labels))
    np.testing.assert_allclose(out["avg_f"],
                               jmetrics.avg_f1_score(spec.labels,
                                                     want.labels))
    assert out["peak_bytes"] is None and out["clusters"] > 0


@pytest.mark.parametrize("regime,n", [("omega", 400), ("eta", 1000),
                                      ("P", 900)])
def test_make_regime_dataset_matches_jax(regime, n):
    got = make_regime_dataset(n, regime, d=6, seed=3)
    want = jsynthetic.make_regime_dataset(n, regime, d=6, seed=3)
    assert np.array_equal(got.points, want.points)
    assert np.array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters
    with pytest.raises(ValueError, match="regime"):
        make_regime_dataset(n, "zeta")


def test_label_agreement_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(-1, 5, 200)
    b = np.where(rng.random(200) < 0.8, (a + 2) % 7, rng.integers(-1, 5, 200))
    for x, y in ((a, b), (a, a), (b, a)):
        assert label_agreement(x, y) == jmetrics.label_agreement(x, y)
    # the JAX fixture's blobs are the port's, bit for bit
    s1 = make_blobs_with_noise(3, 10, 5, d=4, seed=9)
    s2 = jblobs(3, 10, 5, d=4, seed=9)
    assert np.array_equal(s1.points, s2.points)
