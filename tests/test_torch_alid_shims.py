"""The JAX package's deprecated ALID entry points in the port
(`repro_torch.core.alid.detect_clusters`, `detect_clusters_sharded`) and
`ALIDConfig.dtype`, held to what the JAX tests ask of them
(tests/test_core_alid.py:174,184, tests/test_sharded.py:133-134,205,
tests/test_system.py) on the CPU, plus: each shim warns
DeprecationWarning as JAX's does and returns exactly the `engine.fit` of
the spec it names (labels and densities bitwise), and the replicated and
sharded shims find the JAX package's clusters (canonical labels equal,
densities within rtol 1e-5) at probe 128, where retrieval is exact."""

import jax
import numpy as np
import pytest
import torch

from repro.core import alid as jalid
from repro.data import auto_lsh_params as jax_auto_lsh
from repro_torch import random as trandom
from repro_torch.core.affinity import affinity_matrix, estimate_k
from repro_torch.core.alid import (ALIDConfig, EngineSpec, detect_clusters,
                                   detect_clusters_sharded)
from repro_torch.core.engine import fit
from repro_torch.core.peeling import iid_detect
from repro_torch.data.synthetic import (auto_lsh_params, make_blobs_with_noise,
                                        make_regime_dataset)
from repro_torch.utils.metrics import avg_f1_score, canonical_labels

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _deprecated(fn, *args, **kw):
    with pytest.warns(DeprecationWarning, match=fn.__name__ +
                      " is deprecated"):
        return fn(*args, device=CPU, **kw)


def test_dtype_property_reads_the_spec():
    assert ALIDConfig().dtype == "float32"
    cfg = ALIDConfig(spec=EngineSpec(dtype="bfloat16"))
    assert cfg.dtype == "bfloat16" == jalid.ALIDConfig(
        spec=jalid.EngineSpec(dtype="bfloat16")).dtype


# --------------------------------------- tests/test_core_alid.py twins --
@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=6, cluster_size=30, n_noise=150,
                                 d=12, seed=3)


def test_detect_clusters_quality(blobs):
    lshp = auto_lsh_params(blobs.points)
    cfg = ALIDConfig(a_cap=64, delta=64, lsh=lshp, seeds_per_round=16,
                     max_rounds=30)
    res = _deprecated(detect_clusters, blobs.points, cfg, trandom.PRNGKey(0))
    f = avg_f1_score(blobs.labels, res.labels)
    assert f > 0.6, f
    assert (res.densities >= cfg.density_min).all()


def test_detect_clusters_labels_wellformed(blobs):
    lshp = auto_lsh_params(blobs.points)
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=8,
                     max_rounds=10)
    res = _deprecated(detect_clusters, blobs.points, cfg, trandom.PRNGKey(1))
    labels = res.labels
    assert labels.shape == (blobs.points.shape[0],)
    ids = np.unique(labels[labels >= 0])
    assert len(ids) == len(res.densities)
    for i in ids:
        assert (labels == i).sum() > 1


# ----------------------------------------- tests/test_sharded.py twins --
@pytest.fixture(scope="module")
def sblobs():
    return make_blobs_with_noise(n_clusters=5, cluster_size=24, n_noise=110,
                                 d=10, seed=3)


def test_serial_sharded_label_parity(sblobs):
    """At probe 128 (no window truncation) the replicated and sharded
    shims give one clustering; each is the fit of its spec, and both are
    the JAX package's detect_clusters."""
    lshp = auto_lsh_params(sblobs.points, probe=128)
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                     max_rounds=20)
    rng = trandom.PRNGKey(0)
    ser = _deprecated(detect_clusters, sblobs.points, cfg, rng)
    shd = _deprecated(detect_clusters_sharded, sblobs.points, cfg, rng,
                      n_shards=5)
    via = _deprecated(detect_clusters, sblobs.points, cfg, rng, n_shards=5)
    assert len(ser.densities) > 0
    np.testing.assert_array_equal(canonical_labels(ser.labels),
                                  canonical_labels(shd.labels))
    np.testing.assert_allclose(np.sort(ser.densities),
                               np.sort(shd.densities), rtol=1e-6)
    for got, spec in ((ser, EngineSpec(engine="replicated")),
                      (shd, EngineSpec(engine="sharded", n_shards=5)),
                      (via, EngineSpec(engine="sharded", n_shards=5))):
        want = fit(sblobs.points, cfg._replace(spec=spec), rng, device=CPU)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.densities, want.densities)
    with pytest.warns(DeprecationWarning):
        jres = jalid.detect_clusters(
            sblobs.points, jalid.ALIDConfig(
                a_cap=48, delta=48, lsh=jax_auto_lsh(sblobs.points,
                                                     probe=128),
                seeds_per_round=16, max_rounds=20), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(canonical_labels(ser.labels),
                                  canonical_labels(np.asarray(jres.labels)))
    np.testing.assert_allclose(np.sort(ser.densities),
                               np.sort(np.asarray(jres.densities)),
                               rtol=1e-5)


def test_sharded_quality_with_default_probe(sblobs):
    lshp = auto_lsh_params(sblobs.points)     # probe=16
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                     max_rounds=20)
    res = _deprecated(detect_clusters_sharded, sblobs.points, cfg,
                      trandom.PRNGKey(1), n_shards=4)
    assert avg_f1_score(sblobs.labels, res.labels) > 0.6
    res0 = _deprecated(detect_clusters_sharded, sblobs.points, cfg,
                       trandom.PRNGKey(1), n_shards=0)   # at least one shard
    want = fit(sblobs.points, cfg._replace(spec=EngineSpec(
        engine="sharded", n_shards=1)), trandom.PRNGKey(1), device=CPU)
    np.testing.assert_array_equal(res0.labels, want.labels)


# ---------------------------------------- tests/test_system.py twins ----
@pytest.fixture(scope="module")
def dataset():
    return make_blobs_with_noise(n_clusters=8, cluster_size=50, n_noise=600,
                                 d=24, seed=42)


@pytest.fixture(scope="module")
def system_fit(dataset):
    cfg = ALIDConfig(a_cap=160, delta=128,
                     lsh=auto_lsh_params(dataset.points),
                     seeds_per_round=16, max_rounds=40)
    return cfg, _deprecated(detect_clusters, dataset.points, cfg,
                            trandom.PRNGKey(0))


def test_end_to_end_quality(dataset, system_fit):
    """ALID finds the dominant clusters in heavy noise without knowing
    their number."""
    _, res = system_fit
    f = avg_f1_score(dataset.labels, res.labels)
    assert f > 0.85, f
    sizes = np.bincount(res.labels[res.labels >= 0])
    assert 6 <= (sizes >= 10).sum() <= 12


def test_alid_tracks_full_matrix_baseline(dataset, system_fit):
    """ALID's AVG-F within 0.1 of the O(n^2) IID baseline's (paper Fig.
    6/7) on this data."""
    _, res = system_fit
    f_alid = avg_f1_score(dataset.labels, res.labels)
    pts = torch.as_tensor(dataset.points)
    ref = iid_detect(affinity_matrix(pts, float(estimate_k(pts))))
    f_iid = avg_f1_score(dataset.labels, np.asarray(ref.labels))
    assert f_alid > f_iid - 0.1, (f_alid, f_iid)


def test_noise_left_unlabeled(dataset):
    cfg = ALIDConfig(a_cap=160, delta=128,
                     lsh=auto_lsh_params(dataset.points),
                     seeds_per_round=16, max_rounds=40)
    res = _deprecated(detect_clusters, dataset.points, cfg,
                      trandom.PRNGKey(1))
    noise_idx = dataset.labels == -1
    assert (res.labels[noise_idx] == -1).mean() > 0.8
    assert (res.densities >= cfg.density_min).all()


def test_regime_dataset_roundtrip():
    spec = make_regime_dataset(800, "P", d=16, P=400, seed=1)
    cfg = ALIDConfig(a_cap=64, delta=96, lsh=auto_lsh_params(spec.points),
                     seeds_per_round=16, max_rounds=30)
    res = _deprecated(detect_clusters, spec.points, cfg, trandom.PRNGKey(0))
    assert avg_f1_score(spec.labels, res.labels) > 0.6
