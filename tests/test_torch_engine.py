"""The port's fit (`repro_torch.core.engine.fit`) against the JAX package's
`repro.core.engine.fit` with backend="ref", on the blobs/cfg fixtures of
tests/test_engine.py, plus the result type, the engine selection and the
numpy copies the port keeps of the JAX package's data and metric helpers.

Canonical labels, round counts and support sets must be equal; densities
and k agree to rtol 1e-5 (the distance expansion's d-sums run in the
port's pinned order and in XLA's own, ~1e-6 relative on this data). Support
weights are held to atol 5e-4 (weights ~0.04 on these 25-point clusters):
LID stops once every |r_i| <= tol = 1e-5, which pins x only to O(tol / l),
l the smallest curvature of pi(x) on the support, so two step sequences that
part at an argmax near-tie (tests/test_torch_kernels.py) stop at weights up
to ~1e-4 apart here while their densities agree to 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import source as jsource
from repro.core.alid import ALIDConfig, Clustering as JClustering
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import avg_f1_score, canonical_labels
from repro_torch import random as trandom
from repro_torch.convert import clustering_from_dict
from repro_torch.core import alid as talid
from repro_torch.core import source as tsource
from repro_torch.core.engine import (MeshEngine, ShardedEngine,
                                    StreamedEngine, fit,
                                    make_engine)
from repro_torch.data import synthetic as tsynthetic
from repro_torch.lsh.pstable import LSHParams
from repro_torch.utils import metrics as tmetrics


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the data is small, and a pool of one thread a
    core in each of several test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=80,
                                 d=10, seed=7, overlap_pairs=0)


@pytest.fixture(scope="module")
def cfg(blobs):
    lshp = auto_lsh_params(blobs.points, probe=128)
    return ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                      max_rounds=20)


def _port_cfg(cfg, exhaustive):
    return talid.ALIDConfig(a_cap=cfg.a_cap, delta=cfg.delta,
                            lsh=LSHParams(*cfg.lsh),
                            seeds_per_round=cfg.seeds_per_round,
                            max_rounds=cfg.max_rounds, exhaustive=exhaustive)


@pytest.fixture(scope="module")
def fits(blobs, cfg):
    out = {}
    for exhaustive in (False, True):
        jcfg = cfg._replace(exhaustive=exhaustive,
                            spec=cfg.spec._replace(backend="ref"))
        out[exhaustive] = (
            jfit(blobs.points, jcfg, jax.random.PRNGKey(0)),
            fit(blobs.points, _port_cfg(cfg, exhaustive), trandom.PRNGKey(0),
                device="cpu"))
    return out


@pytest.mark.parametrize("exhaustive", [False, True])
def test_fit_matches_jax(fits, exhaustive):
    want, got = fits[exhaustive]
    assert want.n_clusters > 0
    np.testing.assert_array_equal(canonical_labels(got.labels),
                                  canonical_labels(want.labels))
    assert got.n_rounds == want.n_rounds
    np.testing.assert_allclose(got.k, want.k, rtol=1e-5)
    np.testing.assert_allclose(np.sort(got.densities),
                               np.sort(want.densities), rtol=1e-5)
    # cluster c of one result is the cluster of the same points in the other
    for c in range(want.n_clusters):
        pts = np.where(want.labels == c)[0]
        g = int(got.labels[pts[0]])
        np.testing.assert_allclose(got.densities[g], want.densities[c],
                                   rtol=1e-5)
        w_idx, g_idx = want.support_idx[c], got.support_idx[g]
        assert set(w_idx[w_idx >= 0]) == set(g_idx[g_idx >= 0])
        slot = {i: j for j, i in enumerate(w_idx) if i >= 0}
        for j, i in enumerate(g_idx):
            if i < 0:
                continue
            np.testing.assert_allclose(got.support_w[g][j],
                                       want.support_w[c][slot[i]], atol=5e-4)
            np.testing.assert_array_equal(got.support_v[g][j],
                                          want.support_v[c][slot[i]])


def test_fit_quality(blobs, fits):
    _, got = fits[False]
    assert tmetrics.avg_f1_score(blobs.labels, got.labels) > 0.9


def test_npz_saved_by_jax_loads_in_port(tmp_path, fits):
    want, _ = fits[True]
    path = JClustering.save(want, tmp_path / "jax_result")
    got = talid.Clustering.load(path)
    for key, value in want.to_dict().items():
        np.testing.assert_array_equal(got.to_dict()[key], value)
    assert got.n_rounds == want.n_rounds and got.k == pytest.approx(want.k)
    again = clustering_from_dict(want.to_dict())
    np.testing.assert_array_equal(again.support_v, want.support_v)
    # and back: the port's file is the JAX package's layout
    back = JClustering.load(talid.Clustering.save(got, tmp_path / "port"))
    np.testing.assert_array_equal(back.labels, want.labels)


@pytest.mark.parametrize("engine,cls", [("sharded", ShardedEngine),
                                        ("streamed", StreamedEngine),
                                        ("mesh", MeshEngine)])
def test_ported_engines_make(engine, cls):
    """The engines of ROADMAP A10, A11 and A13, refused before, are
    made."""
    eng = make_engine(talid.EngineSpec(engine=engine, n_shards=3),
                      device="cpu")
    assert type(eng) is cls and eng.device == torch.device("cpu")
    eng.close()


_SPECS = {
    "sharded": talid.EngineSpec(engine="sharded", n_shards=5),
    # the store built from source chunks of an odd size: chunking must not
    # change anything
    "streamed": talid.EngineSpec(engine="streamed", n_shards=5,
                                 chunk_size=37),
}


@pytest.mark.parametrize("exhaustive", [False, True])
@pytest.mark.parametrize("engine", ["sharded", "streamed"])
def test_engine_parity_with_jax(blobs, cfg, fits, engine, exhaustive):
    """The port's sharded and streamed fits give the JAX package's
    replicated fit's clustering (probe 128 covers every bucket of the
    fixture): canonical labels and round counts equal, densities within
    rtol 1e-6."""
    want, rep = fits[exhaustive]
    got = fit(blobs.points, _port_cfg(cfg, exhaustive)._replace(
        spec=_SPECS[engine]), trandom.PRNGKey(0), device="cpu")
    assert want.n_clusters > 0
    np.testing.assert_array_equal(canonical_labels(got.labels),
                                  canonical_labels(want.labels))
    assert got.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(got.densities),
                               np.sort(want.densities), rtol=1e-6)
    np.testing.assert_array_equal(got.labels, rep.labels)


def test_engine_spec_validation():
    """bf16 storage (ROADMAP B P1) builds on every ported engine; an
    unknown storage dtype or engine raises."""
    for engine in ("replicated", "sharded", "mesh", "streamed"):
        eng = make_engine(talid.EngineSpec(engine=engine, dtype="bfloat16"),
                          device="cpu")
        assert eng.spec.dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown storage dtype"):
        make_engine(talid.EngineSpec(dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine(talid.EngineSpec(engine="nope"), device="cpu")


# ------------------------------------------- numpy copies of the helpers --
@pytest.mark.parametrize("kw", [
    dict(n_clusters=4, cluster_size=25, n_noise=80, d=10, seed=7,
         overlap_pairs=0),
    dict(n_clusters=6, cluster_size=13, n_noise=31, d=5, seed=3)])
def test_synthetic_and_lsh_params_copies(kw):
    want = make_blobs_with_noise(**kw)
    got = tsynthetic.make_blobs_with_noise(**kw)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert tuple(tsynthetic.auto_lsh_params(got.points, probe=32)) == tuple(
        auto_lsh_params(want.points, probe=32))


def test_metric_copies():
    rng = np.random.default_rng(2)
    for _ in range(5):
        t = rng.integers(-1, 6, 300).astype(np.int32)
        p = np.where(rng.random(300) < 0.8, t, rng.integers(-1, 9, 300))
        np.testing.assert_array_equal(tmetrics.canonical_labels(p),
                                      canonical_labels(p))
        assert tmetrics.avg_f1_score(t, p) == pytest.approx(
            avg_f1_score(t, p), abs=1e-12)


def test_source_copies():
    for n, m in ((10, 512), (700, 512), (1_000_003, 512)):
        np.testing.assert_array_equal(
            tsource.strided_sample_indices(n, m),
            jsource.strided_sample_indices(n, m))
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    src = tsource.as_source(pts)
    assert (src.n, src.dim) == (4, 3)
    np.testing.assert_array_equal(src.sample(np.array([2, 0])), pts[[2, 0]])
    assert tsource.as_source(src) is src
    np.testing.assert_array_equal(tsource.as_source(torch.tensor(pts))
                                  .get_chunk(1, 2), pts[1:3])
