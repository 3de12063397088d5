"""The port's DataSource surface, mirroring tests/test_source.py: the
source primitives (against the JAX package's on the same arrays), memmap
and chunked round trips through `fit` on the streamed engine, the streamed
predict path, the strided k sample and `ClusterService.assign_source`.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import source as jsource
from repro.core.alid import ALIDConfig as JALIDConfig, EngineSpec as JSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.core.affinity import estimate_k
from repro_torch.core.alid import ALIDConfig, EngineSpec
from repro_torch.core.engine import fit
from repro_torch.core.source import (ChunkedSource, CountingSource,
                                     InMemorySource, MemmapSource, as_source,
                                     is_data_source, make_source,
                                     strided_sample_indices)
from repro_torch.lsh.pstable import LSHParams
from repro_torch.serve.cluster_service import ClusterService


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
    return ALIDConfig(a_cap=48, delta=48, lsh=LSHParams(*lshp),
                      seeds_per_round=16, max_rounds=20,
                      spec=EngineSpec(engine="streamed", n_shards=5,
                                      chunk_size=37))


@pytest.fixture(scope="module")
def streamed(blobs, cfg):
    return fit(blobs.points, cfg, trandom.PRNGKey(0), device="cpu")


# ------------------------------------------------------- source primitives --
def test_in_memory_source_chunks_and_sample(blobs):
    src = InMemorySource(blobs.points)
    assert (src.n, src.dim) == blobs.points.shape
    np.testing.assert_array_equal(src.get_chunk(30, 50), blobs.points[30:80])
    idx = np.array([5, 99, 5, 0])
    np.testing.assert_array_equal(src.sample(idx), blobs.points[idx])
    np.testing.assert_array_equal(src.as_array(), blobs.points)
    starts = [s for s, _ in src.iter_chunks(64)]
    assert starts == [0, 64, 128]


def test_chunked_source_matches_concatenation_and_jax(blobs):
    pts = blobs.points
    blocks = [pts[:37], pts[37:90], pts[90:]]
    src, jsrc = ChunkedSource(blocks), jsource.ChunkedSource(blocks)
    assert src.n == pts.shape[0] and src.dim == pts.shape[1]
    for start, size in ((30, 70), (0, src.n), (89, 2)):
        np.testing.assert_array_equal(src.get_chunk(start, size),
                                      pts[start:start + size])
        np.testing.assert_array_equal(src.get_chunk(start, size),
                                      jsrc.get_chunk(start, size))
    idx = np.array([0, 36, 37, 89, 90, src.n - 1, 12])
    np.testing.assert_array_equal(src.sample(idx), pts[idx])
    np.testing.assert_array_equal(src.sample(idx), jsrc.sample(idx))


def test_memmap_source_reads_file(tmp_path, blobs):
    path = tmp_path / "pts.npy"
    np.save(path, blobs.points)
    src = MemmapSource(path)
    assert (src.n, src.dim) == blobs.points.shape
    np.testing.assert_array_equal(src.get_chunk(10, 40), blobs.points[10:50])
    np.testing.assert_array_equal(src.sample(np.array([170, 3])),
                                  blobs.points[[170, 3]])


def test_counting_source_counts_and_forwards(blobs):
    src = CountingSource(InMemorySource(blobs.points))
    np.testing.assert_array_equal(src.get_chunk(0, 10), blobs.points[:10])
    np.testing.assert_array_equal(src.sample(np.array([3, 4, 5])),
                                  blobs.points[3:6])
    assert (src.chunk_calls, src.chunk_rows) == (1, 10)
    assert (src.sample_calls, src.sample_rows) == (1, 3)
    src.reset()
    assert src.chunk_calls == src.sample_rows == 0


def test_as_source_and_make_source(tmp_path, blobs):
    assert is_data_source(InMemorySource(blobs.points))
    assert not is_data_source(blobs.points)
    src = as_source(blobs.points)
    assert isinstance(src, InMemorySource) and as_source(src) is src
    path = tmp_path / "pts.npy"
    np.save(path, blobs.points)
    assert isinstance(make_source(f"memmap:{path}"), MemmapSource)
    assert isinstance(make_source(str(path)), MemmapSource)   # a bare path
    assert isinstance(make_source(f"npy:{path}"), InMemorySource)
    with pytest.raises(ValueError, match="unknown source spec"):
        make_source("s3:bucket/pts.npy")


def test_strided_sample_indices_cover_range():
    idx = strided_sample_indices(1000, 100)
    assert idx.shape == (100,) and idx[0] == 0 and idx[-1] == 990
    assert np.unique(idx).size == 100
    np.testing.assert_array_equal(strided_sample_indices(7, 512),
                                  np.arange(7))


def test_estimate_k_not_prefix_biased():
    """A prefix of rows that is one tight blob (the situation after the
    stores' spatial sort) would inflate k; the strided sample sees the
    whole range, and k from the full array is k from that subsample."""
    rng = np.random.default_rng(0)
    tight = rng.normal(0.0, 1e-3, size=(100, 8))
    spread = rng.uniform(-50.0, 50.0, size=(4900, 8))
    pts = np.concatenate([tight, spread]).astype(np.float32)
    k = estimate_k(torch.tensor(pts))
    idx = strided_sample_indices(pts.shape[0], 512)
    assert k == pytest.approx(estimate_k(torch.tensor(pts[idx])), rel=1e-5)
    assert k < 0.5 * estimate_k(torch.tensor(pts[:512]))


# --------------------------------------------------- fit over real sources --
def test_streamed_fit_matches_jax(blobs, cfg, streamed):
    """The streamed fit from chunks of 37 rows gives the JAX package's
    replicated fit's clustering (probe 128 covers every bucket)."""
    want = jfit(blobs.points, JALIDConfig(
        a_cap=48, delta=48, lsh=auto_lsh_params(blobs.points, probe=128),
        seeds_per_round=16, max_rounds=20,
        spec=JSpec(backend="ref")), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(canonical_labels(streamed.labels),
                                  canonical_labels(want.labels))
    assert streamed.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(streamed.densities),
                               np.sort(want.densities), rtol=1e-6)


def test_fit_memmap_round_trip(tmp_path, blobs, cfg, streamed):
    path = tmp_path / "pts.npy"
    np.save(path, blobs.points)
    res = fit(MemmapSource(path), cfg, trandom.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(res.labels, streamed.labels)
    np.testing.assert_array_equal(res.densities, streamed.densities)
    assert res.n_rounds == streamed.n_rounds


def test_fit_chunked_source(blobs, cfg, streamed):
    blocks = [blobs.points[:50], blobs.points[50:130], blobs.points[130:]]
    res = fit(ChunkedSource(blocks), cfg, trandom.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(res.labels, streamed.labels)


# ------------------------------------------------------- streamed predict --
def test_predict_streaming_batches_match(blobs, streamed):
    assert streamed.n_clusters > 0
    q = blobs.points[:57]
    ref = streamed.predict(q, device="cpu")
    np.testing.assert_array_equal(
        streamed.predict(q, batch_size=13, device="cpu"), ref)
    np.testing.assert_array_equal(
        streamed.predict(InMemorySource(q), batch_size=13, device="cpu"), ref)
    np.testing.assert_array_equal(
        streamed.predict(ChunkedSource([q[:20], q[20:]]), device="cpu"), ref)


def test_cluster_service_assign_source(blobs, streamed):
    svc = ClusterService(streamed, batch_slots=8, device="cpu")
    labels = svc.assign_source(InMemorySource(blobs.points), batch_size=32)
    np.testing.assert_array_equal(labels,
                                  streamed.predict(blobs.points,
                                                   device="cpu"))
