"""The port's baselines (`core.baselines`: SEA, AP, k-means, spectral
clustering, mean shift) against the JAX package on the CPU, on
tests/test_baselines.py's `easy` fixture, with that file's AVG-F floors.

Tolerances: each baseline's labels agree with the JAX package's up to a
relabeling (`label_agreement` 1.0, exact) where the algorithm allows it.
The distance expansion's sums differ in the last bits between the packages
(pinned order vs XLA's), and so does every float that follows, but on this
fixture no argmax, argmin or threshold sits close enough to a tie to move
a label. Spectral clustering is held to its partition (the eigenvectors
of eigh are not unique in sign or within a repeated eigenvalue) at the
same exact bar. Densities agree to rtol 1e-5; kNN affinities, centres and
modes to rtol 1e-5, atol 1e-4 (tests/test_kernels.py's affinity bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.affinity import estimate_k as jestimate_k
from repro.core.baselines import sea as jsea
from repro_torch.core import baselines as tb
from repro_torch.core.baselines import ap as tap
from repro_torch.core.baselines import sea as tsea
from repro_torch.data import make_blobs_with_noise
from repro_torch.utils import avg_f1_score, label_agreement


@pytest.fixture(scope="module")
def easy():
    spec = make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=60,
                                 d=8, seed=7, overlap_pairs=0)
    return spec, float(jestimate_k(jnp.asarray(spec.points)))


def test_sea_detect(easy):
    spec, k = easy
    got = tb.sea_detect(spec.points, k, device="cpu")
    want = jb.sea_detect(spec.points, k)
    assert label_agreement(got.labels, want.labels) == 1.0
    assert got.n_rounds == want.n_rounds
    np.testing.assert_allclose(got.densities, want.densities, rtol=1e-5)
    assert avg_f1_score(spec.labels, got.labels) > 0.4


def test_knn_graph_matches_jax(easy):
    spec, k = easy
    got = tsea.build_knn_graph(torch.tensor(spec.points), k, 16, block=64)
    want = jsea.build_knn_graph(jnp.asarray(spec.points), k, 16, block=64)
    assert np.array_equal(got.nbr_idx.numpy(), np.asarray(want.nbr_idx))
    np.testing.assert_allclose(got.nbr_aff.numpy(), np.asarray(want.nbr_aff),
                               rtol=1e-5, atol=1e-4)


def test_knn_graph_ties_go_to_the_lower_index():
    """Equal distances: the lower index first, as jax.lax.top_k (torch.topk
    promises no order). Rows 1, 2, 3 and 4 lie at one distance from row 0."""
    pts = np.zeros((6, 2), np.float32)
    pts[1:5] = [[1, 0], [0, 1], [-1, 0], [0, -1]]
    pts[5] = [5, 5]
    got = tsea.build_knn_graph(torch.tensor(pts), 0.5, 3)
    want = jsea.build_knn_graph(jnp.asarray(pts), 0.5, 3)
    assert got.nbr_idx[0].tolist() == [1, 2, 3]
    assert np.array_equal(got.nbr_idx.numpy(), np.asarray(want.nbr_idx))


def test_affinity_propagation(easy):
    spec, _ = easy
    got, got_ex = tb.affinity_propagation(spec.points, device="cpu")
    want, want_ex = jb.affinity_propagation(spec.points)
    assert label_agreement(got, want) == 1.0
    assert np.array_equal(got_ex, want_ex)
    assert avg_f1_score(spec.labels, got) > 0.5


def test_ap_median_even_count():
    """jnp.median's midpoint for an even count; torch.median would give the
    lower middle value."""
    for v in ([1.0, 2.0, 3.0, 4.0], [5.0, -1.0, 2.0], [3.0, 3.0, 1.0, 7.0]):
        got = float(tap.median(torch.tensor(v)))
        assert got == float(jnp.median(jnp.asarray(v, jnp.float32)))
    assert float(tap.median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5
    assert float(torch.median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0
    assert np.isnan(float(tap.median(torch.tensor([1.0, float("nan")]))))


def test_kmeans(easy):
    spec, _ = easy
    got, got_c = tb.kmeans(spec.points, 5, device="cpu")
    want, want_c = jb.kmeans(spec.points, 5)
    assert np.array_equal(got, np.asarray(want))
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-4)
    assert avg_f1_score(spec.labels, got) > 0.5


def test_spectral(easy):
    spec, k = easy
    got = tb.spectral_clustering(spec.points, 5, k, device="cpu")
    want = jb.spectral_clustering(spec.points, 5, k)
    assert label_agreement(got, want) == 1.0
    assert avg_f1_score(spec.labels, got) > 0.5


def test_mean_shift(easy):
    spec, _ = easy
    got, got_c = tb.mean_shift(spec.points, bandwidth=12.0, device="cpu")
    want, want_c = jb.mean_shift(spec.points, bandwidth=12.0)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-4)
    assert avg_f1_score(spec.labels, got) > 0.5
