"""The port's p-stable LSH (`repro_torch.lsh.pstable`) against the JAX
package's, on the blobs fixture of tests/test_engine.py.

Everything here is integer output and must be equal: bucket keys (zero
flips), the salt fold, sorted keys, permutations, bucket sizes and probe
candidates. The projections are f32 normals, which agree with jax.random's
to a few ulps (see tests/test_torch_random.py); the biases are uniform
draws and are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.lsh import pstable as jp
from repro_torch import random as trandom
from repro_torch.convert import lsh_tables_from_numpy
from repro_torch.lsh import pstable as tp


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=80,
                                 d=10, seed=7, overlap_pairs=0)


def _params(points, probe):
    return auto_lsh_params(points, probe=probe)


def _tp(params):
    return tp.LSHParams(*params)


def test_make_projections(blobs):
    lshp = _params(blobs.points, 16)
    for seed in (0, 3):
        jproj, jbias = jp.make_projections(jax.random.PRNGKey(seed), lshp, 10,
                                           jnp.float32)
        proj, bias = tp.make_projections(trandom.PRNGKey(seed), _tp(lshp), 10)
        np.testing.assert_array_equal(bias.numpy().view(np.uint32),
                                      np.asarray(jbias).view(np.uint32))
        np.testing.assert_allclose(proj.numpy(), np.asarray(jproj),
                                   rtol=5e-7, atol=1e-7)


def test_hash_points_and_queries_equal(blobs):
    lshp = _params(blobs.points, 16)
    jproj, jbias = jp.make_projections(jax.random.PRNGKey(1), lshp, 10,
                                       jnp.float32)
    pts = jnp.asarray(blobs.points)
    want = np.asarray(jp.hash_points(pts, jproj, jbias, lshp.seg_len,
                                     backend="ref"))
    x = torch.tensor(blobs.points)
    proj, bias = torch.tensor(np.asarray(jproj)), torch.tensor(
        np.asarray(jbias))
    got = tp.hash_points(x, proj, bias, lshp.seg_len)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    jk, js = jp.hash_queries(pts[:40], jproj, jbias, lshp.seg_len,
                             backend="ref")
    tk, _ = tp.hash_queries(x[:40], proj, bias, lshp.seg_len)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


def test_salt_fold_equal(blobs):
    """A salt folds the raw bits of the f32 projections z = q . W^T + b.
    torch's and XLA's einsums sum d in different orders, so z (and with it
    every salt bit) agrees only to f32 rounding; the fold of equal z must
    be equal. Probe windows are compared on equal salts in
    test_probe_candidates_equal."""
    lshp = _params(blobs.points, 16)
    jproj, jbias = jp.make_projections(jax.random.PRNGKey(1), lshp, 10,
                                       jnp.float32)
    q = jnp.asarray(blobs.points[:40])
    _, js = jp.hash_queries(q, jproj, jbias, lshp.seg_len, backend="ref")
    z = np.asarray(jnp.einsum("nd,lmd->lnm", q, jproj) + jbias[:, None, :])
    bits = torch.tensor(z.view(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(tp._mix_fold(bits).numpy(),
                                  np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(
        tp._mix_fold(bits).numpy(),
        np.asarray(jp._mix_fold(jnp.asarray(z.view(np.int32)))).astype(
            np.int64))
    tz = (torch.einsum("nd,lmd->lnm", torch.tensor(blobs.points[:40]),
                       torch.tensor(np.asarray(jproj)))
          + torch.tensor(np.asarray(jbias))[:, None, :])
    np.testing.assert_allclose(tz.numpy(), z, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_build_lsh_tables_and_bucket_sizes_equal(blobs, seed):
    """From the same key: equal projections' keys, sorted keys, perm and
    bucket sizes (uint32 order, stable ties)."""
    lshp = _params(blobs.points, 16)
    jt = jp.build_lsh(jnp.asarray(blobs.points), lshp,
                      jax.random.PRNGKey(seed), backend="ref")
    tt = tp.build_lsh(torch.tensor(blobs.points), _tp(lshp),
                      trandom.PRNGKey(seed))
    np.testing.assert_array_equal(tt.sorted_keys.numpy(),
                                  np.asarray(jt.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tp.bucket_sizes(tt).numpy(),
                                  np.asarray(jp.bucket_sizes(jt)))


@pytest.fixture(scope="module")
def jax_tables(blobs):
    return jp.build_lsh(jnp.asarray(blobs.points), _params(blobs.points, 16),
                        jax.random.PRNGKey(2), backend="ref")


@pytest.mark.parametrize("probe", [2, 4, 128])
def test_probe_candidates_equal(blobs, jax_tables, probe):
    """Equal tables (carried across by `convert`) give equal candidates,
    also where buckets are larger than `probe` and the salted window
    offset decides which members come back."""
    lshp = _params(blobs.points, probe)
    jt = jax_tables
    tt = lsh_tables_from_numpy(np.asarray(jt.proj), np.asarray(jt.bias),
                               np.asarray(jt.sorted_keys), np.asarray(jt.perm),
                               device="cpu")
    sizes = np.asarray(jp.bucket_sizes(jt))
    if probe < 128:
        assert sizes.max() > probe, "no bucket exceeds probe: vacuous"
    q = blobs.points[::3]
    want = np.asarray(jp.query_batch(jt, jnp.asarray(q), lshp,
                                     backend="ref"))
    got = tp.query_batch(tt, torch.tensor(q), _tp(lshp))
    np.testing.assert_array_equal(got.numpy(), want)
    # and probe_tables alone, on the JAX package's own keys and salts
    jk, js = jp.hash_queries(jnp.asarray(q), jt.proj, jt.bias, lshp.seg_len,
                             backend="ref")
    got = tp.probe_tables(tt.sorted_keys, tt.perm,
                          torch.tensor(np.asarray(jk).astype(np.int64)),
                          torch.tensor(np.asarray(js).astype(np.int64)),
                          probe)
    want = np.asarray(jp.probe_tables(jt.sorted_keys, jt.perm, jk, js, probe))
    np.testing.assert_array_equal(got.numpy(), want)
