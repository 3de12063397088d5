"""The port's threefry2x32 (`repro_torch.random`) against `jax.random`.

Keys and raw bits are integers and must be equal. `uniform` is a bit
manipulation of those bits plus one f32 multiply-add, so it is equal too.
`normal` and `gumbel` end in float32 logarithms: XLA's CPU log/log1p are
its own polynomial approximations, torch's are libm's, and the two differ
by an ulp or two on a fraction of inputs. Those draws are therefore held
to 4 ulps (Gumbel: 4 eps on the scale of max(1, |g|)), and what the fit
does with them, the Gumbel top-k seed choice, to equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as trandom


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between two f32 arrays."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [0, 7, 123, 2 ** 31 + 5, -1])
def test_prng_key_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trandom.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk, np.int64))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            trandom.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num), np.int64))
    # the fit's chain: split, take both halves, split again
    j0, j1 = jax.random.split(jk)
    t = trandom.split(tk)
    np.testing.assert_array_equal(trandom.split(t[0]).numpy(),
                                  np.asarray(jax.random.split(j0), np.int64))
    np.testing.assert_array_equal(trandom.split(t[1]).numpy(),
                                  np.asarray(jax.random.split(j1), np.int64))


@pytest.mark.parametrize("shape", [(1,), (7,), (4, 8, 16), (3001,)])
def test_random_bits_and_uniform_exact(shape):
    jk = jax.random.split(jax.random.PRNGKey(11))[1]
    tk = trandom.split(trandom.PRNGKey(11))[1]
    jbits = np.asarray(jax.random.bits(jk, shape, jnp.uint32), np.int64)
    np.testing.assert_array_equal(trandom.random_bits(tk, shape).numpy(),
                                  jbits)
    for lo, hi in ((0.0, 1.0), (0.0, 37.5), (float(np.finfo(np.float32).tiny),
                                             1.0)):
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        tu = trandom.uniform(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))


@pytest.mark.parametrize("shape", [(4, 8, 16), (2, 8, 128), (20000,)])
def test_normal_within_ulps(shape):
    jk = jax.random.PRNGKey(5)
    tk = trandom.PRNGKey(5)
    jn = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    tn = trandom.normal(tk, shape).numpy()
    assert np.isfinite(tn).all()
    assert _ulps(jn, tn).max() <= 4


def test_gumbel_within_ulps_and_same_top_k():
    n = 50000
    jk = jax.random.PRNGKey(9)
    tk = trandom.PRNGKey(9)
    jg = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
    tg = trandom.gumbel(tk, (n,)).numpy()
    # -log(-log u) passes through 0 at u = 1/e, where an ulp of the inner
    # log is many ulps of the result: bound the error on the scale of
    # max(1, |g|) instead
    eps = np.finfo(np.float32).eps
    assert (np.abs(jg - tg) <= 4 * eps * np.maximum(1.0, np.abs(jg))).all()
    # the seeding use: log-weights in {0, log 1e-6, -inf} plus the noise
    rng = np.random.default_rng(0)
    logw = np.where(rng.random(n) < 0.3, 0.0,
                    np.where(rng.random(n) < 0.5, np.log(np.float32(1e-6)),
                             -np.inf)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logw) + jnp.asarray(jg), 64)
    tv, ti = torch.sort(torch.tensor(logw) + torch.tensor(tg),
                        descending=True, stable=True)
    np.testing.assert_array_equal(ti[:64].numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_fold_in_exact(seed):
    """fold_in is the cipher on the counter (0, data): keys equal, for the
    layer-group indices init_params folds in and for 32-bit extremes."""
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    for data in (0, 1, 2, 23, 45, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            trandom.fold_in(tk, data).numpy(),
            np.asarray(jax.random.fold_in(jk, data), np.int64))
    # split then fold, as init_params does per pattern position
    js = jax.random.split(jk, 4)[2]
    ts = trandom.split(tk, 4)[2]
    np.testing.assert_array_equal(trandom.fold_in(ts, 3).numpy(),
                                  np.asarray(jax.random.fold_in(js, 3),
                                             np.int64))


@pytest.mark.parametrize("temperature", [1.0, 0.3])
def test_categorical_equal_draws(temperature):
    """categorical = argmax(logits + Gumbel noise): the noise is within
    ulps of jax's, so on logits without near-ties the draws are equal."""
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(64, 512)) * 3).astype(np.float32)
    for s in range(4):
        jk, tk = jax.random.PRNGKey(s), trandom.PRNGKey(s)
        want = np.asarray(jax.random.categorical(
            jk, jnp.asarray(logits) / temperature, axis=-1))
        got = trandom.categorical(tk, torch.tensor(logits) / temperature,
                                  axis=-1).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 4_194_304), (0, 131_072), (3, 17),
                                   (-5, 100), (0, 65_536), (0, 70_000),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                                   (10, 3)])
def test_randint_exact(lo, hi):
    """Integers, so equal: two draws per value combined modulo the span in
    uint32 arithmetic, including jax's multiplier that wraps to 0 for
    spans past 2**16, and minval for an empty span."""
    for seed in (0, 5):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (7, 33), lo, hi))
        got = trandom.randint(trandom.PRNGKey(seed), (7, 33), lo, hi)
        assert want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(500,), (4, 40)])
def test_bernoulli_exact(shape):
    """uniform < p: equal draws for arrays of p (bst_batch's click
    probabilities are (B,))."""
    p = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), shape))
    for seed in (0, 3):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p))
        got = trandom.bernoulli(trandom.PRNGKey(seed), torch.tensor(p))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
