"""The scheduler's random draws against jax.random: ``randint`` as
``hybrid_schedule_batch`` draws it (``jax.random.randint(key, (), 0, kk)``,
ranges of 1 and ranges that are no power of two), ``split``, and the
per-shape jitter uniforms of the waterfall, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch import _jaxrng as R
from ray_tpu_torch.scheduler import hybrid as T

SEEDS = [0, 1, 7, 123456, 2**31 + 5, 2**32 - 1]
SPANS = [1, 2, 3, 5, 7, 100, 204, 1000, 2**20 + 3, 2**31 - 1]


def _pair(seed, i):
    kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.uint32(i))
    return kj, R.fold_in(R.prng_key(seed), i)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_and_split_bit_exact(seed):
    for i in (0, 3, 511):
        kj, kt = _pair(seed, i)
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj)).astype(np.int64),
                                      R.split(kt).numpy())
        for hi in SPANS:
            assert int(jax.random.randint(kj, (), 0, hi)) == int(R.randint(kt, 0, hi))
        assert int(jax.random.randint(kj, (), 0, 0)) == int(R.randint(kt, 0, 0)) == 0
        assert int(jax.random.randint(kj, (), 3, 9)) == int(R.randint(kt, 3, 9))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_batch_kernel_draws_match_one_by_one(seed):
    """hybrid_schedule_batch draws every step's two words in one call and
    folds each pick's span in on the device: the same values as
    jax.random.randint on each step's key."""
    base = R.prng_key(seed)
    keys = R.fold_in(base, torch.arange(64))
    bits = R.random_bits(R.fold_in(keys[:, None, :], torch.arange(2)), ())
    for i in (0, 1, 17, 63):
        kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.uint32(i))
        for hi in (1, 3, 8, 13):
            got = T._randint_from_bits(bits[i, 0], bits[i, 1], torch.tensor(hi))
            assert int(got) == int(jax.random.randint(kj, (), 0, hi))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_waterfall_jitter_rows_bit_exact(seed):
    """The shapes and ring programs draw all shapes' jitter rows at once:
    row u equals jax.random.uniform(fold_in(key, u), (n,))."""
    n, u = 37, 6
    rows = R.uniform(R.fold_in(R.prng_key(seed), torch.arange(u)), (n,))
    for i in range(u):
        kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.int32(i))
        want = np.asarray(jax.random.uniform(kj, (n,), dtype=np.float32))
        np.testing.assert_array_equal(want.view(np.int32), rows[i].numpy().view(np.int32))
