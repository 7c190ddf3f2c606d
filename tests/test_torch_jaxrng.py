"""ray_tpu_torch._jaxrng against jax.random: keys, fold_in, random bits
and uniforms bit for bit; Gumbel noise to the ulp; categorical draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch import _jaxrng as R

SEEDS = [0, 1, 7, 42, 123456789, 2**31, 2**32 - 1]


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    kj = jax.random.PRNGKey(np.uint32(seed))
    kt = R.prng_key(seed)
    np.testing.assert_array_equal(_key_words(kj), kt.numpy())
    for data in [0, 1, 5, 97, 2**31 + 3, 2**32 - 1]:
        want = _key_words(jax.random.fold_in(kj, np.uint32(data)))
        np.testing.assert_array_equal(want, R.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (96,), (3, 5), (2, 3, 4)])
def test_bits_and_uniform_bit_exact(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), 11)
    kt = R.fold_in(R.prng_key(seed), 11)
    bj = np.asarray(jax.random.bits(kj, shape)).astype(np.int64)
    np.testing.assert_array_equal(bj, R.random_bits(kt, shape).numpy())
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = R.uniform(kt, shape).numpy()
    np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))


def test_batched_keys_match_one_by_one():
    """The engine draws every slot's noise in one call: a [B, 2] key batch
    must give each row exactly what its key alone gives."""
    seeds = torch.tensor([3, 9, 2**32 - 5, 0])
    positions = torch.tensor([17, 4, 100, 1])
    keys = R.fold_in(R.prng_key(seeds), positions)
    batched = R.uniform(keys, (33,))
    for i in range(4):
        one = R.uniform(R.fold_in(R.prng_key(int(seeds[i])), int(positions[i])), (33,))
        np.testing.assert_array_equal(batched[i].numpy(), one.numpy())
        kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(int(seeds[i]))),
                                int(positions[i]))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(kj, (33,))), one.numpy()
        )


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_to_the_ulp(seed):
    # the uniforms are bit-exact; -log(-log(u)) may differ by an ulp between
    # XLA's and torch's log, so Gumbel noise is held to 1e-5 absolute
    kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), 3)
    kt = R.fold_in(R.prng_key(seed), 3)
    np.testing.assert_allclose(
        np.asarray(jax.random.gumbel(kj, (257,))), R.gumbel(kt, (257,)).numpy(),
        rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed % 1000).normal(size=(5, 96)).astype(np.float32)
    for pos in range(5):
        kj = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), pos)
        want = int(jax.random.categorical(kj, jnp.asarray(logits[pos]) / 0.8))
        kt = R.fold_in(R.prng_key(seed), pos)
        got = int(R.categorical(kt, torch.from_numpy(logits[pos]) / 0.8))
        assert got == want
