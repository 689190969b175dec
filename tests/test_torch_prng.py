"""The port's key stream (``synapseml_tpu_torch/gbdt/prng.py``) against
``jax.random``, on the CPU.

Bitwise, at every seed and size: the boosting loop's bagging, GOSS and
``feature_fraction`` masks are drawn from these bits, so a single differing
bit would sample other rows. The sizes include ones where a
non-partitionable threefry would give other bits (odd sizes; a draw is not
a prefix of a larger one), and ``f`` past 1,625, where ``permutation``
takes a second round. The same functions on the card are held to these
CPU results by ``chip_smoke.py`` (phase ``prng_card_vs_cpu``).
"""
import jax
import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SIZES = [1, 7, 1_000, 32_561]
FEATURES = [1, 3, 14, 1_000, 2_000]


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_runs_in_the_mode_it_reproduces():
    """The module reproduces partitionable threefry with 32-bit keys,
    jax's default; the tests below would not hold in another mode."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS + [-5, 2 ** 32 + 5])
def test_prng_key(seed):
    assert np.array_equal(prng.prng_key(seed, "cpu").numpy(),
                          _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain(seed):
    """Eight steps of the boosting loop's ``rng, key = split(rng)``, each
    key split once more, as every tree does."""
    jrng, trng = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    for _ in range(8):
        jrng, jkey = jax.random.split(jrng)
        trng, tkey = prng.split(trng)
        assert np.array_equal(trng.numpy(), _words(jrng))
        assert np.array_equal(tkey.numpy(), _words(jkey))
        for j, t in zip(jax.random.split(jkey), prng.split(tkey)):
            assert np.array_equal(t.numpy(), _words(j))


@pytest.mark.parametrize("data", [0, 3, 2 ** 31 - 1, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = prng.fold_in(torch.from_numpy(_words(key)), data)
    assert np.array_equal(got.numpy(), _words(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits32_and_uniform(seed, n):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    tkey = torch.from_numpy(_words(key))
    bits = np.asarray(jax.random.bits(key, (n,))).astype(np.int64)
    assert np.array_equal(prng.random_bits32(tkey, n).numpy(), bits)
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = prng.uniform(tkey, n).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed, f):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = prng.permutation(torch.from_numpy(_words(key)), f).numpy()
    assert np.array_equal(got, np.asarray(jax.random.permutation(key, f)))
