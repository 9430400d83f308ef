"""The port's threefry2x32 key tree equals jax.random's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastconsensus_tpu.utils import prng as jprng
from fastconsensus_tpu_torch.utils import prng

# The port's CPU ops are many and small: one thread runs them fastest,
# and parallel test workers then do not oversubscribe the cores.
torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -3]


def data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), prng.key(seed, "cpu")
    assert (prng.key_data(tk) == data(jk)).all()
    for d in (0, 3, 2 ** 31 + 5):
        assert (prng.key_data(prng.fold_in(tk, d)) ==
                data(jax.random.fold_in(jk, d))).all()
    for num in (2, 3, 7):
        assert (prng.key_data(prng.split(tk, num)) ==
                data(jax.random.split(jk, num))).all()
    # wrap/unwrap round trip
    assert (prng.key_data(prng.wrap_key_data(data(jk), "cpu")) == data(jk)).all()


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 7), (2, 3, 4)])
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed, "cpu")
    np.testing.assert_array_equal(
        prng.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    for p in (0.5, 0.1):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("hi", [1, 5, 34, 100_000, 3_000_001, 2 ** 31 - 1])
def test_randint(seed, hi):
    jk, tk = jax.random.key(seed), prng.key(seed, "cpu")
    np.testing.assert_array_equal(
        prng.randint(tk, (999,), 0, hi).numpy(),
        np.asarray(jax.random.randint(jk, (999,), 0, hi, dtype=jnp.int32)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_streams_and_partition_keys(seed):
    jk, tk = jax.random.key(seed), prng.key(seed, "cpu")
    assert (prng.key_data(prng.partition_keys(tk, 9)) ==
            data(jprng.partition_keys(jk, 9))).all()
    assert (prng.key_data(prng.stream(tk, prng.STREAM_ROUND, 4)) ==
            data(jprng.stream(jk, jprng.STREAM_ROUND, 4))).all()
    assert (prng.key_data(prng.stream(tk, prng.STREAM_FINAL)) ==
            data(jprng.stream(jk, jprng.STREAM_FINAL))).all()


def test_batched_keys_broadcast():
    """A [M, 2] batch of keys draws exactly what each key draws alone."""
    keys = [jax.random.fold_in(jax.random.key(5), i) for i in range(4)]
    batch = prng.wrap_key_data(np.stack([data(k) for k in keys]),
                               "cpu")
    got = prng.uniform(prng.split(batch, 3)[:, 1], (6,)).numpy()
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.uniform(jax.random.split(k, 3)[1],
                                                  (6,))))
