"""The port's threefry twin (`gbdt.prng`) against `jax.random`, bit for bit.

JAX's default here is `jax_threefry_partitionable = True`, which sets the
bits of `split` and `uniform`; the twin is held to this JAX. The JAX draws
are taken without x64, as the JAX trainer and bench.py run (the suite's
conftest turns x64 on, and then `jax.random.uniform` draws float64).
Every comparison is exact: keys as uint32 words, draws as their float32
bits.
"""

import numpy as np
import pytest
import torch

import jax

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.gbdt import prng

SEEDS = [0, 20170425, 7, 2 ** 31 - 1]


def _words(k):
    return np.asarray(k).astype(np.int64)


def _bits(u):
    return np.asarray(u, np.float32).view(np.uint32)


def _juniform(key, shape):
    with jax.enable_x64(False):
        u = jax.random.uniform(key, shape)
        assert u.dtype == np.float32
        return np.asarray(u)


def test_jax_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(k.numpy(), _words(jk))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(k, n).numpy(),
                                      _words(jax.random.split(jk, n)))


def test_round_chain_and_its_three_keys():
    """The trainer's chain: fold_in(PRNGKey(20170425), r) for r = 0..40,
    each split into (kf, ki, kg) and kg folded with the group 0."""
    jroot, root = jax.random.PRNGKey(20170425), prng.PRNGKey(20170425)
    for r in range(41):
        jk, k = jax.random.fold_in(jroot, r), prng.fold_in(root, r)
        np.testing.assert_array_equal(k.numpy(), _words(jk))
        jkf, jki, jkg = jax.random.split(jk, 3)
        kf, ki, kg = prng.split(k, 3)
        for a, b in ((kf, jkf), (ki, jki), (kg, jkg)):
            np.testing.assert_array_equal(a.numpy(), _words(b))
        np.testing.assert_array_equal(prng.fold_in(kg, 0).numpy(),
                                      _words(jax.random.fold_in(jkg, 0)))


@pytest.mark.parametrize("seed", [0, 20170425])
@pytest.mark.parametrize("n", [1, 7, 1000, (1 << 20) + 3])
def test_uniform_bits(seed, n):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    k = prng.fold_in(prng.PRNGKey(seed), 3)
    got = prng.uniform(k, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_juniform(jk, (n,))))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_is_prefix_stable_and_shaped():
    k = prng.PRNGKey(20170425)
    u10 = prng.uniform(k, 10)
    assert torch.equal(u10[:7], prng.uniform(k, 7))
    np.testing.assert_array_equal(
        _bits(prng.uniform(k, (3, 5)).numpy()),
        _bits(_juniform(jax.random.PRNGKey(20170425), (3, 5))))


def test_keys_are_checked():
    with pytest.raises(ValueError, match="int64"):
        prng.split(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 2"):
        prng.uniform(prng.PRNGKey(0), (1 << 16, 1 << 15))
