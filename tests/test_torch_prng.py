"""The numpy port of jax.random must give JAX's bits, keys and normals, so a
model id builds the same weights in agent_tpu_torch as in agent_tpu."""

import numpy as np
import pytest
import torch

import jax

from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import layers as jax_layers
from agent_tpu_torch.models import encoder, layers, prng

torch.set_num_threads(1)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("name", ["classify-default", "model-a", "", "ünïcode/ckpt.npz"])
def test_seed_from_matches_jax(name):
    np.testing.assert_array_equal(layers.seed_from(name),
                                  np.asarray(jax_layers.seed_from(name)))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 + 7, 2 ** 32 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 7, 15])
def test_split_matches_jax(num):
    key = jax.random.PRNGKey(2807720001)
    np.testing.assert_array_equal(prng.split(np.asarray(key), num),
                                  np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(5,), (33, 17), (4, 3, 8)])
def test_random_bits_match_jax(shape):
    key = jax.random.PRNGKey(99)
    np.testing.assert_array_equal(prng.random_bits(np.asarray(key), shape),
                                  np.asarray(jax.random.bits(key, shape)))


@pytest.mark.parametrize("shape", [(1000,), (260, 256), (64, 4, 16)])
def test_normal_within_one_ulp_of_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(7), len(shape))
    got = prng.normal(np.asarray(key), shape)
    want = np.asarray(jax.random.normal(key, shape))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("draw", ["bits", "normal"])
def test_parallel_draw_matches_jax(draw):
    """An array drawn in parallel chunks (over 2 * PARALLEL_CHUNK elements)
    gives the same bits as JAX's one draw."""
    shape = (2 * prng.PARALLEL_CHUNK // 1000 + 7, 1000)
    key = jax.random.PRNGKey(31)
    if draw == "bits":
        np.testing.assert_array_equal(prng.random_bits(np.asarray(key), shape),
                                      np.asarray(jax.random.bits(key, shape)))
    else:
        got = prng.normal(np.asarray(key), shape)
        assert _ulps(got, np.asarray(jax.random.normal(key, shape))).max() <= 1


def test_init_params_match_jax_leaf_for_leaf():
    cfg_j = jax_encoder.EncoderConfig()
    cfg_t = encoder.EncoderConfig()
    want = layers.flatten(jax.tree_util.tree_map(np.asarray,
                                                 jax_encoder.init_params(cfg_j, "classify-default")))
    got = encoder.init_params(cfg_t, "classify-default")
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32, key
        assert _ulps(got[key], want[key]).max() <= 1, key
