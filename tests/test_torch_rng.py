"""PyTorch port: threefry key split and the per-ray murmur uniforms are
bit-equal to the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.render.wavefront import ray_uniforms  # noqa: E402

from atray_tpu_torch.render.rng import mix32, prng_key, ray_uniform_cols, split  # noqa: E402

SEEDS = [0, 1, 7, 2 ** 31 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    ref = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng_key(seed), np.asarray(ref))
    for num in (2, 3):
        np.testing.assert_array_equal(split(prng_key(seed), num),
                                      np.asarray(jax.random.split(ref, num)))


def test_mix32_matches_uint32_numpy():
    x = np.random.default_rng(0).integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2 ** 32 - 1, 2 ** 31]]).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = x ^ (x >> np.uint32(16))
        want = want * np.uint32(0x85EBCA6B)
        want = want ^ (want >> np.uint32(13))
        want = want * np.uint32(0xC2B2AE35)
        want = want ^ (want >> np.uint32(16))
    got = mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("bounce", range(5))
def test_ray_uniforms_bit_equal(bounce):
    ids = np.concatenate([
        np.arange(0, 3000), 2 ** 25 + np.arange(3000), [2 ** 31 - 1, 2 ** 24 + 1],
    ]).astype(np.int32)
    key = jax.random.split(jax.random.PRNGKey(9))[1]
    ref = np.asarray(ray_uniforms(key, jnp.asarray(ids), bounce))
    got = ray_uniform_cols(np.asarray(key), torch.from_numpy(ids), bounce)
    got = torch.stack(got, dim=1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert got.min() >= -1.0 and got.max() < 1.0
