"""PCG4D streams of the port, bit-equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.utils import prng as tprng
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

N = 4096


@pytest.fixture(scope="module")
def triples():
    rs = np.random.RandomState(1234)
    seed, pixel, sample = (rs.randint(0, 2**32, size=N, dtype=np.uint64)
                           .astype(np.uint32) for _ in range(3))
    return seed, pixel, sample


def _streams(seed, pixel, sample):
    j = jprng.PathStream(jnp.asarray(seed), jnp.asarray(pixel),
                         jnp.asarray(sample))
    t = tprng.PathStream(*(torch.from_numpy(a.astype(np.int64))
                           for a in (seed, pixel, sample)))
    return j, t


def test_pcg4d_words_bit_equal(triples):
    rs = np.random.RandomState(99)
    tag = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    words = [*triples, tag]
    got_j = jprng._pcg4d(*(jnp.asarray(w) for w in words))
    got_t = tprng._pcg4d(*(torch.from_numpy(w.astype(np.int64)) for w in words))
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_to_unit_exact(triples):
    x = triples[0]
    np.testing.assert_array_equal(
        np.asarray(jprng._to_unit(jnp.asarray(x))),
        tprng._to_unit(torch.from_numpy(x.astype(np.int64))).numpy())


def test_jitter_uniforms_bit_equal(triples):
    j, t = _streams(*triples)
    for a, b in zip(jprng.jitter_uniforms(j), tprng.jitter_uniforms(t)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_lens_uniforms_bit_equal(triples):
    j, t = _streams(*triples)
    for a, b in zip(jprng.lens_uniforms(j), tprng.lens_uniforms(t)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("key", [0, 7, 2**31 + 5])
def test_lens_uniforms_on_ray_index(key):
    """The thin lens keys its stream on (key, pixel, s // pp), as
    pallas_backend.py:189-193 does."""
    pix = np.arange(300) * 37 % 9973
    s = np.arange(300) % 16
    ray_index = s // 4
    js = jprng.path_keys(key, jnp.asarray(pix), jnp.asarray(ray_index))
    ts = tprng.path_keys(key, torch.from_numpy(pix),
                         torch.from_numpy(ray_index))
    for a, b in zip(jprng.lens_uniforms(js), tprng.lens_uniforms(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bounce", [0, 1, 2, 3])
def test_bounce_uniforms_bit_equal(triples, bounce):
    j, t = _streams(*triples)
    got_j = jprng.bounce_uniforms(j, bounce)
    got_t = tprng.bounce_uniforms(t, bounce)
    assert len(got_t) == jprng.BOUNCE_SLOTS
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bounce_uniforms_per_lane_bounce(triples):
    """A per-lane bounce tensor draws what each scalar bounce draws."""
    j, t = _streams(*triples)
    b = np.arange(N) % 4
    got_t = tprng.bounce_uniforms(t, torch.from_numpy(b))
    got_j = jprng.bounce_uniforms(j, jnp.asarray(b, jnp.int32))
    for a, c in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())


def test_path_keys_match():
    pix = torch.arange(100)
    s = tprng.path_keys(7, pix, 3)
    js = jprng.path_keys(7, jnp.arange(100), 3)
    for a, b in zip(js, s):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
