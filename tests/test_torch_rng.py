"""The port's counter RNG and hash noise against the JAX package's.

Both packages key every draw by (seed, pixel, sample, tag) through PCG4D, so
the streams must agree bit for bit — that is what lets the CUDA kernel and
the plain torch integrator be compared with the JAX engines per pixel. The
torch side holds u32 words in int64 (the CPU build's uint32 has no + or >>),
so the inputs include values next to 2^32 - 1, where a wrong mask or an
overflowing product would show.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from real_time_ray_tracing_engine_tpu.utils import rng as jrng
from real_time_ray_tracing_engine_tpu.utils import perlin as jperlin
from real_time_ray_tracing_engine_tpu_torch.utils import rng as prng
from real_time_ray_tracing_engine_tpu_torch.utils import perlin as pperlin
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _u32_inputs(seed):
    r = np.random.default_rng(seed)
    edge = np.arange(2**32 - 64, 2**32, dtype=np.uint64)
    rand = r.integers(0, 2**32, 4000, dtype=np.uint64)
    small = np.arange(64, dtype=np.uint64)
    return np.concatenate([edge, rand, small]).astype(np.uint32)


def _t(x_u32):
    return torch.from_numpy(np.asarray(x_u32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg4d_bit_exact(seed):
    x = _u32_inputs(seed)
    words = [np.roll(x, 7 * i) for i in range(4)]
    ja = jrng._pcg4d(*(jnp.asarray(w) for w in words))
    pa = prng._pcg4d(*(_t(w) for w in words))
    for a, b in zip(ja, pa):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
        assert int(b.min()) >= 0 and int(b.max()) <= 0xFFFFFFFF


def test_to_unit_bit_exact():
    x = _u32_inputs(2)
    ju = np.asarray(jrng._to_unit(jnp.asarray(x)))
    pu = prng._to_unit(_t(x)).numpy()
    np.testing.assert_array_equal(ju, pu)
    assert pu.max() < 1.0 and pu.min() >= 0.0


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_uniforms_bit_exact(seed):
    pix = np.concatenate([np.arange(300), [2**31 - 1, 2**32 - 2]])
    samples = np.arange(pix.shape[0]) % 37
    jk = jrng.ray_keys(jnp.uint32(seed), jnp.asarray(pix, jnp.uint32),
                       jnp.asarray(samples, jnp.uint32))
    pk = prng.ray_keys(seed, torch.from_numpy(pix.astype(np.int64)),
                       torch.from_numpy(samples.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                  pk.numpy())
    for tag, n in ((0x0CA4, 5), (1_000_007, 4), (3, 1)):
        np.testing.assert_array_equal(
            np.asarray(jrng.uniforms(jk, tag, (n,))),
            prng.uniforms(pk, tag, (n,)).numpy())


def test_bounce_uniforms_bit_exact_per_ray_bounce():
    pix = np.arange(512)
    jk = jrng.ray_keys(jnp.uint32(11), jnp.asarray(pix, jnp.uint32),
                       jnp.uint32(5))
    pk = prng.ray_keys(11, torch.from_numpy(pix), 5)
    bounce = pix % 50
    # the lane wavefront draws with a per-ray bounce index; JAX's integrator
    # with a scalar one — row by row they must be the same stream
    pu = prng.bounce_uniforms(pk, torch.from_numpy(bounce)).numpy()
    for b in (0, 1, 49):
        ju = np.asarray(jrng.bounce_uniforms(jk, b))
        rows = bounce == b
        np.testing.assert_array_equal(ju[rows], pu[rows])


def _points(seed, n=3000):
    r = np.random.default_rng(seed)
    return r.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)


def test_noise3_matches():
    """Within 1e-6, not bit-exact: the gradient normalisation is an rsqrt,
    which XLA's CPU backend and torch round differently in the last bit."""
    p = _points(3)
    jn = np.asarray(jperlin.noise3(*(jnp.asarray(p[:, i]) for i in range(3)),
                                   jnp.uint32(5)))
    pn = pperlin.noise3(*(torch.from_numpy(p[:, i]) for i in range(3)),
                        5).numpy()
    assert np.abs(jn - pn).max() < 1e-6
    assert np.abs(pn).max() <= 1.0 + 1e-6


def test_turbulence3_matches():
    """7 octaves of |noise3|: the same last-bit rsqrt rounding, summed."""
    p = _points(4)
    for seed in (0, 2**32 - 3):
        jt = np.asarray(jperlin.turbulence3(
            *(jnp.asarray(p[:, i]) for i in range(3)), jnp.uint32(seed)))
        ptb = pperlin.turbulence3(
            *(torch.from_numpy(p[:, i]) for i in range(3)), seed).numpy()
        assert np.abs(jt - ptb).max() < 1e-6
