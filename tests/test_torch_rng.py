"""The port's counter-based RNG is bit-exact with gpu_ray_tracing_tpu.ops.rng.

Inputs are made with numpy from a seed and go through both packages; every
hash is compared with np.array_equal (no tolerance: the stream is a
contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ray_tracing_tpu.ops import rng as jrng
from gpu_ray_tracing_tpu_torch.ops import rng as trng
from gpu_ray_tracing_tpu_torch.ops.rays import hash_pixel_ids

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

# Salt families of the stream: raygen 1-4, scatter 16+3i..18+3i, Russian
# roulette 1000+i (i = bounce, up to the reference's depth 30).
SALT_FAMILIES = {
    "raygen": [1, 2, 3, 4],
    "scatter": [16 + 3 * i + k for i in range(30) for k in range(3)],
    "roulette": [1000 + i for i in range(30)],
}


@pytest.fixture(scope="module")
def values():
    v = np.random.default_rng(20261016).integers(0, 2**32, 10_000, dtype=np.uint64)
    v = v.astype(np.uint32)
    v[0], v[1] = 0, 2**32 - 1
    return v


def _t(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v.astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_wgsl_hash_bit_exact(values):
    assert np.array_equal(np.asarray(jrng.wgsl_hash(values)), _u32(trng.wgsl_hash(_t(values))))


@pytest.mark.parametrize("family", sorted(SALT_FAMILIES))
def test_hash2_bit_exact(values, family):
    tv = _t(values)
    for salt in SALT_FAMILIES[family]:
        want = np.asarray(jrng.hash2(values, np.uint32(salt)))
        assert np.array_equal(want, _u32(trng.hash2(tv, salt))), salt


@pytest.mark.parametrize("family", sorted(SALT_FAMILIES))
def test_uniform_hash_bit_exact(values, family):
    tv = _t(values)
    for salt in SALT_FAMILIES[family]:
        want = np.asarray(jrng.uniform_hash(values, np.uint32(salt)))
        got = trng.uniform_hash(tv, salt)
        assert got.dtype == torch.float32
        assert np.array_equal(want, got.numpy()), salt
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("sample_index,frame_seed", [(0, 0), (3, 42), (17, 2**32 - 1)])
def test_hash_pixel_seeds_bit_exact(sample_index, frame_seed):
    ids = hash_pixel_ids(64, 48)
    assert ids.shape == (48, 64)
    want = np.asarray(jrng.hash_pixel_seeds(
        ids.numpy().astype(np.uint32), jnp.uint32(sample_index), jnp.uint32(frame_seed)
    ))
    got = trng.hash_pixel_seeds(ids, sample_index, frame_seed)
    assert np.array_equal(want, _u32(got))


def test_mul32_is_exact_mod_2_32(values):
    """The 16-bit-half multiply never overflows int64 and equals the true
    product mod 2**32, including for the largest u32 operands."""
    b = np.random.default_rng(7).integers(0, 2**32, values.size, dtype=np.uint64)
    b[0] = b[1] = 2**32 - 1
    want = (values.astype(np.uint64) * b) & np.uint64(0xFFFFFFFF)
    got = trng._mul32(_t(values), torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(want.astype(np.uint32), _u32(got))
    for const in (trng._MUL, trng._SALT_MUL, trng._PIX_MUL, trng._SAMPLE_MUL):
        want = (values.astype(np.uint64) * np.uint64(const)) & np.uint64(0xFFFFFFFF)
        assert np.array_equal(want.astype(np.uint32), _u32(trng._mul32(_t(values), const)))


def test_int32_bit_patterns_hash_like_u32(values):
    as_i32 = torch.from_numpy(values.view(np.int32).copy())
    assert np.array_equal(_u32(trng.wgsl_hash(as_i32)), _u32(trng.wgsl_hash(_t(values))))


def test_independent_sampler_passes_draws_through(values):
    u1 = trng.uniform_hash(_t(values), 1)
    u2 = trng.uniform_hash(_t(values), 2)
    jx, jy = trng.sampler_jitter(u1, u2, _t(values), 0, 0, None)
    assert torch.equal(jx, u1 - 0.5) and torch.equal(jy, u2 - 0.5)
    # The stratified and Sobol samplers are accepted too (their bit-exact
    # tests are in tests/test_torch_sampler.py).
    su1, su2 = trng.sampler_uniforms(u1, u2, _t(values), 0, 0, ("stratified", 2, 2))
    assert su1.shape == u1.shape and float(su1.max()) < 1.0 and float(su2.min()) >= 0.0
