"""Counter-based hash RNG, the WGSL parity stream and the threefry mode's
keyed generators (port of gpu_ray_tracing_tpu/ops/rng.py).

Every draw is a pure function of (global pixel id, sample index, frame
seed, salt), bit-exact with the JAX package.  The WGSL stream's pieces
(`wgsl_random_float`, `seed_from_f32`, `random_unit_vector`,
`pixel_seeds`) are the reference shader's own chains, also bit-exact.  PyTorch's CPU build has no
`+` or `>>` on uint32 tensors, so u32 values are carried in int64 tensors
in [0, 2**32) and masked after every operation.  A u32 product can reach
2**64 and would wrap int64, so `_mul32` multiplies by 16-bit halves: every
intermediate stays below 2**49.  The same code runs on CUDA tensors; the
megakernel (ops/cuda/megakernel.cu) computes the identical hashes in native
`unsigned int` arithmetic.

Returned hashes are int64 tensors holding u32 values; inputs may be any
integer tensor (int32 bit patterns included) or a Python int.

rng='threefry' is jax.random's default stream bit for bit: threefry2x32
under JAX's partitionable counters (`threefry2x32`, `prng_key`, `split`,
`fold_in`, `uniform`).  A key is JAX's two u32 words; `split` and
`fold_in` hash them on the host, and `uniform` hashes its counters in the
same int64 arithmetic on whatever device it is given, so the CPU and the
card draw the same bits for one key.
"""

from __future__ import annotations

import math

import torch

from gpu_ray_tracing_tpu_torch.ops.rounding import cos_sin, fma, sqrt, xla_fma

_MASK = 0xFFFFFFFF
_XOR_SEED = 2747636419
_MUL = 2654435769
_SALT_MUL = 0x68E31DA4
_PIX_MUL = 2654435761
_SAMPLE_MUL = 0x85EBCA6B
_INV_2_24 = 1.0 / (1 << 24)
# f32(4294967295.0) is 2**32: dividing by it is scaling by 2**-32, exact.
_INV_2_32 = 1.0 / (1 << 32)
_U32_MAX_F = 4294967295.0


def as_u32(x, device: torch.device | None = None) -> torch.Tensor:
    """An int64 tensor holding the u32 value(s) of `x` (modular)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 values held in int64, without overflow."""
    if isinstance(b, torch.Tensor):
        b_lo, b_hi = b & 0xFFFF, b >> 16
    else:
        b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _MASK


def _device_of(*xs) -> torch.device | None:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def wgsl_hash(value) -> torch.Tensor:
    """The WGSL integer hash (compute_shader.wgsl:50-59)."""
    s = as_u32(value) ^ _XOR_SEED
    s = _mul32(s, _MUL)
    s = s ^ (s >> 16)
    s = _mul32(s, _MUL)
    s = s ^ (s >> 16)
    return _mul32(s, _MUL)


def wgsl_random_float(value) -> torch.Tensor:
    """hash(value) / 4294967295.0 as f32 in [0, 1] (wgsl:61-63)."""
    return wgsl_hash(value).to(torch.float32) * _INV_2_32


def seed_from_f32(seed01) -> torch.Tensor:
    """u32(seed * 4294967295.0) with WGSL's saturating f32->u32 cast
    (wgsl:311,353), as int64 holding u32.  The product of a seed within an
    ulp of 1 rounds to 2**32, which saturates to u32::MAX; a negative
    product clamps to 0 and NaN maps to 0.  Both are written out rather
    than left to the float->int cast, which is undefined out of range."""
    x = torch.as_tensor(seed01, dtype=torch.float32) * _U32_MAX_F
    x = torch.where(torch.isnan(x), 0.0, torch.clamp(x, min=0.0))
    # Below 2**32 the largest f32 is 4294967040, which converts exactly.
    return torch.where(x >= 4294967296.0, _MASK,
                       torch.clamp(x, max=4294967040.0).to(torch.int64))


def random_unit_vector(seed) -> torch.Tensor:
    """Uniform point on the unit sphere from two hash draws of the WGSL
    stream (wgsl:234-243): shape seed.shape + (3,)."""
    seed = as_u32(seed)
    return unit_vector_from_uniforms(wgsl_random_float(seed),
                                     wgsl_random_float((seed + 1) & _MASK))


def pixel_seeds(width: int, height: int, sample_index, frame_seed_u32, y_offset: int = 0,
                device=None) -> torch.Tensor:
    """The WGSL per-pixel seed grid of get_ray (wgsl:309-311),
    hash(hash(x*73) ^ hash(y*51) ^ (sample_index*25 + frame_seed)), as a
    (height, width) int64 tensor of u32 values; `y_offset` shifts the
    global row (a row band of a taller frame)."""
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    y = (torch.arange(height, dtype=torch.int64, device=device)[:, None] + y_offset) & _MASK
    mix = (_mul32(as_u32(sample_index, device), 25) + as_u32(frame_seed_u32, device)) & _MASK
    return wgsl_hash(wgsl_hash(_mul32(x, 73)) ^ wgsl_hash(_mul32(y, 51)) ^ mix)


def hash2(seed, salt) -> torch.Tensor:
    """Independent stream from (seed, salt): hash(seed + salt*C)."""
    dev = _device_of(seed, salt)
    salt = as_u32(salt, dev)
    return wgsl_hash((as_u32(seed, dev) + _mul32(salt, _SALT_MUL)) & _MASK)


def uniform_hash(seed, salt) -> torch.Tensor:
    """U[0,1) f32 from (seed, salt): the top 24 bits / 2**24.  The 24-bit
    construction is part of the stream (exact in f32)."""
    bits = hash2(seed, salt) >> 8
    return bits.to(torch.float32) * _INV_2_24


def hash_pixel_seeds(pixel_ids, sample_index, frame_seed_u32) -> torch.Tensor:
    """Per-pixel base seed from global pixel id + sample index + frame seed."""
    dev = _device_of(pixel_ids, sample_index, frame_seed_u32)
    inner = wgsl_hash(
        (_mul32(as_u32(sample_index, dev), _SAMPLE_MUL)
         + as_u32(frame_seed_u32, dev)) & _MASK
    )
    return wgsl_hash(_mul32(as_u32(pixel_ids, dev), _PIX_MUL) ^ inner)


#: Pair ids ("rotation salts") of the stratified/Sobol sampler, drawn on the
#: sample-0 pixel seed: AA jitter 5, first-bounce scatter 6, thin-lens point
#: 7, and NEE light g of the <= 4-light loop 8 + g.
_STRATUM_ROT_SALT = 5
_SCATTER_ROT_SALT = 6
_LENS_ROT_SALT = 7
_NEE_ROT_SALT_BASE = 8


def strata_shape(spp: int) -> tuple[int, int]:
    """Factor spp into a (kx, ky) grid, kx the largest divisor <= sqrt(spp)."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    kx = max(1, int(spp**0.5))
    while spp % kx:
        kx -= 1
    return kx, spp // kx


def stratified_uniforms(u1, u2, pixel_ids, sample_index, frame_seed_u32,
                        strata: tuple[int, int], rot_salt=_STRATUM_ROT_SALT,
                        shift: float = 0.0, y_scale: float = 1.0):
    """Remap two U[0,1) draws into sample s's stratum of a kx*ky grid: sample
    s lands in stratum (s + rot(pixel, frame)) mod K, jittered inside it by
    (u1, u2).  `rot_salt` names the pair, so pairs rotate independently.

    Two knobs round as jitted XLA rounds what its callers do next: `shift`
    is subtracted from both outputs in one fused multiply-add with the
    scaling (the AA jitter's 0.5), and `y_scale` multiplies the second
    output, folded into its 1/ky constant (the lens angle's 2 pi)."""
    kx, ky = strata
    k_total = kx * ky
    if k_total == 1:
        return u1 - shift, u2 * y_scale - shift
    dev = _device_of(u1, pixel_ids)
    rot_u = uniform_hash(hash_pixel_seeds(pixel_ids, 0, frame_seed_u32), rot_salt)
    rot = torch.clamp(torch.floor(rot_u * float(k_total)), max=float(k_total - 1))
    s_f = (as_u32(sample_index, dev) % k_total).to(torch.float32)
    stratum = rot + s_f
    stratum = torch.where(stratum >= k_total, stratum - float(k_total), stratum)
    # Division by a constant as jitted XLA computes it: times the f32
    # reciprocal (the megakernel does the same).
    inv_kx, inv_ky = _f32_recip(kx), _f32_recip(ky)
    cy = torch.floor(stratum * inv_kx)
    cx = stratum - cy * float(kx)
    inv_ky = inv_ky * y_scale
    if shift:
        neg = torch.tensor(-shift, dtype=torch.float32)
        return fma(cx + u1, inv_kx, neg), fma(cy + u2, inv_ky, neg)
    return (cx + u1) * inv_kx, (cy + u2) * inv_ky


def _f32_recip(k: int) -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32) / float(k)


def _sobol_dim1_directions() -> list[int]:
    """Direction numbers of Sobol dimension 1: v_0 = 2**31,
    v_{b+1} = v_b ^ (v_b >> 1)."""
    v, out = 0x80000000, []
    for _ in range(32):
        out.append(v)
        v ^= v >> 1
    return out


_SOBOL_DIM1 = _sobol_dim1_directions()


def sobol_nbits(spp: int) -> int:
    """Bits covering every sample index an spp budget can reach (up to
    2*spp - 2, the progressive straddle window)."""
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    return max(1, (2 * spp - 2).bit_length())


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bitwise reversal of u32 values held in int64 (5 swap rounds)."""
    x = (x >> 16) | ((x << 16) & _MASK)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    return ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras permutation (Burley, JCGT 2020): each output bit depends
    only on input bits at or below it."""
    x = (x + seed) & _MASK
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def _u32_msb_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of an MSB-first fraction as f32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def sobol02_uniforms(pixel_ids, sample_index, frame_seed_u32, nbits: int,
                     rot_salt=_STRATUM_ROT_SALT):
    """Owen-scrambled 2D Sobol point of `sample_index` for one dimension
    pair, scrambled per (pixel, frame, pair); sample_index < 2**nbits."""
    base = hash_pixel_seeds(pixel_ids, 0, frame_seed_u32)
    seed_x = hash2(base, rot_salt)
    seed_y = wgsl_hash(seed_x)
    s = as_u32(sample_index, base.device)
    # Dimension 0 is the bit-reversed index, so owen(reverse(s)) =
    # reverse(LK(s)).
    x = _reverse_bits32(_laine_karras(s, seed_x))
    y1 = torch.zeros_like(s)
    for b in range(nbits):
        y1 = y1 ^ (((s >> b) & 1) * _SOBOL_DIM1[b])
    y = _reverse_bits32(_laine_karras(_reverse_bits32(y1), seed_y))
    return _u32_msb_to_f32(x), _u32_msb_to_f32(y)


def sampler_uniforms(u1, u2, pixel_ids, sample_index, frame_seed_u32, spec,
                     rot_salt=_STRATUM_ROT_SALT, shift: float = 0.0, y_scale: float = 1.0):
    """One dimension pair through the configured sampler: spec None passes
    (u1, u2) through; ('stratified', kx, ky) remaps them into sample s's
    stratum; ('sobol', nbits) replaces them with the scrambled Sobol point.
    `rot_salt` names the pair; both outputs come less `shift` and the
    second times `y_scale` (see stratified_uniforms)."""
    if spec is None:
        return u1 - shift, u2 * y_scale - shift
    if spec[0] == "stratified":
        return stratified_uniforms(u1, u2, pixel_ids, sample_index, frame_seed_u32,
                                   tuple(spec[1:]), rot_salt=rot_salt, shift=shift,
                                   y_scale=y_scale)
    if spec[0] == "sobol":
        x, y = sobol02_uniforms(pixel_ids, sample_index, frame_seed_u32, spec[1],
                                rot_salt=rot_salt)
        return x - shift, y * y_scale - shift
    raise ValueError(f"unknown sampler spec {spec!r}")


def sampler_jitter(u1, u2, pixel_ids, sample_index, frame_seed_u32, spec):
    """AA pixel-jitter pair in [-0.5, 0.5) under the configured sampler."""
    return sampler_uniforms(u1, u2, pixel_ids, sample_index, frame_seed_u32, spec,
                            shift=0.5)


def unit_vector_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform unit vector from two U[0,1) draws; shape u1.shape + (3,).
    On the CPU rounded as jitted XLA:CPU rounds it (1 - z^2 as one fused
    multiply-add, cos and sin as glibc's), on the card as the kernel does."""
    z = 2.0 * u1 - 1.0
    a = u2 * torch.tensor(2.0 * torch.pi, dtype=torch.float32)
    r = sqrt(torch.clamp(xla_fma(-z, z, torch.ones_like(z)), min=0.0))
    cos_a, sin_a = cos_sin(a, f64_on_card=False)
    return torch.stack([r * cos_a, r * sin_a, z], dim=-1)


# rng='threefry': jax.random's default generator, threefry2x32 with
# jax_threefry_partitionable (JAX's default), bit for bit.  A key is JAX's
# two u32 words (k0, k1); keys are scalars, so split and fold_in hash them
# as Python ints on the host, and only uniform's counter hash runs on
# tensors, in the int64-masked arithmetic above.
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 of the counter (x0, x1) under the key (k0, k1): 20
    rounds in 5 groups of 4, a key injection after each group
    (jax._src.prng._threefry2x32_lowering).  x0, x1 are Python ints or
    int64 tensors of u32 values; returns the two output words alike.
    x0 only ever meets additions and an xor that is masked, so it is
    masked once, at the end (it stays below 2**38); x1 is masked a round,
    as the rotation needs its 32 bits."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _KS_PARITY) & _MASK)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(g + 1) % 3]
        x1 = (x1 + (ks[(g + 2) % 3] + g + 1)) & _MASK
    return x0 & _MASK, x1


Key = tuple[int, int]


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with 32-bit ints: (0, seed mod 2**32)."""
    return 0, int(seed) & _MASK


def as_key(key) -> Key:
    """A key given as an int (read as prng_key(key)) or as two u32 words
    (jax.random.key_data's pair: a tuple, list, array or tensor of 2)."""
    if isinstance(key, int) or getattr(key, "ndim", None) == 0:
        return prng_key(int(key))
    words = [int(w) & _MASK for w in (key.tolist() if hasattr(key, "tolist") else key)]
    if len(words) != 2:
        raise ValueError(f"a key is an int or two u32 words, got {key!r}")
    return words[0], words[1]


def split(key: Key) -> tuple[Key, Key]:
    """jax.random.split(key): the keys of the counters (0, 0) and (0, 1)."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, 0), threefry2x32(k0, k1, 0, 1)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data): the key of the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape) in f32: flat index i draws the bits
    x0 ^ x1 of the counter (i >> 32, i mod 2**32), and their top 23 bits
    are the mantissa of a float in [1, 2), less 1."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], i >> 32, i & _MASK)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(tuple(shape))
