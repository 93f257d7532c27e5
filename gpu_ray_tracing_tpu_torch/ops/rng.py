"""Counter-based hash RNG (port of gpu_ray_tracing_tpu/ops/rng.py).

Every draw is a pure function of (global pixel id, sample index, frame
seed, salt), bit-exact with the JAX package.  PyTorch's CPU build has no
`+` or `>>` on uint32 tensors, so u32 values are carried in int64 tensors
in [0, 2**32) and masked after every operation.  A u32 product can reach
2**64 and would wrap int64, so `_mul32` multiplies by 16-bit halves: every
intermediate stays below 2**49.  The same code runs on CUDA tensors; the
megakernel (ops/cuda/megakernel.cu) computes the identical hashes in native
`unsigned int` arithmetic.

Returned hashes are int64 tensors holding u32 values; inputs may be any
integer tensor (int32 bit patterns included) or a Python int.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_XOR_SEED = 2747636419
_MUL = 2654435769
_SALT_MUL = 0x68E31DA4
_PIX_MUL = 2654435761
_SAMPLE_MUL = 0x85EBCA6B
_INV_2_24 = 1.0 / (1 << 24)


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


def sampler_uniforms(u1, u2, pixel_ids, sample_index, frame_seed_u32, spec):
    """One dimension pair through the configured sampler.  Only the
    independent sampler (spec None) is ported: the draws pass through."""
    if spec is not None:
        raise NotImplementedError(
            f"sampler spec {spec!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    return u1, u2


def sampler_jitter(u1, u2, pixel_ids, sample_index, frame_seed_u32, spec):
    """AA pixel-jitter pair in [-0.5, 0.5)."""
    su1, su2 = sampler_uniforms(
        u1, u2, pixel_ids, sample_index, frame_seed_u32, spec
    )
    return su1 - 0.5, su2 - 0.5


def unit_vector_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform unit vector from two U[0,1) draws; shape u1.shape + (3,)."""
    z = 2.0 * u1 - 1.0
    a = u2 * torch.tensor(2.0 * torch.pi, dtype=torch.float32)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)
