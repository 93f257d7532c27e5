"""Fused multiply-adds, for rounding as the reference renders.

XLA:CPU contracts a*b+c into one fused multiply-add inside its fused loops,
and the JAX package's goldens carry that rounding.  A path tracer turns a
last-bit difference into a different path wherever a ray grazes a sphere
or leaves a surface (|o - c|^2 - r^2 near 0), so the plain version writes
those places as fused multiply-adds too: the pixel center and lens point
(ops/rays.py), the sphere quadratic and Moller-Trumbore's cross and inner
products (ops/intersect.py).  The CUDA
kernel does the same with fmaf.  PyTorch has no fma operator, so the
product is formed in f64, where the product of two f32 values is exact,
and the sum is rounded back to f32.

Three more functions round apart on the CPU.  jnp.sqrt is correctly
rounded, torch's f32 sqrt on the CPU is not (one ulp off in about 0.7% of
arguments): `sqrt` takes it in f64.  jnp.cos, jnp.sin and jnp.power on
XLA:CPU are glibc's cosf, sinf and powf, which are not correctly rounded:
`cos_sin` and `powf` call them (native/).

Some sums XLA:CPU contracts where the CUDA kernel, which follows the
Pallas kernel's arithmetic, does not: the BSDFs, the sky and the radiance
sums.  `xla_fma` and `xla_dot3` fuse them on the CPU, for the JAX
package's bits, and leave them unfused on a CUDA tensor, as the kernel
computes them.  On a CUDA tensor the functions above are likewise the
kernel's: PyTorch's own (which the card computes as the kernel does), or
f64 rounded to f32 where the kernel takes that, with no host round trip.
The card's plain frames are held to the kernels statistically, not bit
for bit.
"""

from __future__ import annotations

import torch

from gpu_ray_tracing_tpu_torch import native


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32, rounded once (broadcasting)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over a last axis of 3 (broadcasting), as the chain of
    fused multiply-adds XLA:CPU emits for a 3-term dot or sum."""
    t = a[..., 0] * b[..., 0]
    t = fma(a[..., 1], b[..., 1], t)
    return fma(a[..., 2], b[..., 2], t)


def xla_fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once on the CPU, as XLA:CPU contracts it; rounded
    twice (a * b, then + c) on a CUDA tensor, as the kernel computes it."""
    return fma(a, b, c) if a.device.type == "cpu" else a * b + c


def xla_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over a last axis of 3: dot3's fused chain on the CPU,
    the unfused sum left to right on a CUDA tensor."""
    return dot3(a, b) if a.device.type == "cpu" else torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over a last axis of 3, each component rounded as
    XLA:CPU rounds a*b - c*d: fma(a, b, -(c*d))."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], dim=-1)


class _CosSin(torch.autograd.Function):
    """(cos x, sin x) of an f32 tensor, with jnp.cos's and jnp.sin's
    derivatives (-sin, cos of the values returned)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, f64_on_card: bool):
        x = x.detach()
        if x.device.type == "cpu":
            a = x.contiguous().numpy()
            c = torch.from_numpy(native.cosf(a))
            s = torch.from_numpy(native.sinf(a))
        elif f64_on_card:
            c, s = torch.cos(x.double()).float(), torch.sin(x.double()).float()
        else:
            c, s = torch.cos(x), torch.sin(x)
        ctx.save_for_backward(c, s)
        return c, s

    @staticmethod
    def backward(ctx, grad_c: torch.Tensor, grad_s: torch.Tensor) -> torch.Tensor:
        c, s = ctx.saved_tensors
        return grad_s * c - grad_c * s, None


def cos_sin(x: torch.Tensor, *, f64_on_card: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of an f32 tensor: on the CPU glibc's cosf and sinf, as
    jnp.cos and jnp.sin round them; on a CUDA tensor as the kernel takes
    this angle, in f64 rounded to f32 (the NEE cone, the lens) or in f32
    (`f64_on_card=False`: the scatter's unit vector)."""
    return _CosSin.apply(x.to(torch.float32), f64_on_card)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as jnp.sqrt: on the CPU taken in
    f64 (exact to the f32 rounding), on a CUDA tensor PyTorch's own."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


class _Pow(torch.autograd.Function):
    """x ** e of an f32 tensor for a Python float e, with the derivative
    e x^(e - 1)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, e: float) -> torch.Tensor:
        if x.device.type == "cpu":
            y = torch.from_numpy(native.powf(x.detach().contiguous().numpy(), e))
        else:
            y = torch.pow(x.detach(), e)
        ctx.save_for_backward(x)
        ctx.e = e
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (x,) = ctx.saved_tensors
        return grad * ctx.e * torch.pow(x, ctx.e - 1.0), None


def powf(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e: on the CPU glibc's powf, as jnp.power(x, e) rounds it; on a
    CUDA tensor PyTorch's f32 pow."""
    return _Pow.apply(x.to(torch.float32), float(e))
