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
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32, rounded once (broadcasting)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over a last axis of 3 (broadcasting), as the chain of
    fused multiply-adds XLA:CPU emits for a 3-term dot or sum."""
    t = a[..., 0] * b[..., 0]
    t = fma(a[..., 1], b[..., 1], t)
    return fma(a[..., 2], b[..., 2], t)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over a last axis of 3, each component rounded as
    XLA:CPU rounds a*b - c*d: fma(a, b, -(c*d))."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], dim=-1)
