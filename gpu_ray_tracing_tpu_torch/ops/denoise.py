"""AOV-guided denoiser: the edge-avoiding a-trous wavelet filter (port of
gpu_ray_tracing_tpu/ops/denoise.py).

`iterations` passes of a 5x5 B3-spline kernel whose taps spread by 2^i
(Dammertz et al., HPG 2010), each tap weighted by SVGF-style edge stops
(Schied et al., HPG 2017) on luminance, normals and gradient-normalized
depth, on the albedo-demodulated signal (color / albedo, re-modulated
after).  The reference has no Pallas kernel for it (elementwise arithmetic
and static shifts, which XLA fuses), and neither has the port: plain
PyTorch, `torch.roll` for `jnp.roll` and replicate padding for
`jnp.pad(mode='edge')`, with the same validity masks, guards and argument
checks.  It runs on the device of its inputs and is differentiable.

On a CPU tensor it rounds as jitted XLA:CPU does where the port has the
piece: `ndot ** sigma_normal` is glibc's powf (ops/rounding.powf, what
jnp.power calls) and the normal's norm a correctly rounded sqrt.  jnp.exp
is XLA's own polynomial, so the filter agrees with JAX's to f32 rounding,
not bit for bit (tests/test_torch_denoise.py states the tolerance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpu_ray_tracing_tpu_torch.ops.rounding import powf, sqrt, xla_dot3, xla_fma

# 1D B3-spline; the 5x5 kernel is its outer product (Dammertz et al. eq. 1).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)

_LUMA = (0.2126, 0.7152, 0.0722)


def _luminance(rgb: torch.Tensor) -> torch.Tensor:
    # As jitted XLA:CPU contracts it on the CPU: fma(b, B, fma(r, R, g G)).
    k = [torch.tensor(v, dtype=torch.float32, device=rgb.device) for v in _LUMA]
    return xla_fma(k[2], rgb[..., 2], xla_fma(k[0], rgb[..., 0], k[1] * rgb[..., 1]))


def _shifted(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Value at pixel p + (dy, dx), positionally aligned with p.  roll
    wraps; the validity mask kills out-of-frame taps."""
    return torch.roll(x, (-dy, -dx), dims=(0, 1))


def _valid_mask(h: int, w: int, dy: int, dx: int, device) -> torch.Tensor:
    rows = torch.arange(h, device=device) + dy
    cols = torch.arange(w, device=device) + dx
    ok_r = (rows >= 0) & (rows < h)
    ok_c = (cols >= 0) & (cols < w)
    return (ok_r[:, None] & ok_c[None, :]).to(torch.float32)


def atrous_denoise(
    color: torch.Tensor,
    *,
    albedo: torch.Tensor | None = None,
    normal: torch.Tensor | None = None,
    depth: torch.Tensor | None = None,
    iterations: int = 4,
    sigma_color: float = 0.45,
    sigma_normal: float = 64.0,
    sigma_depth: float = 2.0,
    demodulate: bool = True,
    eps: float = 1e-4,
) -> torch.Tensor:
    """Denoise a linear-RGB (H, W, 3) render using optional AOV guides.

    color: the noisy beauty pass; albedo: the first-hit albedo AOV (H, W,
    3), which demodulates texture out of the filtered signal
    (`demodulate=True`); normal: decoded shading normals (H, W, 3); depth:
    first-hit distance (H, W) (or the depth AOV's (H, W, 3)), 0 on a miss.
    sigma_color scales the luminance edge stop, sigma_normal is the
    exponent on max(0, n_p . n_q), sigma_depth scales the depth stop
    exp(-|z_p - z_q| / (sigma_depth |grad z . (q - p)| + 1e-2 z_p + eps)).
    Each guide is optional: with none it is the plain color-stopping
    a-trous filter, with iterations=0 the identity.  See the JAX
    package's atrous_denoise for the derivation of each term.
    """
    if color.dim() != 3 or color.shape[-1] != 3:
        raise ValueError(f"color must be (H, W, 3), got {tuple(color.shape)}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    if sigma_color <= 0.0:
        raise ValueError(f"sigma_color must be > 0, got {sigma_color}")
    if sigma_depth <= 0.0:
        raise ValueError(f"sigma_depth must be > 0, got {sigma_depth}")
    if sigma_normal < 0.0:
        raise ValueError(f"sigma_normal must be >= 0, got {sigma_normal}")
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    color = color.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)

    if albedo is not None and demodulate:
        alb = torch.clamp(albedo.to(torch.float32), min=eps)
        signal = color / alb
    else:
        alb = None
        signal = color

    if depth is not None:
        z = depth.to(torch.float32)
        if z.dim() == 3:  # the depth AOV carries the distance in 3 channels
            z = z[..., 0]
        # Screen-space depth gradient (central differences, edge-replicated).
        zp = F.pad(z[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        dzdy = 0.5 * (zp[2:, 1:-1] - zp[:-2, 1:-1])
        dzdx = 0.5 * (zp[1:-1, 2:] - zp[1:-1, :-2])
    else:
        z = None
    if normal is not None:
        n = normal.to(torch.float32)
        # sqrt rather than vector_norm: at a zero normal its gradient is
        # NaN, as jnp.linalg.norm's is (vector_norm's is finite).
        norm = sqrt(xla_dot3(n, n))[..., None]
        n = n / torch.clamp(norm, min=1e-8)
    else:
        n = None

    for it in range(iterations):
        step = 1 << it
        lum = _luminance(signal)
        num = torch.zeros_like(signal)
        den = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                s_q = _shifted(signal, dy, dx)
                wgt = f32(_B3[ky] * _B3[kx]) * _valid_mask(h, w, dy, dx, dev)
                # Luminance stop on the current (partially filtered) signal.
                l_q = _shifted(lum, dy, dx)
                wgt = wgt * torch.exp(-torch.abs(lum - l_q) / f32(sigma_color))
                if n is not None:
                    n_q = _shifted(n, dy, dx)
                    ndot = torch.clamp(xla_dot3(n, n_q), min=0.0)
                    wgt = wgt * powf(ndot, sigma_normal)
                if z is not None:
                    z_q = _shifted(z, dy, dx)
                    predicted = torch.abs(xla_fma(dzdx, f32(dx), dzdy * dy))
                    rel = torch.abs(z - z_q) / (
                        xla_fma(f32(1e-2), z, f32(sigma_depth) * predicted) + f32(eps))
                    wgt = wgt * torch.exp(-rel)
                num = xla_fma(wgt[..., None], s_q, num)
                den = den + wgt
        # A zero center normal kills every tap: such pixels keep their
        # value instead of producing 0/0.
        dead = den <= 1e-12
        signal = torch.where(dead[..., None], signal,
                             num / torch.clamp(den, min=1e-12)[..., None])

    if alb is not None:
        signal = signal * alb
    return signal


def decode_normal_aov(aov: torch.Tensor) -> torch.Tensor:
    """Invert the normal integrator's 0.5 (n + 1) encoding.  Miss pixels
    hold the sky and decode to garbage directions; the depth guide (0 on a
    miss) isolates them."""
    return 2.0 * aov - 1.0
