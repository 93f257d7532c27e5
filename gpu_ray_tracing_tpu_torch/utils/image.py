"""Image output: tonemapping and PNG/PPM writers (port of
gpu_ray_tracing_tpu/utils/image.py, numpy only and byte-equal to it).

The reference displays its linear accumulation texture directly (no tone
mapping, no gamma); an offline renderer needs files.  `tonemap` applies
the gamma encode and the writers emit PNG (through PIL when present) or
portable PPM (no dependencies).  Every function takes a numpy array or a
torch tensor on any device; a tensor is moved to host numpy once.
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A torch tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tonemap(linear_rgb, gamma: float = 2.2) -> np.ndarray:
    """Linear HDR RGB -> clipped gamma-encoded [0, 1] f32.  Non-finite
    pixels are refused: a diverged render would otherwise encode as
    plausible-looking garbage (np.clip keeps NaN, and its uint8 cast is
    undefined)."""
    arr = np.asarray(to_host(linear_rgb), np.float32)
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        raise ValueError(
            f"tonemap input contains {bad} non-finite values — the render "
            "diverged; refusing to encode garbage pixels"
        )
    return np.clip(arr, 0.0, 1.0) ** (1.0 / gamma)


def to_uint8(rgb01) -> np.ndarray:
    return (np.clip(to_host(rgb01), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, linear_rgb, gamma: float = 2.2) -> None:
    """Binary PPM (P6) writer; zero dependencies."""
    img = to_uint8(tonemap(linear_rgb, gamma))
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary 8-bit PPM back as uint8 (H, W, 3).  Parses the
    spec's token header (whitespace-separated magic, width, height and
    maxval, with # comments); 16-bit files and truncated payloads are
    refused rather than misread."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, i = [], 0
    while len(tokens) < 4 and i < len(data):
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    i += 1  # the single whitespace byte between maxval and the payload
    if len(tokens) < 4 or tokens[0] != b"P6":
        raise ValueError(f"not a binary PPM: {path}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"unsupported PPM maxval {maxval} (only 8-bit): {path}")
    payload = data[i : i + w * h * 3]
    if len(payload) < w * h * 3:
        raise ValueError(f"truncated PPM payload in {path}")
    # A copy: frombuffer over bytes is read-only.
    return np.frombuffer(payload, np.uint8).reshape(h, w, 3).copy()


def write_image(path: str, linear_rgb, gamma: float = 2.2) -> str:
    """Write PNG when the path ends in .png and PIL is present, else PPM.
    Returns the path written (a .ppm beside the .png without PIL)."""
    if path.lower().endswith(".png"):
        try:
            from PIL import Image
        except ImportError:
            fallback = path[:-4] + ".ppm"
            write_ppm(fallback, linear_rgb, gamma)
            return fallback
        Image.fromarray(to_uint8(tonemap(linear_rgb, gamma))).save(path)
        return path
    write_ppm(path, linear_rgb, gamma)
    return path
