"""Terminal presentation: 24-bit ANSI half-block frames (port of
gpu_ray_tracing_tpu/utils/ansi.py, numpy only and byte-equal to it).

The reference presents its accumulation in a window every frame; the
`view` command presents it in the terminal instead, repainting the image
in place as truecolor half-block cells ('▀' with the top image row as the
foreground and the bottom row as the background).  Images may be numpy
arrays or torch tensors on any device.
"""

from __future__ import annotations

import numpy as np

from gpu_ray_tracing_tpu_torch.utils.image import to_host

RESET = "\x1b[0m"
CURSOR_HOME = "\x1b[H"
CLEAR_SCREEN = "\x1b[2J"
HIDE_CURSOR = "\x1b[?25l"
SHOW_CURSOR = "\x1b[?25h"


def downsample_mean(img, out_h: int, out_w: int) -> np.ndarray:
    """Box-mean an (H, W, C) image to (out_h, out_w, C) over the integer
    bins of a uniform partition (np.add.reduceat); equal sizes pass
    through."""
    img = np.asarray(to_host(img), np.float32)
    h, w = img.shape[:2]
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size must be positive, got {out_h}x{out_w}")
    if out_h > h or out_w > w:
        raise ValueError(f"downsample only: image is {h}x{w}, requested {out_h}x{out_w}")
    if (h, w) == (out_h, out_w):
        return img
    ye = (np.arange(out_h) * h) // out_h
    xe = (np.arange(out_w) * w) // out_w
    sums = np.add.reduceat(np.add.reduceat(img, ye, axis=0), xe, axis=1)
    ny = np.diff(np.append(ye, h)).astype(np.float32)
    nx = np.diff(np.append(xe, w)).astype(np.float32)
    return sums / (ny[:, None, None] * nx[None, :, None])


def tonemap_u8(img, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance -> display u8 with the command line's gamma;
    non-finite pixels render black instead of poisoning the frame."""
    img = np.asarray(to_host(img), np.float32)
    img = np.where(np.isfinite(img), img, 0.0)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / max(gamma, 1e-6))
    return (img * 255.0 + 0.5).astype(np.uint8)


def image_to_ansi(img, cols: int, gamma: float = 2.2) -> str:
    """An (H, W, 3) linear image as `cols`-wide truecolor half-block text:
    rows/2 lines of '▀' cells, two pixel rows a cell.  The aspect holds
    for ~2:1 terminal cells, which the half-blocks cancel."""
    img = to_host(img)
    h, w = img.shape[:2]
    cols = max(2, min(cols, w))
    rows = max(2, min(int(round(cols * (h / w))), h))
    rows -= rows % 2  # half-blocks take rows in pairs
    small = tonemap_u8(downsample_mean(img, rows, cols), gamma)
    lines = []
    for ti, bi in zip(small[0::2], small[1::2]):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(ti, bi)
        ]
        lines.append("".join(cells) + RESET)
    return "\n".join(lines)
