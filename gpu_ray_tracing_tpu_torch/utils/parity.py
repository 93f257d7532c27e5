"""The decision-flip image metric (tests/test_sharding.py::assert_images_match).

Two images drawn from the same RNG stream agree everywhere except where
rounding flips a borderline hit or scatter decision.  A pixel "flips" when
its largest channel difference exceeds 1e-3; two images match when the
flipped share is at most `flip_frac` and the mean |difference| is below
`mean_tol`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ImageMatch(NamedTuple):
    ok: bool
    flip_frac: float
    mean_abs: float
    max_abs: float


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def images_match(a, b, flip_frac: float = 0.01, mean_tol: float = 1e-4) -> ImageMatch:
    """Compare two (H, W, 3) images by the decision-flip contract."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape or a.size == 0:
        raise ValueError(f"images differ in shape: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    d = diff.max(axis=-1)
    frac = float((d > 1e-3).sum()) / d.size
    mean = float(diff.mean())
    return ImageMatch(frac <= flip_frac and mean < mean_tol, frac, mean,
                      float(diff.max()))
