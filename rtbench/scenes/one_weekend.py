"""The One-Weekend final scene (Sur091/GPU-Ray-Tracing sphere.rs:45-153;
Shirley, Ray Tracing in One Weekend): a grey ground sphere, a grid of
r = 0.2 spheres with random materials, and three hero spheres.

The reference program draws a new layout each launch; here the layout is
drawn from params["layout_seed"] with NumPy's PCG64, so every run of a
configuration renders the same spheres (layouts differ in their work by
up to 8% a frame on the card, which would make the run's seed change the
work measured).  The distribution is
sphere.rs's: 80% lambertian (albedo the product of two uniform draws), 15%
metal (albedo in [0.5, 1), fuzz in [0, 0.5)), 5% glass (ior 1.5), a sphere
at (a + 0.9 u, 0.2, b + 0.9 u') in each grid cell, none within 0.9 of
(4, 0.2, 0).
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import DIELECTRIC, LAMBERTIAN, METAL, SceneData, spheres_from_entries


def make(params: dict, seed: int) -> SceneData:  # noqa: ARG001 - the layout is fixed
    lo, hi = int(params.get("grid_min", -7)), int(params.get("grid_max", 7))
    rng = np.random.default_rng(int(params["layout_seed"]))
    entries = [((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]
    for a in range(lo, hi):
        for b in range(lo, hi):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()],
                              np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                entries.append((tuple(center), 0.2, LAMBERTIAN, tuple(albedo), 0.0))
            elif choose < 0.95:
                albedo = 0.5 * (1.0 + rng.random(3))
                entries.append((tuple(center), 0.2, METAL, tuple(albedo),
                                float(0.5 * rng.random())))
            else:
                entries.append((tuple(center), 0.2, DIELECTRIC, (1.0, 1.0, 1.0), 1.5))
    entries += [
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1), 0.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ]
    return spheres_from_entries(entries, camera=dict(params["camera"]))
