"""Render configuration (port of gpu_ray_tracing_tpu/utils/config.py).

The same frozen dataclass with the same fields and cross-field checks.  The
backends are the port's own: 'cuda', the default, is the hand-written
megakernel (the counterpart of 'pallas'), so an entry point given nothing
else renders on the card and raises without one; 'wavefront' is the
wavefront engine on the card (one kernel launch per bounce over compacted
rays; it raises without a card too); 'torch' is how a caller asks for the
plain PyTorch integrator (the counterpart of 'jax') and 'wavefront_torch'
for the wavefront engine's plain version, which run on the device the scene
lies on.  NEE/MIS and the stratified and Sobol samplers run on all four;
adaptive sampling is a megakernel mode and ray regeneration a wavefront
mode, as in the JAX package.  The WGSL parity stream (rng='wgsl') runs
through 'torch' only: the kernels draw the hash stream, as the JAX
package's do.  The one mode the port does not carry yet, the threefry
stream, raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from gpu_ray_tracing_tpu_torch.ops.rng import sobol_nbits, strata_shape

_BACKENDS = ("torch", "cuda", "wavefront", "wavefront_torch")
_WAVEFRONT = ("wavefront", "wavefront_torch")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable).

    Defaults mirror the reference: 1280x720 window (lib.rs:24-25), 30-bounce
    depth (camera.rs:34), the (0.001, 3.4e35) hit interval
    (compute_shader.wgsl:266).  See the JAX package's RenderConfig for the
    meaning of every field; only the backend names differ.
    """

    width: int = 1280
    height: int = 720
    spp: int = 1
    max_depth: int = 30
    integrator: Literal["path", "normal", "albedo", "depth"] = "path"
    # 'cuda'  = hand-written sm_90a megakernel (ops/cuda/megakernel.cu)
    # 'wavefront' = the wavefront engine's sm_90a kernels (ops/cuda/wavefront.py)
    # 'torch' = plain PyTorch integrator (reference path; runs anywhere)
    # 'wavefront_torch' = the wavefront engine's plain version (runs anywhere)
    backend: Literal["torch", "cuda", "wavefront", "wavefront_torch"] = "cuda"
    rng: Literal["hash", "threefry", "wgsl"] = "hash"
    parity: bool = False
    sky_intensity: float = 1.0
    nee: bool = False
    mis: bool = False
    sampler: Literal["independent", "stratified", "sobol"] = "independent"
    regenerate: Literal["auto", "on", "off"] = "off"
    adaptive_tol: float = 0.0
    adaptive_min_spp: int = 8
    clamp: float = 0.0
    russian_roulette_depth: int = 0
    t_min: float = 1.0e-3
    t_max: float = 3.4e35

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.integrator not in ("path", "normal", "albedo", "depth"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        # The cross-field checks of the JAX RenderConfig, 'pallas' read as
        # 'cuda' and 'wavefront' as either wavefront backend.
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid resolution {self.width}x{self.height}")
        if self.spp <= 0:
            raise ValueError(f"spp must be positive, got {self.spp}")
        if self.max_depth <= 0:
            raise ValueError(f"max_depth must be positive, got {self.max_depth}")
        if self.parity and self.rng != "wgsl":
            raise ValueError("parity=True requires rng='wgsl'")
        if self.backend in ("cuda", *_WAVEFRONT) and self.rng != "hash":
            raise ValueError(f"backend={self.backend!r} requires rng='hash'")
        if self.sampler != "independent" and self.rng != "hash":
            raise ValueError(
                f"sampler={self.sampler!r} requires rng='hash' (sample "
                "points are addressed by absolute sample index, which "
                "threefry keys and the wgsl parity chain don't carry)"
            )
        if self.mis and not self.nee:
            raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
        if self.clamp < 0.0:
            raise ValueError(f"clamp must be >= 0, got {self.clamp}")
        if self.clamp > 0.0 and self.integrator != "path":
            raise ValueError(
                f"clamp is a path-integrator knob; integrator="
                f"{self.integrator!r} ignores it"
            )
        if self.clamp > 0.0 and self.regenerate != "off":
            raise ValueError(
                "clamp > 0 is refused with ray regeneration, as the reference's "
                "RenderConfig refuses it (the JAX package clamps only sample-major "
                "renders); set regenerate='off' to clamp"
            )
        if self.adaptive_tol < 0.0:
            raise ValueError(f"adaptive_tol must be >= 0, got {self.adaptive_tol}")
        if self.adaptive_tol > 0.0 and self.backend != "cuda":
            raise ValueError(
                f"adaptive_tol={self.adaptive_tol} is a megakernel mode; "
                f"backend={self.backend!r} ignores it — set backend='cuda' "
                "or adaptive_tol=0"
            )
        if self.adaptive_tol > 0.0 and self.adaptive_min_spp < 2:
            raise ValueError(
                f"adaptive_min_spp must be >= 2, got {self.adaptive_min_spp}"
            )
        if self.regenerate not in ("auto", "on", "off"):
            raise ValueError(f"unknown regenerate mode {self.regenerate!r}")
        if self.regenerate != "off" and self.backend not in _WAVEFRONT:
            # Silently ignoring the request would time the wrong engine.
            raise ValueError(
                f"regenerate={self.regenerate!r} is a wavefront-engine mode; "
                f"backend={self.backend!r} ignores it — set "
                "backend='wavefront' or regenerate='off'"
            )
        # The mode the port does not carry yet.
        if self.rng == "threefry":
            raise NotImplementedError(
                "rng='threefry' is not ported yet (ROADMAP Queue 1 item 2, "
                "rng='threefry'); use the counter-based 'hash' stream or 'wgsl'"
            )

    @property
    def sampler_spec(self) -> tuple | None:
        """The spec ops/rng.sampler_uniforms takes: None for the independent
        sampler, ('stratified', kx, ky) or ('sobol', nbits), derived from the
        spp budget."""
        if self.sampler == "stratified":
            return ("stratified", *strata_shape(self.spp))
        if self.sampler == "sobol":
            return ("sobol", sobol_nbits(self.spp))
        return None

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


#: Reference defaults: 1280x720 window (lib.rs:24-25), 500-spp target
#: (camera.rs:33), 30-bounce depth (camera.rs:34).
REFERENCE_CONFIG = RenderConfig(
    width=1280, height=720, spp=500, max_depth=30, integrator="path"
)
