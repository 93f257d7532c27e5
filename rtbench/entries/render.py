"""Drives `gpu_ray_tracing_tpu_torch.api.render`: one synchronised call a
frame, on one card, with the traffic's backend and spp.

`setup` builds the program's scene on the device once, from the
benchmark's plain scene data, as a deployment holds it; no frame copies it
from the host.  The camera goes in as CameraSettings, so every call
derives it, as a viewer's would.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.models.camera import CameraSettings
from gpu_ray_tracing_tpu_torch.models.mesh import make_mesh, merge_meshes
from gpu_ray_tracing_tpu_torch.models.scene import make_scene
from gpu_ray_tracing_tpu_torch.models.spheres import Spheres
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig


def program_scene(data, device):
    """The program's Scene from SceneData: its own mesh, light list and BVH
    (make_scene), then moved to `device`."""
    t = lambda a: torch.as_tensor(a)
    spheres = Spheres(centers=t(data.centers), radii=t(data.radii), albedo=t(data.albedo),
                      mat_kind=t(data.kind), mat_param=t(data.param))
    mesh = None
    if data.mesh:
        mesh = merge_meshes(*(make_mesh(g.vertices, g.faces, albedo=g.albedo, mat_kind=g.kind,
                                        mat_param=g.param, smooth=g.smooth)
                              for g in data.mesh))
    return make_scene(spheres, mesh).to(device)


def render_config(cell, height: int | None = None) -> RenderConfig:
    c, tr = cell.config, cell.traffic
    integ = c["integrator"]
    return RenderConfig(
        width=c["width"], height=c["height"] if height is None else height, spp=tr["spp"],
        max_depth=c["max_depth"], backend=tr["backend"], nee=integ["nee"], mis=integ["mis"],
        russian_roulette_depth=integ["russian_roulette_depth"],
        sky_intensity=integ["sky_intensity"], regenerate=tr.get("regenerate", "off"))


def camera_settings(data, device) -> CameraSettings:
    cam = data.camera
    return CameraSettings.make(cam["look_from"], cam["look_at"], cam["vup"], cam["fov"],
                               cam["defocus"], cam["focus"], device=device)


@dataclasses.dataclass
class Program:
    """The system under test for one cell: `frame(seed)` is the timed call."""

    scene: object
    camera: CameraSettings
    config: RenderConfig

    def frame(self, frame_seed: int) -> torch.Tensor:
        return api.render(self.scene, self.camera, self.config, frame_seed=frame_seed)

    def rays_traced(self, frame_seed: int) -> float:
        """The rays the frame traces, by the kernels' own counters."""
        return api.count_traced_rays(self.scene, self.camera, self.config,
                                     frame_seed=frame_seed)["rays_traced"]


def setup(cell, data, device, mesh=None) -> Program:  # noqa: ARG001 - one card
    return Program(program_scene(data, device), camera_settings(data, device),
                   render_config(cell))
