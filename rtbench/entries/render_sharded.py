"""Drives `gpu_ray_tracing_tpu_torch.parallel.sharding.render_sharded`: one
frame a call on every rank, its rows in bands over the mesh's 'x' axis,
gathered to every rank; the frame ends when the gathered frame is
synchronised on the rank.  The process group is the harness's; the mesh is
the traffic's `mesh` (rows, spp shards) over it.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.parallel import mesh as mesh_mod
from gpu_ray_tracing_tpu_torch.parallel import sharding
from rtbench.entries.render import camera_settings, program_scene, render_config


@dataclasses.dataclass
class Program:
    scene: object
    camera: object
    config: object
    mesh: object
    row_partition: str

    def frame(self, frame_seed: int) -> torch.Tensor:
        return sharding.render_sharded(self.scene, self.camera, self.config, self.mesh,
                                       frame_seed=frame_seed,
                                       row_partition=self.row_partition)

    def rays_traced(self, frame_seed: int) -> float:
        """The whole frame's rays on this rank's card (the kernels' counters)."""
        return api.count_traced_rays(self.scene, self.camera, self.config,
                                     frame_seed=frame_seed)["rays_traced"]


def setup(cell, data, device, mesh=None) -> Program:
    rows, spp_shards = cell.traffic["mesh"]
    dm = mesh_mod.make_mesh(rows, spp_shards, device_type=device.type)
    return Program(program_scene(data, device), camera_settings(data, device),
                   render_config(cell), dm, cell.traffic.get("row_partition", "contiguous"))
