"""The (row, spp) device mesh (port of gpu_ray_tracing_tpu/parallel/mesh.py).

Pixel and sample parallelism across ranks is the framework's scaling model:

  - axis 'x': framebuffer rows (data parallel over pixels; no halos, rays
    never interact)
  - axis 's': samples-per-pixel batches, combined by one sum over the axis

A mesh is a torch.distributed DeviceMesh of shape (rows, spp) with
mesh_dim_names ('x', 's'), PyTorch's counterpart of a named JAX Mesh.  Rank
r sits at (r // spp, r % spp), JAX's row-major reshape of its device list.
Each rank is one process: launch them with `torchrun --nproc-per-node N`
(which sets RANK, LOCAL_RANK, WORLD_SIZE and the rendezvous address), or
start the process group yourself before calling make_mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

ROW_AXIS = "x"
SPP_AXIS = "s"


def make_mesh(num_row_shards: int | None = None, num_spp_shards: int = 1, *,
              device_type: str = "cuda") -> DeviceMesh:
    """Build the (row, spp) mesh over every rank of the process group.

    Defaults to all ranks on the row axis.  Unlike JAX's automatic device
    pool, a process group cannot leave ranks idle, so the mesh must cover
    the world exactly.  On "cuda" (the default) each rank's device is
    cuda:(LOCAL_RANK or rank) % device_count(), so that several ranks may
    share one card, and no card raises; nothing falls back to the CPU.
    When no process group is running, one is started from the environment
    (torchrun's): nccl on "cuda", gloo on "cpu".  Which backend carries the
    collectives is otherwise the caller's choice (gloo takes CUDA tensors
    too, and unlike nccl lets two ranks share a card).
    """
    if num_spp_shards < 1:
        raise ValueError(f"num_spp_shards must be >= 1, got {num_spp_shards}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs an NVIDIA GPU and none is "
            "visible; pass device_type='cpu' for a mesh of CPU ranks"
        )
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    if num_row_shards is None:
        num_row_shards = world // num_spp_shards
    if num_row_shards < 1:
        raise ValueError(
            f"mesh would have {num_row_shards} row shards ({world} ranks / "
            f"{num_spp_shards} spp shards) — a zero-rank mesh fails later with "
            "an opaque collective error"
        )
    n = num_row_shards * num_spp_shards
    if n > world:
        raise ValueError(
            f"mesh {num_row_shards}x{num_spp_shards} needs {n} ranks, have {world}"
        )
    if n != world:
        raise ValueError(
            f"mesh {num_row_shards}x{num_spp_shards} uses {n} ranks but the process "
            f"group has a world size of {world}; a mesh must cover every rank "
            f"(pass sizes whose product is {world})"
        )
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (num_row_shards, num_spp_shards),
                            mesh_dim_names=(ROW_AXIS, SPP_AXIS))
