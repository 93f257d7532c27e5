"""Multi-GPU rendering: framebuffer and sample sharding over a device mesh
(port of gpu_ray_tracing_tpu/parallel/sharding.py), over torch.distributed.

  - rows of the framebuffer shard across mesh axis 'x' (pure data
    parallelism: rays are independent, so no halos and no row-axis
    collective until the image is assembled)
  - samples per pixel shard across mesh axis 's'; the ranks' partial sums
    combine with one all_reduce over the axis

Every rank is one process running the same calls with the same arguments
(the collectives keep them in step).  Because the hash stream is keyed on
GLOBAL pixel ids, each rank draws exactly the rays and scatter draws the
whole-frame render would for its rows and samples, and renders them with
the port's own dispatch: backend='cuda' launches the megakernel (and its
adaptive loop for adaptive_tol > 0), 'wavefront' the wavefront engine, on
the rank's card; 'torch' and 'wavefront_torch' their plain versions on the
mesh's device.  A row band is one launch at the band's height with the
frame's y_offset, row_stride and width, so a row-sharded frame equals the
unsharded one bit for bit; a spp shard's samples sum in another order than
one launch's, so spp-sharded frames agree within f32 rounding.  The 'wgsl'
parity stream is keyed on global rows too and shards by contiguous rows;
'threefry' draws follow the frame's shape and are refused here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.models.camera import Camera, CameraSettings
from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.ops.accumulate import AccumState, fold_sample
from gpu_ray_tracing_tpu_torch.parallel.mesh import ROW_AXIS, SPP_AXIS
from gpu_ray_tracing_tpu_torch.utils.config import RenderConfig
from gpu_ray_tracing_tpu_torch.utils.profiling import span


def _check(config: RenderConfig, mesh: DeviceMesh, row_partition: str = "contiguous",
           allow_adaptive: bool = False) -> tuple[int, int]:
    """(rows, spp shards) of the mesh, after the JAX package's refusals."""
    if row_partition not in ("contiguous", "interleaved"):
        raise ValueError(
            f"row_partition={row_partition!r}; expected 'contiguous' or "
            "'interleaved'"
        )
    if row_partition == "interleaved" and config.rng != "hash":
        # The wgsl parity stream's seed derivation has no strided-row form;
        # interleaving exists for load balance, which parity runs don't need.
        raise ValueError("row_partition='interleaved' requires config.rng='hash'")
    if config.rng == "threefry":
        raise ValueError(
            "sharded rendering requires a position-equivariant RNG; use "
            "config.rng='hash' (default) or 'wgsl', not 'threefry'"
        )
    shape = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    if config.adaptive_tol > 0.0:
        # Row shards own disjoint pixels, so adaptive per-tile sample counts
        # compose with row sharding (render_sharded runs the megakernel's
        # one-shot adaptive loop per shard).  The spp-axis sum weights every
        # shard's batch by an equal sample count, and the fold-based
        # progressive step needs exact per-sample counts: both refused.
        if not allow_adaptive:
            raise ValueError(
                "adaptive_tol > 0 does not compose with the fold-based "
                "sharded progressive step; use render_sharded (row-sharded "
                "one-shot adaptive) or the unsharded "
                "adaptive_progressive_step"
            )
        if shape.get(SPP_AXIS, 1) != 1:
            raise ValueError(
                "adaptive_tol > 0 shards over ROWS only (disjoint pixels); "
                "the spp-axis sum assumes equal per-shard sample counts — "
                f"got spp axis of size {shape.get(SPP_AXIS)}"
            )
        if config.rng != "hash":
            raise ValueError(
                "sharded adaptive rendering is an in-kernel megakernel mode "
                "and requires config.rng='hash'"
            )
    missing = [a for a in (ROW_AXIS, SPP_AXIS) if a not in shape]
    if missing:
        raise ValueError(
            f"mesh is missing axis(es) {missing}: sharded rendering needs a "
            f"('{ROW_AXIS}', '{SPP_AXIS}') mesh (size-1 axes are fine — use "
            f"parallel.mesh.make_mesh); got axes {tuple(shape)}"
        )
    n_rows, n_spp = shape[ROW_AXIS], shape[SPP_AXIS]
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by mesh rows {n_rows}")
    if config.spp % n_spp != 0:
        raise ValueError(f"spp {config.spp} not divisible by mesh spp axis {n_spp}")
    return n_rows, n_spp


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _rank_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device: its current card on a "cuda" mesh (make_mesh
    chose it), the CPU on a "cpu" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _f32(x: int) -> torch.Tensor:
    """A divisor as an f32 tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, an ulp off the CPU's quotient."""
    return torch.tensor(float(x), dtype=torch.float32)


def _partition_params(row_partition: str, xi: int, local_h: int,
                      n_rows: int) -> tuple[int, int]:
    """Shard xi's (y_offset, row_stride) for its chosen row partition."""
    if row_partition == "interleaved":
        return xi, n_rows
    return xi * local_h, 1


def _local_sample(sc, camera: Camera, config: RenderConfig, *, sample_index: int, spp: int,
                  frame_seed: int, y0: int, local_h: int, row_stride: int = 1,
                  adaptive: bool = False, **extra):
    """The rank's band of the global frame over samples sample_index ..
    sample_index + spp - 1, in one call of the config's backend: local row
    r is global row y0 + r * row_stride (stride 1 = a contiguous band,
    stride n_rows = the interleaved partition)."""
    band = dict(y_offset=y0, row_stride=row_stride, **extra)
    if config.backend in ("wavefront", "wavefront_torch") and config.integrator == "path":
        band["total_width"] = config.width
    return api._render(sc, camera, dataclasses.replace(config, height=local_h),
                       frame_seed=frame_seed, sample_index=sample_index, spp=spp,
                       adaptive=adaptive, **band)


def _gather_rows(band: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The bands of every row shard stacked in shard order (all_gather
    over 'x'); every rank gets the whole array."""
    group = mesh.get_group(ROW_AXIS)
    band = band.contiguous()
    bands = [torch.empty_like(band) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bands, band, group=group)
    return torch.cat(bands, dim=0)


def deinterleave_rows(img: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Undo the interleaved partition's shard-major row order.

    With row_partition='interleaved', shard xi computes global rows {xi,
    xi + n, xi + 2n, ...}; the gathered bands therefore hold image row
    (r*n + xi) at array row (xi*local_h + r).  This transpose restores
    image order.  render_sharded applies it once a frame, and sharded
    progressive state stays in partition order until `accum_image`."""
    h = img.shape[0]
    local_h = h // n_rows
    return (img.reshape(n_rows, local_h, *img.shape[1:])
            .transpose(0, 1).reshape(img.shape))


def accum_image(state: AccumState, mesh: DeviceMesh,
                row_partition: str = "contiguous") -> torch.Tensor:
    """The accumulated image in IMAGE row order: the rank bands of a
    sharded progressive state gathered over 'x' (every rank gets the whole
    (H, W, 3) image), de-interleaved for the interleaved partition."""
    img = _gather_rows(state.rgb, mesh)
    if row_partition == "interleaved":
        return deinterleave_rows(img, _axis_size(mesh, ROW_AXIS))
    return img


def render_sharded(
    spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    mesh: DeviceMesh,
    *,
    frame_seed=None,
    row_partition: str = "contiguous",
) -> torch.Tensor:
    """Render one frame with rows sharded over mesh axis 'x' and spp over 's'.

    `spheres` is a Spheres or a Scene (the JAX package's argument name).
    Every rank calls it with the same arguments and returns the whole
    (height, width, 3) image in image row order on its device: the
    counterpart of JAX's global array sharded over 'x'.  Each rank renders
    its band for its samples in one launch; the spp shards sum spp_local x
    their band's mean with one all_reduce over 's' and divide by
    config.spp (no arithmetic at all when the axis has one shard), then
    the bands gather over 'x'.  A row-sharded frame equals the unsharded
    render() bit for bit; with spp shards the same samples are summed in
    another order (rtol 1e-5).

    row_partition:
      - 'contiguous' (default): shard xi renders band [xi*H/n, (xi+1)*H/n).
      - 'interleaved': shard xi renders rows {xi, xi+n, ...}, the
        load-balanced partition (contiguous bands of a real scene differ
        severalfold in cost: sky rows against scene rows); the price is
        one row de-interleave of the gathered image.  The RNG is keyed on
        global pixel ids, so the estimator is unchanged.

    Adaptive sampling (config.adaptive_tol > 0) composes with ROW sharding:
    each shard runs the megakernel's adaptive loop on its own rows (the spp
    axis must have size 1).  When the shard bands align with the unsharded
    frame's tiles the image and the per-tile counts match the unsharded
    adaptive render; interleaved bands evaluate tile statistics over
    strided rows and may allocate samples differently (every pixel still
    gets >= adaptive_min_spp samples of the same stream).
    """
    with span("sharded.band"):
        camera = api._camera(camera, config)
        n_rows, n_spp = _check(config, mesh, row_partition, allow_adaptive=True)
        local_h, spp_local = config.height // n_rows, config.spp // n_spp
        xi, si = mesh.get_local_rank(ROW_AXIS), mesh.get_local_rank(SPP_AXIS)
        y0, stride = _partition_params(row_partition, xi, local_h, n_rows)
        dev = _rank_device(mesh)
        sc, camera = as_scene(spheres).to(dev), camera.to(dev)
        seed = api._seed(frame_seed)
        if config.adaptive_tol > 0.0:
            band = _local_sample(sc, camera, config, sample_index=0, spp=config.spp,
                                 frame_seed=seed, y0=y0, local_h=local_h, row_stride=stride,
                                 adaptive=True)
        else:
            band = _local_sample(sc, camera, config, sample_index=si * spp_local,
                                 spp=spp_local, frame_seed=seed, y0=y0, local_h=local_h,
                                 row_stride=stride)
    with span("sharded.gather"):
        if n_spp > 1:
            total = band * float(spp_local)
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.get_group(SPP_AXIS))
            band = total / _f32(config.spp).to(dev)
        img = _gather_rows(band, mesh)
        if row_partition == "interleaved":
            img = deinterleave_rows(img, n_rows)
    return img


def progressive_step_sharded(
    state: AccumState,
    spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    mesh: DeviceMesh,
    *,
    frame_seed=None,
    reset: bool = False,
    row_partition: str = "contiguous",
) -> AccumState:
    """Sharded progressive accumulation step (one spp-axis batch per call).

    `state` is the rank's own: its band, (height / rows, width, 3) on its
    device, in partition order, and the global count (shard_accum_state
    cuts it from a whole state).  Each rank renders sample count + si of
    its band; with an 's' axis of k shards the k fresh samples sum with one
    all_reduce and their mean folds with weight k (ops/accumulate
    .fold_sample), so convergence takes spp / k steps.  Reset clears the
    state before the sample index is derived.  With
    row_partition='interleaved' the bands stay in partition order; call
    `accum_image(state, mesh, 'interleaved')` once at the end."""
    camera = api._camera(camera, config)
    n_rows, n_spp = _check(config, mesh, row_partition)
    local_h = config.height // n_rows
    if tuple(state.rgb.shape) != (local_h, config.width, 3):
        raise ValueError(
            f"state.rgb has shape {tuple(state.rgb.shape)}; a rank's band is "
            f"{(local_h, config.width, 3)} (shard_accum_state cuts it)"
        )
    xi, si = mesh.get_local_rank(ROW_AXIS), mesh.get_local_rank(SPP_AXIS)
    y0, stride = _partition_params(row_partition, xi, local_h, n_rows)
    dev = _rank_device(mesh)
    count = 0 if bool(reset) else int(state.count)
    if count >= config.spp:
        return state
    sample = _local_sample(as_scene(spheres).to(dev), camera.to(dev), config,
                           sample_index=count + si, spp=1, frame_seed=api._seed(frame_seed),
                           y0=y0, local_h=local_h, row_stride=stride)
    if n_spp > 1:
        dist.all_reduce(sample, op=dist.ReduceOp.SUM, group=mesh.get_group(SPP_AXIS))
        sample = sample / _f32(n_spp).to(dev)
    return fold_sample(state, sample, config.spp, reset, num_samples=n_spp)


def shard_accum_state(state: AccumState, mesh: DeviceMesh) -> AccumState:
    """The rank's share of a whole accumulation state: rows [xi*local_h,
    (xi+1)*local_h) on the rank's device (where JAX's device_put with
    P('x') places them) and the count."""
    local_h = state.rgb.shape[0] // _axis_size(mesh, ROW_AXIS)
    xi = mesh.get_local_rank(ROW_AXIS)
    rgb = state.rgb[xi * local_h:(xi + 1) * local_h].to(_rank_device(mesh)).clone()
    return AccumState(rgb=rgb, count=state.count.clone())
