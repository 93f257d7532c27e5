"""Integrators (port of gpu_ray_tracing_tpu/ops/integrators.py and the
scene queries of gpu_ray_tracing_tpu/models/scene.py:310-387).

`trace_path` is the reference's ray_color (wgsl:261-297) on the counter
stream: a bounce loop to max_depth with multiplicative throughput, sky on
a miss, emission ending the path, absorbed rays black, optional Russian
roulette, and optional next-event estimation toward sphere lights (cone
sampling) and triangle lights (area sampling) with MIS power-heuristic
weights, and the stratified/Sobol first-bounce remaps.  Every ray runs the
full trip count with a `live` mask, as in the JAX package; dead rays add
nothing.  Three streams draw the randomness: the counter stream
(`pixel_seeds`), the WGSL parity stream (`bounce_seeds`, frame-uniform
draws with the reference's depth-exhaustion sky leak under parity=True)
and the threefry mode's jax.random stream (`generator_key`, ops/rng.py).

Arithmetic follows the JAX package's 'jax' engine.  Where XLA:CPU
contracts a*b+c into one fused multiply-add, the plain version does too
(ops/rounding.py), and the CUDA kernel writes the same fmaf.
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_ray_tracing_tpu_torch.models.scene import as_scene, sphere_light_ids
from gpu_ray_tracing_tpu_torch.models.spheres import EMISSIVE, LAMBERTIAN
from gpu_ray_tracing_tpu_torch.ops import intersect as intersect_ops
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.intersect import (
    Hit,
    intersect_bvh,
    intersect_spheres,
    intersect_triangles,
    nearest_t_spheres,
)
from gpu_ray_tracing_tpu_torch.ops.materials import scatter
from gpu_ray_tracing_tpu_torch.ops.rounding import (
    cos_sin,
    cross,
    dot3,
    fma,
    sqrt,
    xla_dot3,
    xla_fma,
)

_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def sky_color(dirs: torch.Tensor) -> torch.Tensor:
    """Vertical white->blue gradient on the unit direction (wgsl:293-296),
    rounded as jitted XLA:CPU rounds it on the CPU (the norm's squares and
    the blend as fused multiply-adds) and as the kernel does on the card."""
    norm = sqrt(xla_dot3(dirs, dirs))[..., None]
    unit = dirs / torch.clamp(norm, min=1e-20)
    a = 0.5 * (unit[..., 1:2] + 1.0)
    white = torch.tensor(_WHITE, dtype=torch.float32, device=dirs.device)
    blue = torch.tensor(_BLUE, dtype=torch.float32, device=dirs.device)
    return xla_fma(a, blue, (1.0 - a) * white)


def _add_sky(result, throughput, sky, intensity: float):
    """result + throughput * sky * intensity as jitted XLA:CPU rounds it on
    the CPU: one fused multiply-add into the result, after dropping a
    factor of 1."""
    if intensity == 1.0:
        return xla_fma(throughput, sky, result)
    return xla_fma(throughput * sky, torch.tensor(intensity, dtype=torch.float32,
                                                  device=sky.device), result)


def _mesh_hit(origins, dirs, sc, t_min: float, t_max: float) -> Hit:
    if sc.bvh is not None:
        return intersect_bvh(origins, dirs, sc.mesh, sc.bvh, t_min, t_max)
    return intersect_triangles(origins, dirs, sc.mesh, t_min, t_max)


def intersect_scene(origins, dirs, scene, t_min: float, t_max: float, *,
                    want_mesh_wins: bool = False):
    """Closest hit across spheres and mesh: (hit, albedo, kind, param) per
    ray, the material taken from whichever primitive won (the mesh where
    its t is strictly less).  `want_mesh_wins=True` appends the "the mesh
    won" plane, which says whether hit.idx is a face or a sphere index.  A
    sphere BVH is not walked: the spheres, reordered or not, are all
    scanned."""
    sc = as_scene(scene)
    spheres = sc.spheres
    s_hit = intersect_spheres(origins, dirs, spheres, t_min, t_max)
    albedo = spheres.albedo[s_hit.idx]
    kind = spheres.mat_kind[s_hit.idx]
    param = spheres.mat_param[s_hit.idx]
    if sc.mesh is None:
        if want_mesh_wins:
            return s_hit, albedo, kind, param, torch.zeros_like(s_hit.hit)
        return s_hit, albedo, kind, param

    mesh = sc.mesh
    m_hit = _mesh_hit(origins, dirs, sc, t_min, t_max)
    wins = m_hit.hit & (~s_hit.hit | (m_hit.t < s_hit.t))
    w = wins[..., None]
    hit = Hit(
        t=torch.where(wins, m_hit.t, s_hit.t),
        idx=torch.where(wins, m_hit.idx, s_hit.idx),
        hit=s_hit.hit | m_hit.hit,
        point=torch.where(w, m_hit.point, s_hit.point),
        normal=torch.where(w, m_hit.normal, s_hit.normal),
        front_face=torch.where(wins, m_hit.front_face, s_hit.front_face),
    )
    out = (
        hit,
        torch.where(w, mesh.albedo[m_hit.idx], albedo),
        torch.where(wins, mesh.mat_kind[m_hit.idx], kind),
        torch.where(wins, mesh.mat_param[m_hit.idx], param),
    )
    return out + (wins,) if want_mesh_wins else out


def nearest_t_scene(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """Shadow-ray query: the nearest hit t across all geometry (t_max on a
    miss), without building a hit record."""
    sc = as_scene(scene)
    t = nearest_t_spheres(origins, dirs, sc.spheres, t_min, t_max)
    if sc.mesh is None:
        return t
    m_hit = _mesh_hit(origins, dirs, sc, t_min, t_max)
    return torch.minimum(t, torch.where(m_hit.hit, m_hit.t, t_max))


def _shade_hit(mode: str, hit: Hit, albedo, dirs) -> torch.Tensor:
    """One AOV plane of a closest hit: 'normal' 0.5*(n+1) or sky, 'albedo'
    the first-hit albedo or sky, 'depth' the metric distance t * |d| in 3
    equal channels (0 on a miss)."""
    if mode == "normal":
        return torch.where(hit.hit[..., None], 0.5 * (hit.normal + 1.0), sky_color(dirs))
    if mode == "albedo":
        return torch.where(hit.hit[..., None], albedo, sky_color(dirs))
    dist = torch.where(
        hit.hit, hit.t * sqrt(torch.sum(dirs * dirs, dim=-1)), 0.0
    )
    return dist[..., None].expand(*dist.shape, 3)


def shade_normals(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """Normal-shading integrator (BASELINE config 1): 0.5*(n+1) or sky."""
    hit, albedo, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    return _shade_hit("normal", hit, albedo, dirs)


def shade_albedo(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """First-hit albedo AOV, sky color on a miss."""
    hit, albedo, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    return _shade_hit("albedo", hit, albedo, dirs)


def shade_depth(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """First-hit metric distance (t * |d|), 3 equal channels; 0 on a miss."""
    hit, albedo, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    return _shade_hit("depth", hit, albedo, dirs)


GUIDES = ("albedo", "normal", "depth")


def shade_guides(origins, dirs, scene, t_min: float, t_max: float) -> torch.Tensor:
    """The denoiser's three guide planes from one closest hit: (3, ..., 3),
    albedo, normal and depth in that order, each what its shade_* gives."""
    hit, albedo, _, _ = intersect_scene(origins, dirs, scene, t_min, t_max)
    return torch.stack([_shade_hit(m, hit, albedo, dirs) for m in GUIDES])


def clamp_radiance(rgb: torch.Tensor, clamp: float) -> torch.Tensor:
    """Per-sample max-component radiance clamp, hue-preserving."""
    m = torch.amax(rgb, dim=-1, keepdim=True)
    return rgb * torch.clamp(clamp / torch.clamp(m, min=1e-12), max=1.0)


def _one_minus_cos_max(r2, d2):
    """1 - cos(half-angle) of the cone a radius^2-r2 sphere subtends at
    squared distance d2, cancellation-free: (r2/d2) / (1 + sqrt(1 - r2/d2)),
    capped at 1 (inside the sphere every consumer masks the lane).  Jitted
    XLA rewrites (r2 / d2) / (1 + s) as r2 / (d2 (1 + s)), and so does the
    port on the CPU; on the card it divides twice, as the kernel does."""
    q = r2 / d2
    s = 1.0 + sqrt(torch.clamp(1.0 - q, 1e-12, 1.0))
    return torch.clamp(r2 / (d2 * s) if q.device.type == "cpu" else q / s, max=1.0)


_X_AXIS = (1.0, 0.0, 0.0)
_Y_AXIS = (0.0, 1.0, 0.0)


def _sphere_candidate(pnt, normal, lc, lr, u1n, u2n):
    """Cone sample toward a sphere light (centre lc, radius lr, per lane):
    returns (omega, t_l, ok, wgt0), where ok holds the scan-independent
    validity terms and wgt0 = cos_i * 2 (1 - cos_max) is the estimator
    weight and the MIS ratio p_b / p_nee."""
    dc = lc - pnt
    d2 = dot3(dc, dc)
    d2s = torch.clamp(d2, min=1e-12)
    r2 = lr * lr
    inside = d2 <= r2 * 1.0001
    omc = _one_minus_cos_max(r2, d2s)
    cos_t = fma(-u1n, omc, torch.ones_like(omc))
    sin_t = sqrt(torch.clamp(fma(-cos_t, cos_t, torch.ones_like(cos_t)), min=0.0))
    phi = u2n * torch.tensor(2.0 * torch.pi, dtype=torch.float32)
    wl = dc / sqrt(d2s)[..., None]
    pick = torch.abs(wl[..., 0:1]) > 0.9
    a_ax = torch.where(pick, torch.tensor(_Y_AXIS, device=pnt.device),
                       torch.tensor(_X_AXIS, device=pnt.device))
    u_ax = cross(a_ax, wl)
    u_ax = u_ax / torch.clamp(sqrt(dot3(u_ax, u_ax)), min=1e-12)[..., None]
    v_ax = cross(wl, u_ax)
    cos_phi, sin_phi = cos_sin(phi)
    cp = cos_phi * sin_t
    sp = sin_phi * sin_t
    if pnt.device.type == "cpu":
        # As XLA:CPU's fused bounce rounds it (its object code): v sp fused
        # onto the product u cp, and n . omega summed unfused.
        omega = fma(wl, cos_t[..., None], fma(v_ax, sp[..., None], u_ax * cp[..., None]))
        prod = normal * omega
        cos_i = prod[..., 0] + prod[..., 1] + prod[..., 2]
    else:  # the kernel's rounding
        omega = fma(wl, cos_t[..., None], fma(u_ax, cp[..., None], v_ax * sp[..., None]))
        cos_i = dot3(normal, omega)
    h_l = dot3(dc, omega)
    disc_l = fma(h_l, h_l, -fma(-lr, lr, d2))
    t_l = h_l - sqrt(torch.clamp(disc_l, min=0.0))
    ok = (cos_i > 0.0) & ~inside & (disc_l > 0.0)
    return omega, t_l, ok, cos_i * 2.0 * omc


def _tri_candidate(pnt, normal, v0, e1, e2, nl, area, u1n, u2n):
    """Uniform-area sample on a triangle light (per-lane parameters):
    returns (omega, dist, ok, wgt0), wgt0 = cos_i cos_l area / (pi d^2),
    two-sided (|cos_l|)."""
    su = sqrt(u1n)
    b1 = 1.0 - su
    b2 = u2n * su
    p = fma(b2[..., None], e2, fma(b1[..., None], e1, v0))
    dc = p - pnt
    d2 = dot3(dc, dc)
    d2s = torch.clamp(d2, min=1e-12)
    dist = sqrt(d2s)
    omega = dc / dist[..., None]
    cos_i = dot3(normal, omega)
    cos_l = torch.abs(dot3(nl, omega))
    ok = (cos_i > 0.0) & (cos_l > 1e-7) & (d2 > 1e-12)
    wgt0 = cos_i * cos_l * area / (torch.tensor(torch.pi, dtype=torch.float32) * d2s)
    return omega, dist, ok, wgt0


def _mis_nee_weight(wgt, last: bool):
    """The NEE side of the power heuristic, 1 / (1 + r^2) with r = wgt (the
    fully scaled estimator weight); the last bounce keeps weight 1, since
    its BSDF counterpart is never traced."""
    return wgt if last else wgt / fma(wgt, wgt, torch.ones_like(wgt))


@dataclasses.dataclass
class PathState:
    """What a batch of paths carries from bounce to bounce: the rays, their
    throughput and the radiance gathered so far ((..., 3) f32), the `live`
    mask, whether the vertex a ray left ran NEE (`prev_diffuse`) and the
    cosine of its scatter direction there (`prev_cos`, for MIS), the rays
    traced so far (f32; None when not counted), and the constants of the
    stream: each ray's pixel seed and, for the samplers, its pixel id; or,
    on the WGSL stream, the frame-uniform seed of each bounce."""

    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    result: torch.Tensor
    live: torch.Tensor
    prev_diffuse: torch.Tensor
    prev_cos: torch.Tensor
    rays: torch.Tensor | None
    pixel_seeds: torch.Tensor | None
    pixel_ids: torch.Tensor | None = None
    bounce_seeds: torch.Tensor | None = None
    generator_key: tuple[int, int] | None = None


def initial_path_state(origins, dirs, pixel_seeds, pixel_ids=None, *,
                       count_rays: bool = False, bounce_seeds=None,
                       generator_key: tuple[int, int] | None = None) -> PathState:
    """The state of fresh primary rays: unit throughput, no radiance, live."""
    batch_shape, dev = dirs.shape[:-1], dirs.device
    return PathState(
        o=origins, d=dirs,
        throughput=torch.ones((*batch_shape, 3), dtype=torch.float32, device=dev),
        result=torch.zeros((*batch_shape, 3), dtype=torch.float32, device=dev),
        live=torch.ones(batch_shape, dtype=torch.bool, device=dev),
        prev_diffuse=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        prev_cos=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
        rays=(torch.zeros(batch_shape, dtype=torch.float32, device=dev)
              if count_rays else None),
        pixel_seeds=pixel_seeds, pixel_ids=pixel_ids, bounce_seeds=bounce_seeds,
        generator_key=generator_key,
    )


class PathContext:
    """The scene and options of a path trace, checked once: what
    `path_bounce` needs besides the state.  See `trace_path` for the
    meaning of every option."""

    def __init__(self, scene, max_depth: int, t_min: float, t_max: float, *,
                 russian_roulette_depth: int = 0, sky_intensity: float = 1.0,
                 nee: bool = False, mis: bool = False, frame_seed_u32=None,
                 sampler_spec: tuple | None = None, light_pick: str = "lane",
                 count_rays: bool = False, need_ids: bool = False):
        self.sc = sc = as_scene(scene)
        if mis and not nee:
            raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
        self.n_sl, self.n_tl = sc.nee_light_counts(nee)
        self.total = self.n_sl + self.n_tl
        if light_pick not in ("lane", "sample"):
            raise ValueError(f"light_pick must be 'lane' or 'sample', got {light_pick!r}")
        if sampler_spec is not None and need_ids:
            raise ValueError("sampler_spec= needs pixel_ids=, sample_index= and "
                             "frame_seed_u32=")
        self.pick_per_sample = nee and self.total > 4 and light_pick == "sample"
        self.max_depth, self.t_min, self.t_max = max_depth, t_min, t_max
        self.rr_depth = russian_roulette_depth
        self.sky_intensity = sky_intensity
        self.nee, self.mis = nee, mis
        self.frame_seed_u32 = frame_seed_u32
        self.sampler_spec = sampler_spec
        self.count_rays = count_rays
        if mis:
            # Exact light identity of the primitive a ray hits (sphere lights
            # first, then triangle lights).
            self.lid_sphere = sphere_light_ids(sc.spheres)
            if sc.mesh is not None:
                self.lid_tri = sc.global_tri_light_ids().long()


def _either(cond, a, b):
    """`a if cond else b` for a Python bool, a per-ray select for a mask."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond[..., None] if a.dim() > cond.dim() else cond, a, b)
    return a if cond else b


def path_bounce(ctx: PathContext, st: PathState, i, s) -> PathState:
    """One bounce of every path of `st`: the body of `trace_path`'s loop.
    `i` (the bounce) and `s` (the absolute sample index) are Python ints, or
    per-ray integer tensors when the rays of a batch mix them (the
    regenerating wavefront pool); either way each ray draws the same stream.
    On the WGSL stream (`st.bounce_seeds`) every draw of bounce i is one
    frame-uniform value shared by the whole batch, as the reference's
    ray_color draws it (wgsl:268); on the threefry stream
    (`st.generator_key`) bounce i draws from JAX's keys and shapes
    (ops/rng.fold_in, split, uniform).  Dead rays pass through unchanged."""
    sc, dev = ctx.sc, st.d.device
    t_min, t_max, max_depth = ctx.t_min, ctx.t_max, ctx.max_depth
    nee, mis, total, n_sl, n_tl = ctx.nee, ctx.mis, ctx.total, ctx.n_sl, ctx.n_tl
    sampler_spec, frame_seed_u32 = ctx.sampler_spec, ctx.frame_seed_u32
    pixel_seeds, pixel_ids = st.pixel_seeds, st.pixel_ids
    batch_shape = st.d.shape[:-1]
    o, d, throughput, result = st.o, st.d, st.throughput, st.result
    live, prev_diffuse, prev_cos = st.live, st.prev_diffuse, st.prev_cos
    lights, tl = sc.lights, sc.tri_lights
    rays_box = [st.rays]
    per_ray = isinstance(i, torch.Tensor)
    first = i == 0
    wgsl = st.bounce_seeds is not None
    key = st.generator_key
    if (wgsl or key is not None) and per_ray:
        raise ValueError("the WGSL and threefry streams draw a bounce for the whole "
                         "batch; they take no per-ray bounce index")
    wgsl_seed = st.bounce_seeds[i] if wgsl else None

    def keyed(salt: int, n: int | None = None):
        """The threefry draws of bounce i under fold_in(key, salt) (JAX's
        roulette and NEE keys, ops/integrators.py:437-440, :792-793): an
        (n, *batch) stack, or one batch plane when n is None."""
        k = rng_ops.fold_in(rng_ops.fold_in(key, salt), i)
        return rng_ops.uniform(k, batch_shape if n is None else (n, *batch_shape), dev)

    def frame_uniform(x):
        """A draw of the WGSL stream, the same for every ray of the batch."""
        return x.expand(*batch_shape, *x.shape)

    def shadow_visible(ok, pnt, omega, window):
        """Lanes of `ok` with no hit in (t_min, window): the any-hit query,
        driven only by lanes whose sample is otherwise valid.  A decision,
        so it runs without autograd: its (P, N) planes are never kept."""
        vis = torch.zeros_like(ok)
        idx = torch.nonzero(ok.reshape(-1)).squeeze(1)
        if idx.numel():
            with torch.no_grad():
                t = nearest_t_scene(pnt.reshape(-1, 3)[idx], omega.reshape(-1, 3)[idx],
                                    sc, t_min, t_max)
                vis.reshape(-1)[idx] = t >= window.reshape(-1)[idx]
                if intersect_ops.BVH_VISITS is not None:
                    intersect_ops.count_walks(pnt.reshape(-1, 3)[idx],
                                              omega.reshape(-1, 3)[idx], sc, t_min,
                                              window.reshape(-1)[idx], "shadow")
        return vis

    def remapped(u1, u2, rot_salt):
        """The first-bounce remap of a draw pair under the sampler."""
        if sampler_spec is None or (not per_ray and not first):
            return u1, u2
        r1, r2 = rng_ops.sampler_uniforms(
            u1, u2, pixel_ids, s, frame_seed_u32, sampler_spec, rot_salt=rot_salt)
        return _either(first, r1, u1), _either(first, r2, u2)

    if ctx.count_rays:
        rays_box[0] = rays_box[0] + live.to(torch.float32)
    if intersect_ops.BVH_VISITS is not None:
        # The kernel's walks for the live rays (ops/intersect.BVH_VISITS).
        lv = live.reshape(-1)
        intersect_ops.count_walks(o.reshape(-1, 3)[lv], d.reshape(-1, 3)[lv], sc, t_min, t_max,
                                  "closest")
    if mis:
        hit, albedo, kind, param, mesh_won = intersect_scene(
            o, d, sc, t_min, t_max, want_mesh_wins=True)
    else:
        hit, albedo, kind, param = intersect_scene(o, d, sc, t_min, t_max)
    if wgsl:
        # hash(seed + i*1000) of the whole frame (wgsl:268).
        unit_vec = frame_uniform(rng_ops.random_unit_vector(wgsl_seed))
        u_reflect = frame_uniform(rng_ops.wgsl_random_float(wgsl_seed))
    elif key is not None:
        # JAX's scatter draws (ops/integrators.py:287-291).
        k_uv, k_refl = rng_ops.split(rng_ops.fold_in(key, i))
        u = rng_ops.uniform(k_uv, (2, *batch_shape), dev)
        unit_vec = rng_ops.unit_vector_from_uniforms(u[0], u[1])
        u_reflect = rng_ops.uniform(k_refl, batch_shape, dev)
    else:
        base = 16 + 3 * i
        # The first-bounce scatter pair (salt 6): strata of the sphere.  2 pi
        # stays outside the remap: jitted trace_path runs its bounces in a
        # while loop, and XLA folds no constant into it.
        u1, u2 = remapped(rng_ops.uniform_hash(pixel_seeds, base),
                          rng_ops.uniform_hash(pixel_seeds, base + 1),
                          rng_ops._SCATTER_ROT_SALT)
        unit_vec = rng_ops.unit_vector_from_uniforms(u1, u2)
        u_reflect = rng_ops.uniform_hash(pixel_seeds, base + 2)
    new_dir, attenuation, ok = scatter(
        d, hit.normal, hit.front_face, albedo, kind, param, unit_vec, u_reflect
    )

    missed = live & ~hit.hit
    result = torch.where(
        missed[..., None], _add_sky(result, throughput, sky_color(d), ctx.sky_intensity),
        result,
    )
    emissive = live & hit.hit & (kind == EMISSIVE)
    if mis:
        # Power heuristic for a BSDF ray that left a diffuse vertex and
        # hit light l: w_b = 1 / (1 + r^2), r = p_nee / p_b as seen from
        # the previous vertex o.
        hit_lid = ctx.lid_sphere[hit.idx.clamp(0, sc.spheres.count - 1)]
        if sc.mesh is not None:
            hit_lid = torch.where(
                mesh_won, ctx.lid_tri[hit.idx.clamp(0, sc.mesh.num_triangles - 1)], hit_lid)
        omc = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
        for l in range(n_sl):
            dlo = o - lights.centers[l]
            d2o = torch.clamp(dot3(dlo, dlo), min=1e-12)
            r_l = lights.radii[l]
            omc = torch.where(hit_lid == l, _one_minus_cos_max(r_l * r_l, d2o), omc)
        r_ratio = 1.0 / torch.clamp(2.0 * omc * prev_cos, min=1e-12)
        if n_tl:
            delta = hit.point - o
            d2h = torch.clamp(dot3(delta, delta), min=1e-12)
            d3h = d2h * sqrt(d2h)
            for j in range(n_tl):
                ndot = torch.abs(dot3(delta, tl.normal[j]))
                r_tri = (torch.pi * d3h) / torch.clamp(ndot * tl.area[j] * prev_cos,
                                                       min=1e-12)
                r_ratio = torch.where(hit_lid == n_sl + j, r_tri, r_ratio)
        if total > 4:
            r_ratio = r_ratio / float(total)
        w_emis = torch.where(
            prev_diffuse,
            torch.where(hit_lid >= 0, 1.0 / fma(r_ratio, r_ratio, torch.ones_like(r_ratio)),
                        0.0),
            1.0,
        )
    else:
        w_emis = torch.where(prev_diffuse, 0.0, 1.0) if nee else torch.ones_like(prev_cos)
    result = torch.where(
        emissive[..., None], xla_fma(throughput * albedo, (param * w_emis)[..., None], result),
        result,
    )

    inside_any = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    if nee:
        pnt, nrm = hit.point, hit.normal
        for l in range(n_sl):
            dcl = lights.centers[l] - pnt
            r_l = lights.radii[l]
            inside_any = inside_any | (dot3(dcl, dcl) <= r_l * r_l * 1.0001)
        nee_ok = live & hit.hit & (kind == LAMBERTIAN) & ~inside_any
        salt0 = 2000 + 37 * i
        last = i == max_depth - 1
        nee_groups = {}

        def nee_uniform(salt_off: int, k: int):
            """Draw k of the NEE group at salt offset salt_off: the pixel
            stream's salt 2000 + 37i + salt_off + k, on the WGSL stream
            uniform_hash(hash(bounce seed + 4241 + salt_off), k), on the
            threefry stream plane k of the group's keyed planes (three for
            the picked light at offset 0, two for light g's pair)."""
            if key is not None:
                if salt_off not in nee_groups:
                    nee_groups[salt_off] = keyed(2000 + salt_off, 3 if salt_off == 0 else 2)
                return nee_groups[salt_off][k]
            if wgsl:
                group = rng_ops.wgsl_hash((wgsl_seed + 4241 + salt_off) & rng_ops._MASK)
                return frame_uniform(rng_ops.uniform_hash(group, k))
            return rng_ops.uniform_hash(pixel_seeds, salt0 + salt_off + k)

        def draws(g: int):
            u1n, u2n = nee_uniform(7 * g + 1, 0), nee_uniform(7 * g + 1, 1)
            if total <= 4:
                u1n, u2n = remapped(u1n, u2n, rng_ops._NEE_ROT_SALT_BASE + g)
            return u1n, u2n

        def add(result, ok, omega, window, wgt, le):
            valid = nee_ok & ok
            if ctx.count_rays:
                # One shadow ray per lane whose sample is valid, counted
                # before the visibility test.
                rays_box[0] = rays_box[0] + valid.to(torch.float32)
            valid = valid & shadow_visible(valid, pnt, omega, window * (1.0 - 1e-3))
            if mis:
                wgt = _either(last, wgt, _mis_nee_weight(wgt, False))
            return torch.where(valid[..., None],
                               xla_fma(throughput * albedo * le, wgt[..., None], result),
                               result)

        def sphere_term(result, li, u1n, u2n, weight):
            omega, t_l, ok, wgt0 = _sphere_candidate(
                pnt, nrm, lights.centers[li], lights.radii[li], u1n, u2n)
            return add(result, ok, omega, t_l, wgt0 * weight, lights.emission[li])

        def tri_term(result, ji, u1n, u2n, weight):
            omega, dist, ok, wgt0 = _tri_candidate(
                pnt, nrm, tl.v0[ji], tl.e1[ji], tl.e2[ji], tl.normal[ji], tl.area[ji],
                u1n, u2n)
            return add(result, ok, omega, dist, wgt0 * weight, tl.emission[ji])

        if total <= 4:
            # Every light, sphere lights first, weight 1.
            for l in range(n_sl):
                u1n, u2n = draws(l)
                li = torch.full(batch_shape, l, dtype=torch.long, device=dev)
                result = sphere_term(result, li, u1n, u2n, 1.0)
            for j in range(n_tl):
                u1n, u2n = draws(n_sl + j)
                ji = torch.full(batch_shape, j, dtype=torch.long, device=dev)
                result = tri_term(result, ji, u1n, u2n, 1.0)
        else:
            # One light, weighted by the count.
            u1n, u2n = nee_uniform(0, 1), nee_uniform(0, 2)
            if ctx.pick_per_sample:
                pick_seed = rng_ops.as_u32(s, dev) ^ rng_ops.wgsl_hash(
                    rng_ops.as_u32(frame_seed_u32, dev))
                bounce_seed = rng_ops.hash2(pick_seed, 3000 + i)
                g = rng_ops.hash2(bounce_seed, 0) % total
                gi = g.to(torch.long).expand(batch_shape)
            else:
                u_l = nee_uniform(0, 0)
                gi = torch.clamp((u_l * float(total)).long(), 0, total - 1)
            if n_tl == 0:
                result = sphere_term(result, gi, u1n, u2n, float(total))
            else:
                # Both candidates from the picked ordinal, selected
                # per lane before the one shadow query.
                is_sph = gi < n_sl
                if n_sl:
                    li = torch.clamp(gi, 0, n_sl - 1)
                    s_om, s_t, s_ok, s_w = _sphere_candidate(
                        pnt, nrm, lights.centers[li], lights.radii[li], u1n, u2n)
                    s_le = lights.emission[li]
                ji = torch.clamp(gi - n_sl, 0, n_tl - 1)
                t_om, t_dist, t_ok, t_w = _tri_candidate(
                    pnt, nrm, tl.v0[ji], tl.e1[ji], tl.e2[ji], tl.normal[ji],
                    tl.area[ji], u1n, u2n)
                if n_sl:
                    sel = is_sph[..., None]
                    omega = torch.where(sel, s_om, t_om)
                    window = torch.where(is_sph, s_t, t_dist)
                    ok_l = torch.where(is_sph, s_ok, t_ok)
                    wgt0 = torch.where(is_sph, s_w, t_w)
                    le = torch.where(sel, s_le, tl.emission[ji])
                else:
                    omega, window, ok_l, wgt0, le = t_om, t_dist, t_ok, t_w, tl.emission[ji]
                result = add(result, ok_l, omega, window, wgt0 * float(total), le)

    # Absorbed rays (metal below the surface) contribute black.
    scattered = live & hit.hit & ok & (kind != EMISSIVE)
    throughput = torch.where(scattered[..., None], throughput * attenuation, throughput)
    o = torch.where(scattered[..., None], hit.point, o)
    d = torch.where(scattered[..., None], new_dir, d)
    live = scattered
    # Only lanes that ran NEE suppress (or MIS-weight) BSDF-hit emission.
    prev_diffuse = scattered & (kind == LAMBERTIAN) & ~inside_any
    if mis:
        nd2 = torch.clamp(dot3(new_dir, new_dir), min=1e-20)
        cos_s = dot3(new_dir, hit.normal) * torch.rsqrt(nd2)
        prev_cos = torch.where(prev_diffuse, torch.clamp(cos_s, min=0.0), 0.0)

    roulette = i >= ctx.rr_depth if ctx.rr_depth > 0 else False
    if per_ray or roulette:
        if ctx.rr_depth > 0:
            # Survive with p = max channel throughput (clamped), divide by p.
            if wgsl:
                u_rr = frame_uniform(rng_ops.wgsl_random_float((wgsl_seed + 977) & rng_ops._MASK))
            elif key is not None:
                u_rr = keyed(1000)
            else:
                u_rr = rng_ops.uniform_hash(pixel_seeds, 1000 + i)
            p = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
            survive = u_rr < p
            if per_ray:
                survive = survive | ~roulette
                scale = torch.where(roulette, 1.0 / p, 1.0)
            else:
                scale = 1.0 / p
            throughput = torch.where(
                (live & survive)[..., None], throughput * scale[..., None],
                throughput,
            )
            live = live & survive
    return PathState(o=o, d=d, throughput=throughput, result=result, live=live,
                     prev_diffuse=prev_diffuse, prev_cos=prev_cos, rays=rays_box[0],
                     pixel_seeds=pixel_seeds, pixel_ids=pixel_ids,
                     bounce_seeds=st.bounce_seeds, generator_key=key)


def trace_path(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    scene,
    max_depth: int,
    t_min: float,
    t_max: float,
    *,
    pixel_seeds: torch.Tensor | None = None,
    bounce_seeds: torch.Tensor | None = None,
    generator_key=None,
    parity: bool = False,
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    nee: bool = False,
    mis: bool = False,
    pixel_ids: torch.Tensor | None = None,
    sample_index=None,
    frame_seed_u32=None,
    sampler_spec: tuple | None = None,
    light_pick: str = "lane",
    count_rays: bool = False,
):
    """Path-trace a batch of rays; returns linear RGB
    of shape dirs.shape, or (rgb, rays) with `count_rays=True`: rays is a
    per-ray f32 count of the rays traced, one closest-hit walk per live
    bounce plus one per NEE shadow ray whose light sample is valid, counted
    before its visibility test (the megakernel's counters; vertices inside a
    sphere light run no NEE and count none).  Draws are pure functions of
    (pixel seed, bounce, salt): salts 16+3i..18+3i scatter, 1000+i Russian
    roulette, 2000+37i+7g+{0,1,2} NEE toward light ordinal g (sphere lights
    first, then triangle lights).

    `nee=True` samples every light from each diffuse hit when there are at
    most 4, else one picked light weighted by the count.  `light_pick`
    chooses that pick: 'lane' draws it per lane from salt 2000+37i (the
    JAX package's 'jax' engine); 'sample' takes one light per (sample,
    bounce) for the whole batch, hash2(hash2(sample ^ wgsl_hash(frame
    seed), 3000+i), 0) mod L (the megakernel's pick, which needs the scalar
    `sample_index` and `frame_seed_u32`).  `sampler_spec` remaps the
    first-bounce scatter pair (salt 6) and, in the <= 4-light loop, light
    g's first-bounce NEE pair (salt 8+g); it needs `pixel_ids`,
    `sample_index` and `frame_seed_u32`.

    The stream is exactly one of `pixel_seeds` (per-pixel counter seeds,
    generate_rays_hash's), `bounce_seeds` (the WGSL stream:
    make_bounce_seeds' (max_depth,) scalar seeds, one a bounce for the whole
    frame, as ray_color draws them; NEE draws hash(seed + 4241 + 7g + 1),
    Russian roulette seed + 977) or `generator_key` (the threefry mode, a
    key pair or an int, ops/rng.as_key; jax.random's draws bit for bit:
    bounce i's scatter from split(fold_in(key, i)), its NEE group at salt
    offset o from fold_in(fold_in(key, 2000 + o), i), its roulette from
    fold_in(fold_in(key, 1000), i)).  `parity=True` keeps the reference's sky
    leak: a ray still live after max_depth bounces gains throughput * sky
    (wgsl:293-296) instead of ending black.

    The loop body is `path_bounce`, which the wavefront engine's plain
    version runs one bounce at a time.
    """
    if sum(x is not None for x in (pixel_seeds, bounce_seeds, generator_key)) != 1:
        raise ValueError("pass exactly one of pixel_seeds=, bounce_seeds= or "
                         "generator_key=")
    if pixel_seeds is None and sampler_spec is not None:
        raise ValueError("sampler_spec= remaps the counter stream; the WGSL stream "
                         "(bounce_seeds=) and the threefry stream (generator_key=) "
                         "take none")
    ctx = PathContext(
        scene, max_depth, t_min, t_max, russian_roulette_depth=russian_roulette_depth,
        sky_intensity=sky_intensity, nee=nee, mis=mis, frame_seed_u32=frame_seed_u32,
        sampler_spec=sampler_spec, light_pick=light_pick, count_rays=count_rays,
        need_ids=pixel_ids is None or sample_index is None or frame_seed_u32 is None)
    if ctx.pick_per_sample and (sample_index is None or frame_seed_u32 is None):
        raise ValueError("light_pick='sample' needs sample_index= and frame_seed_u32=")
    if ctx.pick_per_sample and pixel_seeds is None:
        raise ValueError("the WGSL and threefry streams pick their light per lane "
                         "(light_pick='lane')")
    if generator_key is not None:
        generator_key = rng_ops.as_key(generator_key)
    st = initial_path_state(origins, dirs, pixel_seeds, pixel_ids, count_rays=count_rays,
                            bounce_seeds=bounce_seeds, generator_key=generator_key)
    # Every ray runs the full trip count with its `live` mask.
    for i in range(max_depth):
        st = path_bounce(ctx, st, i, sample_index)
    result = st.result
    if parity:
        result = torch.where(
            st.live[..., None],
            _add_sky(result, st.throughput, sky_color(st.d), ctx.sky_intensity), result)
    # Otherwise exhausted rays contribute black.
    return (result, st.rays) if count_rays else result


def make_bounce_seeds(color_seed_u32, max_depth: int) -> torch.Tensor:
    """The per-bounce scalar seeds of ray_color, hash(seed + i*1000)
    (wgsl:268), as a (max_depth,) int64 tensor of u32 values;
    `color_seed_u32` is the frame-uniform seed the reference passes to
    ray_color (update()'s seed + 1, wgsl:355)."""
    seed = rng_ops.as_u32(color_seed_u32)
    i = torch.arange(max_depth, dtype=torch.int64, device=seed.device)
    return rng_ops.wgsl_hash((seed + i * 1000) & rng_ops._MASK)
