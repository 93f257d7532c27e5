"""A plain path tracer: the benchmark's reference for what the program renders.

A frozen copy of the program's plain integrator, cut to the routes the
benchmark's cells take (hash stream, independent sampler, path integrator,
sphere and triangle tests, flat or smooth shading, NEE with MIS toward at
most four triangle lights, Russian roulette), in plain PyTorch.  It imports
nothing of the program.  It rounds as the program's CUDA kernels do: the
fused multiply-adds they write are fused here (formed in f64, rounded
once), the sums they leave unfused are unfused, and square roots, sines
and cosines are taken in f64 and rounded to f32, so a frame agrees with the
kernels' statistically (a few pixels flip where a ray grazes an edge), not
bit for bit.

Every pixel is independent, so `render_pixels` traces any set of global
pixel ids, each under its own frame seed: one call covers sampled pixels
of many frames.  Every sphere is tested; of the faces, each ray tests those
that cull.py cannot rule out, a superset of those a brute-force scan would
accept, so the closest hit is the scan's, bit for bit: the least t, the
smallest face index among equal ones.  Any correct BVH walk finds it.

`precision=torch.bfloat16` is the control: the scene, the camera and the
path state (ray origins and directions, throughput, radiance) are rounded
to that type at every bounce, the arithmetic in between staying f32.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math

import numpy as np
import torch

from rtbench.reference import cull

F32 = torch.float32
MASK = 0xFFFFFFFF
LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
TWO_PI = 6.283185307179586

# --------------------------------------------------------------------------
# Rounding as the kernels round.


def fma(a, b, c):
    """a * b + c rounded once (broadcasting)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a, b):
    """The fused chain a0 b0 -> + a1 b1 -> + a2 b2."""
    t = a[..., 0] * b[..., 0]
    t = fma(a[..., 1], b[..., 1], t)
    return fma(a[..., 2], b[..., 2], t)


def sum3(a, b):
    """The unfused inner product, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([fma(ay, bz, -(az * by)), fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], dim=-1)


def sqrt(x):
    return torch.sqrt(x.double()).float()


def cos_sin(x):
    x = x.double()
    return torch.cos(x).float(), torch.sin(x).float()


def _tanf(x: float) -> float:
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").tanf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn(x)


# --------------------------------------------------------------------------
# The hash stream (u32 values carried in int64).


def _mul32(a, b: int):
    return (a * (b & 0xFFFF) + (((a * ((b >> 16) & 0xFFFF)) & 0xFFFF) << 16)) & MASK


def wgsl_hash(s):
    s = (s & MASK) ^ 2747636419
    s = _mul32(s, 2654435769)
    s = s ^ (s >> 16)
    s = _mul32(s, 2654435769)
    s = s ^ (s >> 16)
    return _mul32(s, 2654435769)


def pixel_seeds(pixel_ids, sample: int, frame_seeds):
    inner = wgsl_hash((_mul32(torch.full_like(frame_seeds, sample & MASK), 0x85EBCA6B)
                       + frame_seeds) & MASK)
    return wgsl_hash(_mul32(pixel_ids & MASK, 2654435761) ^ inner)


def uniform(seeds, salt: int):
    """U[0, 1): the top 24 bits of hash(seed + salt * 0x68E31DA4) / 2^24."""
    h = wgsl_hash((seeds + ((salt * 0x68E31DA4) & MASK)) & MASK)
    return (h >> 8).to(F32) * (1.0 / (1 << 24))


# --------------------------------------------------------------------------
# Scene and camera.


@dataclasses.dataclass
class Scene:
    """Spheres and triangles as f32 planes, and the NEE light list."""

    centers: torch.Tensor
    radii: torch.Tensor
    s_albedo: torch.Tensor
    s_kind: torch.Tensor
    s_param: torch.Tensor
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normals: torch.Tensor
    f_albedo: torch.Tensor
    f_kind: torch.Tensor
    f_param: torch.Tensor
    light_faces: list  # face index of each triangle light, in face order
    l_normal: torch.Tensor
    l_area: torch.Tensor
    l_emission: torch.Tensor
    n0: torch.Tensor | None = None  # corner normals (F, 3) of a smooth scene
    n1: torch.Tensor | None = None
    n2: torch.Tensor | None = None
    clusters: cull.Clusters | None = None

    @property
    def n_faces(self) -> int:
        return self.v0.shape[0]


def _corner_normals(vertices: np.ndarray, faces: np.ndarray, smooth: bool) -> np.ndarray:
    """(3, F, 3) f32 normals at each face's corners, as the program's
    make_mesh forms them: the raw face cross products summed per vertex in
    f64 and normalised; for a flat group, the face normal at every corner."""
    v0, v1, v2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    cr = np.cross(v1 - v0, v2 - v0)
    if not smooth:
        n = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
        return np.stack([n, n, n])
    vn = np.zeros_like(vertices, np.float64)
    for c in range(3):
        np.add.at(vn, faces[:, c], cr)
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
    vn = vn.astype(np.float32)
    return np.stack([vn[faces[:, c]] for c in range(3)])


def build_scene(data, device, precision=F32) -> Scene:
    """The reference's scene from the benchmark's SceneData: edges and unit
    normals of every face, corner normals where a group is smooth (then for
    every face, as the program merges them), the emissive faces as
    triangle lights, and the faces' clusters for culling."""
    verts, faces, alb, kind, par, corners = [], [], [], [], [], []
    smooth = any(g.smooth for g in data.mesh)
    base = 0
    for g in data.mesh:
        verts.append(np.asarray(g.vertices, np.float32))
        faces.append(np.asarray(g.faces, np.int64) + base)
        if smooth:
            corners.append(_corner_normals(verts[-1], faces[-1] - base, g.smooth))
        base += len(g.vertices)
        n = len(g.faces)
        alb.append(np.broadcast_to(np.asarray(g.albedo, np.float32), (n, 3)))
        kind.append(np.full(n, g.kind, np.int32))
        par.append(np.full(n, g.param, np.float32))
    if faces:
        v = np.concatenate(verts)
        f = np.concatenate(faces)
        v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = v1 - v0, v2 - v0
        cr = np.cross(e1, e2)
        normals = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
        alb, kind, par = np.concatenate(alb), np.concatenate(kind), np.concatenate(par)
    else:
        v0 = e1 = e2 = normals = np.zeros((0, 3), np.float32)
        alb = np.zeros((0, 3), np.float32)
        kind, par = np.zeros(0, np.int32), np.zeros(0, np.float32)
    cr64 = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    area2 = np.linalg.norm(cr64, axis=-1)
    lights = np.flatnonzero((kind == EMISSIVE) & (area2 > 1e-12))
    if len(lights) > 4:
        raise NotImplementedError("the reference samples every light: at most 4")
    if np.any((data.kind == EMISSIVE) & (data.radii > 0)):
        raise NotImplementedError("the reference has no sphere lights")

    def t(a, dtype=F32):
        x = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        return x.to(precision).to(F32) if dtype == F32 else x

    n0, n1, n2 = (t(x) for x in np.concatenate(corners, 1)) if smooth else (None,) * 3
    v0, e1, e2 = t(v0), t(e1), t(e2)
    return Scene(
        centers=t(data.centers), radii=t(data.radii), s_albedo=t(data.albedo),
        s_kind=t(data.kind, torch.int64), s_param=t(data.param),
        v0=v0, e1=e1, e2=e2, normals=t(normals), f_albedo=t(alb),
        f_kind=t(kind, torch.int64), f_param=t(par), light_faces=[int(i) for i in lights],
        l_normal=t((cr64[lights] / area2[lights][:, None]).astype(np.float32)),
        l_area=t((0.5 * area2[lights]).astype(np.float32)),
        l_emission=t(alb[lights] * par[lights][:, None]),
        n0=n0, n1=n1, n2=n2, clusters=cull.build(v0, e1, e2),
    )


@dataclasses.dataclass
class Camera:
    center: torch.Tensor
    upper_left: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    disk_u: torch.Tensor
    disk_v: torch.Tensor
    defocus: float


def derive_camera(cam: dict, width: int, height: int, device, precision=F32) -> Camera:
    """camera.rs:293-350 in f32: the viewport from the field of view and
    focus distance, the thin lens from the defocus angle."""
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    look_from, look_at, vup = f(cam["look_from"]), f(cam["look_at"]), f(cam["vup"])
    fov, defocus, focus = f(cam["fov"]), f(cam["defocus"]), f(cam["focus"])
    deg = f(math.pi / 180.0)
    aspect = f(width) / f(height)
    h = f(_tanf(float(fov * deg / 2.0)))
    vh = 2.0 * h * focus
    vw = vh * aspect
    norm = lambda v: sqrt(dot3(v, v))
    gaze = look_from - look_at
    w = gaze / norm(gaze)
    uu = cross(vup, w)
    u = uu / norm(uu)
    v = cross(w, u)
    vu, vv = vw * u, -vh * v
    du, dv = vu / f(float(width)), vv / f(float(height))
    ul = look_from - focus * w - vu / 2.0 - vv / 2.0
    radius = focus * f(_tanf(float((defocus / 2.0) * deg)))
    q = lambda x: x.to(precision).to(F32)
    return Camera(q(look_from), q(ul), q(du), q(dv), q(u * radius), q(v * radius),
                  float(defocus))


# --------------------------------------------------------------------------
# Rays, hits, materials.


def primary_rays(cam: Camera, pid, sample: int, fseeds, width: int):
    seeds = pixel_seeds(pid, sample, fseeds)
    jx, jy = uniform(seeds, 1) - 0.5, uniform(seeds, 2) - 0.5
    fx = ((pid % width).to(F32) + 0.5 + jx)[:, None]
    fy = ((pid // width).to(F32) + 0.5 + jy)[:, None]
    centers = fma(cam.dv, fy, fma(cam.du, fx, cam.upper_left))
    u3, angle = uniform(seeds, 3), uniform(seeds, 4) * TWO_PI
    radius = sqrt(u3)
    c, s = cos_sin(angle)
    lens = fma((radius * s)[:, None], cam.disk_v,
               fma((radius * c)[:, None], cam.disk_u, cam.center))
    origins = lens if cam.defocus > 0.0 else cam.center.expand_as(lens)
    return origins, centers - origins, seeds


def _sphere_roots(o, d, sc: Scene, t_min, t_max):
    """(P, N) near-then-far roots and their validity."""
    o, d, c, r = o[:, None, :], d[:, None, :], sc.centers, sc.radii
    h = dot3(d, c) - dot3(o, d)
    cc = (dot3(c, c) - r * r) - 2.0 * dot3(o, c) + dot3(o, o)
    a = dot3(d, d)
    disc = fma(h, h, -(a * cc))
    pos = disc > 0.0
    sd = torch.where(pos, sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    near, far = (h - sd) * inv_a, (h + sd) * inv_a
    near_ok = (near > t_min) & (near < t_max)
    far_ok = (far > t_min) & (far < t_max)
    return torch.where(near_ok, near, far), (disc >= 0.0) & (near_ok | far_ok) & (r > 0.0)


def _tri_t(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore of rays (o, d) and faces (v0, e1, e2) broadcast
    together (..., 3): (t, u, v, hit)."""
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    par = torch.abs(det) < 1e-12
    inv = 1.0 / torch.where(par, 1.0, det)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv
    t = dot3(e2, qvec) * inv
    return t, u, v, ~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)


NONE = (1 << 63) - 1
FACE_BITS = 31


def _closest_face(o, d, sc: Scene, t_min, t_max):
    """(t, face, u, v) of each ray: the least t that _tri_t accepts over the
    faces (inf where none) and the smallest index of a face that has it (-1
    where none); in a smooth scene, that face's barycentrics.  Each accepted
    pair's key is t's bits, then the face's index: t > t_min > 0, so the
    keys order as (t, face) does, and their least is torch.min's choice."""
    if not t_min > 0.0:
        raise ValueError("the faces' keys need t_min > 0")
    best = torch.full((o.shape[0],), NONE, dtype=torch.int64, device=o.device)
    for r, f in cull.candidates(sc.clusters, o, d, t_min, t_max):
        t, _, _, ok = _tri_t(o[r], d[r], sc.v0[f], sc.e1[f], sc.e2[f], t_min, t_max)
        ok = torch.nonzero(ok).squeeze(1)
        key = (t[ok].view(torch.int32).to(torch.int64) << FACE_BITS) | f[ok]
        best.scatter_reduce_(0, r[ok], key, "amin")
    found = best < NONE
    face = torch.where(found, best & ((1 << FACE_BITS) - 1), -1)
    t = torch.where(found, (best >> FACE_BITS).to(torch.int32).view(torch.float32), torch.inf)
    u = v = None
    if sc.n0 is not None:
        fi = face.clamp(min=0)
        _, u, v, _ = _tri_t(o, d, sc.v0[fi], sc.e1[fi], sc.e2[fi], t_min, t_max)
    return t, face, u, v


def closest_hit(o, d, sc: Scene, t_min, t_max):
    """(t, hit, point, normal, front, albedo, kind, param, face) of each ray;
    face is the winning face's index, -1 where a sphere won or nothing hit.
    A smooth scene's face shades with its corner normals blended at the
    hit's barycentrics and renormalised, unfused, as the kernels do."""
    root, valid = _sphere_roots(o, d, sc, t_min, t_max)
    ts, si = torch.min(torch.where(valid, root, torch.inf), dim=-1)
    hit_s = torch.isfinite(ts)
    face = torch.full_like(si, -1)
    if sc.n_faces:
        tf, fi, bu, bv = _closest_face(o, d, sc, t_min, t_max)
        hit_f = torch.isfinite(tf)
        wins = hit_f & (~hit_s | (tf < ts))
        face = torch.where(wins, fi, face)
    else:
        wins = torch.zeros_like(hit_s)
        tf = ts
    hit = hit_s | wins
    t = torch.where(wins, tf, torch.where(hit_s, ts, t_max))
    point = fma(torch.where(hit, t, 0.0)[:, None], d, o)
    r = sc.radii[si]
    outward_s = (point - sc.centers[si]) / torch.where(r != 0.0, r, 1.0)[:, None]
    fidx = face.clamp(min=0)
    if sc.n_faces:
        if sc.n0 is not None:
            w0 = 1.0 - bu - bv
            blend = (w0[:, None] * sc.n0[fidx] + bu[:, None] * sc.n1[fidx]
                     + bv[:, None] * sc.n2[fidx])
            face_n = _normalize(blend)
        else:
            face_n = sc.normals[fidx]
        outward = torch.where(wins[:, None], face_n, outward_s)
        albedo = torch.where(wins[:, None], sc.f_albedo[fidx], sc.s_albedo[si])
        kind = torch.where(wins, sc.f_kind[fidx], sc.s_kind[si])
        param = torch.where(wins, sc.f_param[fidx], sc.s_param[si])
    else:
        outward, albedo, kind, param = outward_s, sc.s_albedo[si], sc.s_kind[si], sc.s_param[si]
    front = sum3(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return t, hit, point, normal, front, albedo, kind, param, face


def nearest_t(o, d, sc: Scene, t_min, t_max):
    root, valid = _sphere_roots(o, d, sc, t_min, t_max)
    t = torch.amin(torch.where(valid, root, t_max), dim=-1)
    if sc.n_faces:
        tf = torch.full_like(t, t_max)
        for r, f in cull.candidates(sc.clusters, o, d, t_min, t_max):
            tt, _, _, ok = _tri_t(o[r], d[r], sc.v0[f], sc.e1[f], sc.e2[f], t_min, t_max)
            tf.scatter_reduce_(0, r[ok], tt[ok], "amin")
        t = torch.minimum(t, tf)
    return t


def _normalize(v):
    return v / torch.clamp(sqrt(sum3(v, v))[:, None], min=1e-20)


def _reflect(v, n):
    return (-2.0 * sum3(v, n))[:, None] * n + v


def scatter(d, normal, front, albedo, kind, param, unit_vec, u_reflect):
    """The three BSDFs, selected by kind: (direction, attenuation, ok)."""
    lam = normal + unit_vec
    lam = torch.where((sum3(lam, lam) < 1e-6)[:, None], normal, lam)
    reflected = param[:, None] * unit_vec + _normalize(_reflect(d, normal))
    metal = _normalize(reflected)
    metal_ok = sum3(reflected, normal) > 0.0
    ior = torch.where(kind == DIELECTRIC, param, 1.5)
    eta = torch.where(front, 1.0 / ior, ior)
    ud = _normalize(d)
    cos_t = torch.clamp(sum3(-ud, normal), max=1.0)
    sin2 = -cos_t * cos_t + 1.0
    sin_t = torch.where(sin2 > 0.0, sqrt(torch.where(sin2 > 0.0, sin2, 1.0)), 0.0)
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    schlick = (1.0 - r0) * torch.pow((1.0 - cos_t).double(), 5.0).float() + r0
    refl = (eta * sin_t > 1.0) | (schlick > u_reflect)
    ct = torch.clamp(sum3(-ud, normal), max=1.0)[:, None]
    perp = eta[:, None] * (ct * normal + ud)
    k = 1.0 - sum3(perp, perp)
    sk = torch.where(k > 0.0, sqrt(torch.where(k > 0.0, k, 1.0)), 0.0)
    refr = -sk[:, None] * normal + perp
    diel = _normalize(torch.where(refl[:, None], _reflect(ud, normal), refr))
    k3 = kind[:, None]
    out = torch.where(k3 == LAMBERTIAN, lam, torch.where(k3 == METAL, metal, diel))
    att = torch.where(k3 == DIELECTRIC, torch.ones_like(albedo), albedo)
    return out, att, torch.where(kind == METAL, metal_ok, True)


def sky(d):
    unit = d / torch.clamp(sqrt(sum3(d, d))[:, None], min=1e-20)
    a = 0.5 * (unit[:, 1:2] + 1.0)
    blue = torch.tensor((0.5, 0.7, 1.0), dtype=F32, device=d.device)
    return a * blue + (1.0 - a) * torch.ones_like(blue)


# --------------------------------------------------------------------------
# The path integrator.


@dataclasses.dataclass(frozen=True)
class Options:
    max_depth: int
    t_min: float = 1e-3
    t_max: float = 3.4e35
    rr_depth: int = 0
    sky_intensity: float = 1.0
    nee: bool = False
    mis: bool = False


def trace(o, d, seeds, sc: Scene, opt: Options, precision=F32, record=None):
    """Radiance (P, 3) of one sample of each ray.  `record(kind, o, d, t)`,
    when given, receives every closest-hit query ("closest") and shadow
    query ("shadow") with its answer, for the work count."""
    q = (lambda x: x) if precision == F32 else (lambda x: x.to(precision).to(F32))
    dev, p = d.device, d.shape[0]
    thr = torch.ones((p, 3), dtype=F32, device=dev)
    res = torch.zeros((p, 3), dtype=F32, device=dev)
    live = torch.ones(p, dtype=torch.bool, device=dev)
    prev_diffuse = torch.zeros(p, dtype=torch.bool, device=dev)
    prev_cos = torch.zeros(p, dtype=F32, device=dev)
    n_tl = len(sc.light_faces) if opt.nee else 0
    if opt.mis and not opt.nee:
        raise ValueError("mis needs nee")
    lid_face = torch.full((max(sc.n_faces, 1),), -1, dtype=torch.int64, device=dev)
    for j, fidx in enumerate(sc.light_faces):
        lid_face[fidx] = j
    for i in range(opt.max_depth):
        o, d, thr, res = q(o), q(d), q(thr), q(res)
        t, hit, pnt, nrm, front, albedo, kind, param, face = closest_hit(
            o, d, sc, opt.t_min, opt.t_max)
        if record is not None:
            record("closest", o[live], d[live], t[live])
        base = 16 + 3 * i
        z = 2.0 * uniform(seeds, base) - 1.0
        a = uniform(seeds, base + 1) * TWO_PI
        rr = sqrt(torch.clamp(-z * z + 1.0, min=0.0))
        c, s = cos_sin(a)
        unit_vec = torch.stack([rr * c, rr * s, z], dim=-1)
        new_dir, att, ok = scatter(d, nrm, front, albedo, kind, param, unit_vec,
                                   uniform(seeds, base + 2))
        missed = live & ~hit
        if opt.sky_intensity == 1.0:
            sky_term = thr * sky(d) + res
        else:
            sky_term = (thr * sky(d)) * opt.sky_intensity + res
        res = torch.where(missed[:, None], sky_term, res)
        emissive = live & hit & (kind == EMISSIVE)
        if opt.mis:
            hit_lid = torch.where(face >= 0, lid_face[face.clamp(min=0)], -1)
            # No sphere lights: the ratio of a BSDF ray that hits none is the
            # program's 1 / max(2 * 0 * cos, 1e-12).
            r_ratio = 1.0 / torch.clamp(torch.zeros_like(prev_cos), min=1e-12)
            delta = pnt - o
            d2h = torch.clamp(dot3(delta, delta), min=1e-12)
            d3h = d2h * sqrt(d2h)
            for j in range(n_tl):
                ndot = torch.abs(dot3(delta, sc.l_normal[j]))
                r_tri = (math.pi * d3h) / torch.clamp(ndot * sc.l_area[j] * prev_cos, min=1e-12)
                r_ratio = torch.where(hit_lid == j, r_tri, r_ratio)
            w_emis = torch.where(prev_diffuse, torch.where(
                hit_lid >= 0, 1.0 / fma(r_ratio, r_ratio, torch.ones_like(r_ratio)), 0.0), 1.0)
        elif opt.nee:
            w_emis = torch.where(prev_diffuse, 0.0, 1.0)
        else:
            w_emis = torch.ones_like(prev_cos)
        res = torch.where(emissive[:, None],
                          (thr * albedo) * (param * w_emis)[:, None] + res, res)
        if opt.nee:
            nee_ok = live & hit & (kind == LAMBERTIAN)
            last = i == opt.max_depth - 1
            shadow = []
            for j in range(n_tl):
                salt = 2000 + 37 * i + 7 * j + 1
                u1n, u2n = uniform(seeds, salt), uniform(seeds, salt + 1)
                fidx = sc.light_faces[j]
                su = sqrt(u1n)
                b1, b2 = 1.0 - su, u2n * su
                lp = fma(b2[:, None], sc.e2[fidx], fma(b1[:, None], sc.e1[fidx], sc.v0[fidx]))
                dc = lp - pnt
                d2 = dot3(dc, dc)
                d2s = torch.clamp(d2, min=1e-12)
                dist = sqrt(d2s)
                omega = dc / dist[:, None]
                cos_i = dot3(nrm, omega)
                cos_l = torch.abs(dot3(sc.l_normal[j], omega))
                valid = nee_ok & (cos_i > 0.0) & (cos_l > 1e-7) & (d2 > 1e-12)
                wgt = cos_i * cos_l * sc.l_area[j] / (torch.tensor(math.pi, dtype=F32) * d2s)
                shadow.append((valid, wgt, dist * (1.0 - 1e-3), omega,
                               torch.nonzero(valid).squeeze(1)))
            # Every light's shadow rays in one query: each ray's answer is its own.
            sizes = [idx.numel() for *_, idx in shadow]
            if sum(sizes):
                tn_all = nearest_t(torch.cat([pnt[idx] for *_, idx in shadow]),
                                   torch.cat([omega[idx] for *_, omega, idx in shadow]), sc,
                                   opt.t_min, opt.t_max).split(sizes)
            for j, (valid, wgt, window, omega, idx) in enumerate(shadow):
                vis = torch.zeros_like(valid)
                if idx.numel():
                    tn = tn_all[j]
                    vis[idx] = tn >= window[idx]
                    if record is not None:
                        record("shadow", pnt[idx], omega[idx], torch.minimum(tn, window[idx]))
                valid = valid & vis
                if opt.mis and not last:
                    wgt = wgt / fma(wgt, wgt, torch.ones_like(wgt))
                res = torch.where(valid[:, None],
                                  (thr * albedo * sc.l_emission[j]) * wgt[:, None] + res, res)
        scattered = live & hit & ok & (kind != EMISSIVE)
        thr = torch.where(scattered[:, None], thr * att, thr)
        o = torch.where(scattered[:, None], pnt, o)
        d = torch.where(scattered[:, None], new_dir, d)
        live = scattered
        prev_diffuse = scattered & (kind == LAMBERTIAN)
        if opt.mis:
            nd2 = torch.clamp(dot3(new_dir, new_dir), min=1e-20)
            cos_s = dot3(new_dir, nrm) * torch.rsqrt(nd2)
            prev_cos = torch.where(prev_diffuse, torch.clamp(cos_s, min=0.0), 0.0)
        if opt.rr_depth > 0 and i >= opt.rr_depth:
            u_rr = uniform(seeds, 1000 + i)
            pr = torch.clamp(torch.amax(thr, dim=-1), 0.05, 1.0)
            survive = u_rr < pr
            thr = torch.where((live & survive)[:, None], thr * (1.0 / pr)[:, None], thr)
            live = live & survive
        if not bool(live.any()):
            break
    return res


def render_pixels(sc: Scene, cam: Camera, pixel_ids, frame_seeds, *, width: int, spp: int,
                  opt: Options, precision=F32, record=None, block: int = 1 << 16):
    """The mean over samples 0 .. spp-1 of global pixels `pixel_ids` (int64,
    row-major in a `width`-wide frame), pixel k under frame seed
    frame_seeds[k] (u32 in int64): (P, 3) f32."""
    out = torch.zeros((pixel_ids.numel(), 3), dtype=F32, device=pixel_ids.device)
    for start in range(0, pixel_ids.numel(), block):
        pid = pixel_ids[start:start + block]
        fs = frame_seeds[start:start + block]
        acc = torch.zeros((pid.numel(), 3), dtype=F32, device=pid.device)
        for s in range(spp):
            o, d, seeds = primary_rays(cam, pid, s, fs, width)
            acc += trace(o, d, seeds, sc, opt, precision, record)
        out[start:start + block] = acc / float(spp)
    return out
