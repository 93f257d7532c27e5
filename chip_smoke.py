#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gpu_ray_tracing_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the megakernel from gpu_ray_tracing_tpu_torch/ops/cuda/megakernel.cu
with nvcc, then drives the port's main paths on the card in phases, one JSON
line each:

  1. device       the card, its compute capability and power limit
  2. build        nvcc version, build seconds, the kernel's registers
  3. hash_probe   the kernel's hashes vs ops/rng.py on 1M u32 values: bit-exact;
     sampler_probe  the kernel's stratified (4,4) and Sobol (nbits 5) remaps at
                  pair ids 5-8 on 1M (pixel id, sample) pairs: bit-exact
  4. goldens      backend='cuda' renders vs the committed goldens (mesh_ico,
                  nee_light, nee_mis, many_mis and sobol_base included), at
                  tests/test_goldens.py's decision-flip thresholds; cornell_48x48
                  vs the plain version on the card at parity_check's 1.5% / 1e-3
  5. kernel_vs_plain  One-Weekend 320x180, 4 spp, depth 30: render_cuda vs
                  its plain PyTorch version, flip <= 1% and mean |diff| < 2e-4
  6. main_path    render(one_weekend_scene(0), CameraSettings.default(),
                  1280x720, 16 spp, depth 30, backend='cuda'): 2 warm-up and
                  5 timed frames (CUDA events), launch counts, output checks,
                  and the same frame from the plain version
  7. sphere_bvh   the 487-sphere One-Weekend final scene (a sphere BVH),
                  320x180, 4 spp, depth 50: the walk vs the plain version's
                  scan of the same spheres, flip <= 2% and mean < 2e-3, and
                  vs the brute kernel on the same spheres (timed beside it),
                  flip <= 1% and mean < 2e-4
  8. mesh_vs_plain  a smooth icosphere(4) (5,120 faces) on a ground sphere,
                  320x240, 2 spp, depth 8: flip <= 1% and mean < 2e-4
  9. config3      BASELINE config 3 through render(): the 487-sphere scene,
                  1280x720, 1 spp, depth 50, timed as phase 6 and held to
                  the plain version's frame at flip <= 2% and mean < 2e-3
 10. config4      BASELINE config 4 through render(): a smooth icosphere(6)
                  (81,920 faces) behind its BVH, 640x480, 1 spp, depth 8,
                  held to the plain version at flip <= 1% and mean < 2e-4

 11. nee_vs_plain  the NEE kernel vs its plain version at 1% / 2e-4: _nee_scene
                  (nee+mis, RR 3, sky 0, 320x240, 4 spp, depth 8), the 81-light
                  _many_lights_scene (320x240, 4 spp, depth 4, the plain
                  version's per-(sample, bounce) pick) and the CLI's night scene
                  (2 sphere lights, metal and glass; 320x180, 4 spp, depth 30)
 12. lit_path     `render --scene cornell --nee --mis --sky-intensity 0` at the
                  CLI's defaults through render(): 1280x720, 16 spp, depth 30,
                  2 warm-up and 5 timed frames, the kernel alone timed too, held
                  to the plain frame at 1.5% / 1e-3
 13. sampler_path One-Weekend with sampler='sobol' through render() at the main
                  path's size, timed, held to its plain frame at 1% / 2e-4; and
                  'stratified' at 320x180, 16 spp
 14. bvh_builds   which BVH builder ran (it must be the native one)
 15. adaptive_vs_plain  the adaptive kernel (K1f) vs its plain version, min 4,
                  budget 32, depth 8: One-Weekend 320x180 at tol 0.03 and the
                  Cornell box (nee+mis) 128x96 at tol 0.5, where its tiles
                  stop at different counts; spp maps per tile (<= 1 tile may
                  differ, and some tile must stop before the budget) and
                  images over equal-count tiles at 1% / 2e-4 (Cornell: flip
                  1.5%, its contract in phase 12)
 16. adaptive_resume  at the main path's size (budget 32, tol 0.03, min 8):
                  render() equals four adaptive_progressive_step(8) bit for
                  bit, a fifth changes nothing, and tol 1e6 / min 4 equals the
                  fixed spp=4 frame bit for bit (the prefix property)
 17. adaptive_path  that frame one-shot, timed, with its spp map's mean/min/max,
                  beside the fixed 32-spp frame in the same call, and held to
                  its plain version as phase 15 holds the small frames
 18. progressive_path  16 progressive_step calls at the main path's size: ms a
                  step, the state vs render(spp=16) at atol 1e-5, 16 launches,
                  reset, and two steps of 8 at atol 2e-5
 19. ray_count    the kernel's counters vs the plain version's per pixel, the
                  analytic cases, and at the main path's size rays traced, the
                  kernel with the counter on and off, bounce Mrays/s

Every phase that launches the megakernel gates its launch count on its own
route key (megakernel:brute, :sphere_bvh, :mesh_bvh, suffixed +nee,
+sobol/+stratified, +adaptive and +rays when the launch ran them).  Then
the kernels line (the megakernel once per path: brute, sphere_bvh,
mesh_bvh, mesh_bvh+nee, brute+nee, brute+sobol, brute+adaptive,
mesh_bvh+nee+adaptive, and the two probes), each row with its least time
on the card (`bound_ms`, from the rays its counters measured at that row's
shape), the card's `nvidia-smi` name and power limit, and last
{"ok": true, "device": {...}}.  A failed gate exits nonzero before that line.
Without a CUDA device, or outside the repository, it exits nonzero and prints
no result.  It needs no network and starts no process that outlives it.

    python3 chip_smoke.py --main-path-only

runs phases 1 and 2, then times phase 6's frame over 20 frames and prints
one JSON line.  Copied into another checkout and run there, it times that
checkout's package: run two checkouts in turns (A, B, B, A) within one
machine to compare two builds of the kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
KERNEL_SOURCE = "gpu_ray_tracing_tpu_torch/ops/cuda/megakernel.cu"
REPLACES = "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1420"
# The probes launch the kernel's hash and sampler functions alone: the
# draws of `_kernel` (megakernel.py:1509) and its sampler remaps (:1517).
PROBE_REPLACES = {"hash_probe": "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1509",
                  "sampler_probe": "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1517"}
# The JAX tests' BASE_CAMERA (tests/test_api.py:22-29), and the mesh
# camera of benchmarks/parity_check.py:96-99 and run.py:290-292.
BASE_CAMERA = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0],
                   vup=[0.0, 1.0, 0.0], field_of_view=60.0, defocus_angle=0.0,
                   focus_distance=2.0)
MESH_CAMERA = dict(BASE_CAMERA, look_from=[0.0, 1.2, 3.0], look_at=[0.0, 0.7, 0.0])
# The CLI's night camera (gpu_ray_tracing_tpu/cli.py:142-148).
NIGHT_CAMERA = dict(look_from=[0.0, 1.3, 4.0], look_at=[0.0, 0.7, -1.0], vup=[0.0, 1.0, 0.0],
                    field_of_view=45.0, defocus_angle=0.0, focus_distance=10.0)

# The least time of a kernel row, from the H100 SXM's peak rates at 700 W:
# FP32 outside the tensor cores, and HBM.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# FP32 operations of one primitive test, counted from the JAX kernel's code
# (a fused multiply-add as 2; compares and selects not counted):
# `_sphere_root` (megakernel.py:530): h 6, cc 8, disc 3, sqrt(max) 2, roots 4;
# the slab test of `_traverse_bvh` (:296-318): 12 for the slabs, 10 min/max,
# the t_min clamp 1; `_tri_intersect` (:439): pvec 9, det 5, 1/det 1, tvec 3,
# u 6, qvec 9, v 6, t 6.
SPHERE_FLOPS = 23
BOX_FLOPS = 23
TRI_FLOPS = 45

failures: list[str] = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gate(phase: str, ok: bool, what: str) -> None:
    if not ok:
        failures.append(f"{phase}: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_instances(report: str) -> list[str]:
    """`-Xptxas -v`, one line per kernel instance: its mangled name, then
    its stack, spills, registers and shared memory."""
    out, name, frame = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "stack frame" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            out.append(f"{name}: {frame}; {ln.split(':', 1)[1].strip()}")
            name = None
    return out


def cuda_ms(fn, repeats: int) -> tuple[float, object]:
    """Mean device milliseconds of `repeats` calls of fn (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def against_plain(T, mk, run, scene, cam, kw, flip: float, mean_tol: float,
                  warmup: int = 1, plain=None) -> dict:
    """Reset the launch counts, call `run` (a kernel path) `warmup` times
    and 5 timed times (CUDA events), read the counts, then render the same
    frame with the plain version once (render_reference(scene, cam, **kw);
    its launches do not count) unless `plain` gives (image, ms) already.
    The kernel's image is matched to the plain one at (flip, mean_tol)."""
    mk.LAUNCHES.clear()
    for _ in range(warmup):
        run()
    ms, img = cuda_ms(run, 5)
    launches = dict(mk.LAUNCHES)
    if plain is None:
        plain_ms, plain_img = cuda_ms(lambda: mk.render_reference(scene, cam, **kw), 1)
    else:
        plain_img, plain_ms = plain
    return dict(img=img, plain_img=plain_img, ms=ms, plain_ms=plain_ms,
                launches=launches, finite=bool(torch.isfinite(img).all()),
                mean=float(img.mean()), match=T.images_match(img, plain_img, flip, mean_tol))


def time_main_path(T, mk, repeats: int) -> tuple[float, torch.Tensor, dict]:
    """The main path through render(): One-Weekend at 1280x720, 16 spp,
    depth 30, backend='cuda'; launch counts reset, 2 warm-up frames, then
    the mean ms of `repeats` frames.  Returns (ms, image, launches)."""
    cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, backend="cuda")
    scene, cam = T.one_weekend_scene(0), T.CameraSettings.default()
    mk.LAUNCHES.clear()
    for _ in range(2):
        T.render(scene, cam, cfg, frame_seed=7)
    ms, img = cuda_ms(lambda: T.render(scene, cam, cfg, frame_seed=7), repeats)
    return ms, img, dict(mk.LAUNCHES)


def adaptive_match(T, img, smap, plain_img, plain_map, flip: float, mean_tol: float):
    """An adaptive frame against its plain version: the count of (32 x 128)
    tiles whose spp differs, and the images matched over the pixels of
    equal-count tiles."""
    tiles_differ = int((smap[::32, ::128] != plain_map[::32, ::128]).sum())
    same = smap == plain_map
    return tiles_differ, T.images_match(img[same][None], plain_img[same][None], flip, mean_tol)


def _mean_leaf(bvh) -> float:
    counts = bvh.leaf_count[bvh.leaf_start >= 0].double()
    return float(counts.mean())


def ray_flops(sc) -> float:
    """FP32 operations of the primitive tests one ray needs on a scene's
    route: every active sphere on the brute scan; on a BVH one root-box test
    plus one leaf of the tree's mean size (a lower bound)."""
    if sc.sphere_bvh is not None:
        flops = BOX_FLOPS + _mean_leaf(sc.sphere_bvh) * SPHERE_FLOPS
    else:
        flops = float((sc.spheres.radii > 0).sum()) * SPHERE_FLOPS
    if sc.mesh is not None:
        flops += BOX_FLOPS + _mean_leaf(sc.bvh) * TRI_FLOPS
    return flops


def bound(T, mk, sc, rays_traced: float, out_bytes: int) -> dict:
    """bound_ms of a megakernel row: the larger of its FP32 work (rays
    traced x ray_flops) over FP32_PEAK and its bytes (the scene's arrays and
    the camera read once, `out_bytes` written once) over HBM_RATE.  On a
    BVH route the work is a lower bound (one box and one leaf a ray)."""
    sc = T.as_scene(sc)
    lower = sc.sphere_bvh is not None or sc.mesh is not None
    in_bytes = sum(t.numel() * t.element_size() for t in mk.dataclass_tensors(sc)) + 96
    t_ops = rays_traced * ray_flops(sc) / FP32_PEAK * 1e3
    t_bytes = (in_bytes + out_bytes) / HBM_RATE * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                else "bytes", rays_traced=rays_traced, bound_is_lower_bound=lower,
                library_ms=None)


def lit_scenes(T) -> dict:
    """The lit scenes of benchmarks/parity_check.py (_nee_scene,
    _many_lights_scene) and the CLI's night scene (cli.py:116-123)."""
    em, lam = T.EMISSIVE, T.LAMBERTIAN
    glow = T.transform_mesh(T.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=em, mat_param=3.0),
                            0.5, (-0.8, 1.8, -2.0))
    return {
        "nee": T.make_scene(T.make_spheres([
            ((0, -1000.0, 0), 1000.0, lam, (0.7, 0.7, 0.7), 0.0),
            ((0.0, 2.0, -2.0), 0.3, em, (1.0, 0.9, 0.7), 20.0),
            ((0.8, 0.4, -1.5), 0.4, lam, (0.3, 0.5, 0.8), 0.0)])),
        "many_lights": T.make_scene(T.make_spheres([
            ((0.0, -1000.0, 0.0), 1000.0, lam, (0.7, 0.7, 0.7), 0.0),
            ((2.0, 2.2, -2.0), 0.4, em, (1.0, 0.9, 0.7), 4.0)]), glow),
        "night": T.make_scene(T.make_spheres([
            ((0, -1000.0, 0), 1000.0, lam, (0.65, 0.65, 0.65), 0.0),
            ((0.0, 2.6, -1.0), 0.7, em, (1.0, 0.85, 0.6), 8.0),
            ((-2.4, 0.5, -0.5), 0.5, T.METAL, (0.9, 0.9, 0.95), 0.03),
            ((2.0, 0.5, -1.0), 0.5, T.DIELECTRIC, (1, 1, 1), 1.5),
            ((0.0, 0.5, -1.0), 0.5, lam, (0.2, 0.4, 0.8), 0.0),
            ((-4.5, 1.2, -4.0), 0.8, em, (0.4, 0.6, 1.0), 6.0)])),
    }


def render_kw(cfg, seed: int) -> dict:
    """render_cuda/render_reference keywords of a RenderConfig frame."""
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                t_min=cfg.t_min, frame_seed=seed, sky_intensity=cfg.sky_intensity,
                russian_roulette_depth=cfg.russian_roulette_depth, nee=cfg.nee,
                mis=cfg.mis, sampler_spec=cfg.sampler_spec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--main-path-only", action="store_true",
                    help="build, time the main path over 20 frames, print one JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import gpu_ray_tracing_tpu_torch as T
    from gpu_ray_tracing_tpu_torch.ops.cuda import build
    from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability (9, 0) for sm_90a, got {cap}",
              file=sys.stderr)
        return 1

    # 2. build
    t0 = time.perf_counter()
    build.load()
    info = build.build_info()
    emit({"phase": "build", "nvcc": info.nvcc_version, "compiled": info.compiled,
          "nvcc_seconds": info.seconds, "load_seconds": time.perf_counter() - t0,
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas_instances(info.ptxas_report)})
    gate("build", info.compiled, "the library was not compiled from the checkout")
    if args.main_path_only:
        ms, img, launches = time_main_path(T, mk, 20)
        emit({"phase": "main_path_only", "repo": REPO, "ms_per_frame": ms, "repeats": 20,
              "mean": float(img.mean()), "launches": launches, "card": smi})
        return 0

    # 3. hash probe
    values = np.random.default_rng(20261016).integers(0, 2**32, 1 << 20, dtype=np.uint64)
    values = values.astype(np.uint32)
    values[:2] = (0, 2**32 - 1)
    vt = torch.from_numpy(values.view(np.int32).copy()).to(dev)
    salts = [1, 2, 3, 4, 16, 17, 18, 1000]
    got = mk.hash_probe(vt, salts, 5, 99)
    want = mk.hash_probe_reference(vt, salts, 5, 99)
    exact = {k: bool(torch.equal(got[k], want[k])) for k in want}
    hash_ms, _ = cuda_ms(lambda: mk.hash_probe(vt, salts, 5, 99), 5)
    hash_plain_ms, _ = cuda_ms(lambda: mk.hash_probe_reference(vt, salts, 5, 99), 1)
    emit({"phase": "hash_probe", "n": int(values.size), "salts": salts, "bit_exact": exact,
          "ms": hash_ms, "plain_ms": hash_plain_ms})
    gate("hash_probe", all(exact.values()), f"hashes differ: {exact}")
    probes = {"hash_probe": dict(launches=mk.LAUNCHES["hash_probe"], ms=hash_ms,
                                 plain_ms=hash_plain_ms, max_abs_err=0.0 if all(exact.values())
                                 else float("nan"))}
    # The sampler's remaps at pair ids 5-8 (AA, scatter, lens, NEE light 0)
    # on (pixel id, sample) pairs from the same values.
    samples = torch.from_numpy(np.roll(values, 1).view(np.int32).copy()).to(dev)
    pairs = [5, 6, 7, 8]
    mk.LAUNCHES.clear()
    errs, sampler_ms, sampler_plain_ms = [], 0.0, 0.0
    for spec in (("stratified", 4, 4), ("sobol", 5)):
        got = mk.sampler_probe(vt, samples, 99, spec, pairs)
        want = mk.sampler_probe_reference(vt, samples, 99, spec, pairs)
        exact = all(torch.equal(got[k], want[k]) for k in want)
        errs.append(max(float((got[k] - want[k]).abs().max()) for k in want))
        t_k, _ = cuda_ms(lambda: mk.sampler_probe(vt, samples, 99, spec, pairs), 5)
        t_p, _ = cuda_ms(lambda: mk.sampler_probe_reference(vt, samples, 99, spec, pairs), 1)
        sampler_ms, sampler_plain_ms = sampler_ms + t_k, sampler_plain_ms + t_p
        emit({"phase": "sampler_probe", "spec": list(spec), "n": int(values.size),
              "pairs": pairs, "bit_exact": exact, "ms": t_k, "plain_ms": t_p})
        gate("sampler_probe", exact, f"{spec}: the kernel's remaps differ from ops/rng.py")
    probes["sampler_probe"] = dict(launches=mk.LAUNCHES["sampler_probe"], ms=sampler_ms,
                                   plain_ms=sampler_plain_ms, max_abs_err=max(errs))

    # 4. goldens, through the public entry point with backend='cuda'
    base_cam = T.CameraSettings.make(**BASE_CAMERA)
    mesh_cam = T.CameraSettings.make(**MESH_CAMERA)
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])

    def mesh_scene(subdivisions: int):
        """benchmarks/parity_check.py::_mesh_scene, and run.py's config 4
        at subdivisions=6."""
        ico = T.icosphere(subdivisions, albedo=(0.75, 0.6, 0.45), smooth=True)
        return T.make_scene(ground, T.transform_mesh(ico, 0.8, (0.0, 0.8, 0.0)))

    lit = lit_scenes(T)
    cases = [
        ("base_normal_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=1, integrator="normal"), 0, 0.002, 1e-5),
        ("base_path_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=4, max_depth=8), 42, 0.005, 1e-4),
        ("one_weekend_48x27.npy", T.one_weekend_scene(0), T.CameraSettings.default(),
         dict(width=48, height=27, spp=2, max_depth=6), 3, 0.01, 2e-4),
        ("mesh_ico_48x36.npy", mesh_scene(2), mesh_cam,
         dict(width=48, height=36, spp=2, max_depth=4), 11, 0.005, 1e-4),
        ("nee_light_48x36.npy", lit["nee"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=6, sky_intensity=0.0, nee=True,
              russian_roulette_depth=3), 9, 0.005, 1e-4),
        ("nee_mis_48x36.npy", lit["nee"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=6, sky_intensity=0.0, nee=True, mis=True,
              russian_roulette_depth=3), 9, 0.005, 1e-4),
        ("many_mis_48x36.npy", lit["many_lights"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=4, sky_intensity=0.0, nee=True,
              mis=True), 17, 0.005, 1e-4),
        ("sobol_base_48x32.npy", T.base_scene(), base_cam,
         dict(width=48, height=32, spp=4, max_depth=6, sampler="sobol"), 5, 0.005, 1e-4),
    ]
    for golden, scene, cam, cfg_kw, seed, flip, mean in cases:
        cfg = T.RenderConfig(backend="cuda", **cfg_kw)
        img = T.render(scene, cam, cfg, frame_seed=seed)
        torch.cuda.synchronize()
        m = T.images_match(img, np.load(os.path.join(GOLDENS, golden)), flip, mean)
        emit({"phase": "goldens", "golden": golden, "flip_frac": m.flip_frac,
              "flip_limit": flip, "mean_abs": m.mean_abs, "mean_limit": mean,
              "max_abs": m.max_abs, "ok": m.ok})
        gate("goldens", m.ok, f"{golden}: {m}")
    # cornell_48x48 is chaotic across platforms (its glass sphere is a lens):
    # held to the plain version on this card at parity_check's contract.
    cfg = T.RenderConfig(width=48, height=48, spp=4, max_depth=6, sky_intensity=0.0,
                         nee=True, mis=True, backend="cuda")
    img = T.render(T.cornell_box_scene(), T.cornell_camera(), cfg, frame_seed=13)
    plain = mk.render_reference(T.cornell_box_scene().to(dev),
                                T.derive_camera(T.cornell_camera(), 48, 48).to(dev),
                                **render_kw(cfg, 13))
    m = T.images_match(img, plain, 0.015, 1e-3)
    g = T.images_match(img, np.load(os.path.join(GOLDENS, "cornell_48x48.npy")), 0.005, 1e-4)
    emit({"phase": "goldens", "golden": "cornell_48x48.npy", "against": "render_reference",
          "flip_frac": m.flip_frac, "flip_limit": 0.015, "mean_abs": m.mean_abs,
          "mean_limit": 1e-3, "max_abs": m.max_abs, "ok": m.ok,
          "vs_golden_flip_frac": g.flip_frac, "vs_golden_mean_abs": g.mean_abs})
    gate("goldens", m.ok, f"cornell_48x48 vs plain: {m}")

    # 5. kernel vs plain on the card, same inputs
    scene = T.one_weekend_scene(0, device=dev)
    w5, h5 = 320, 180
    cam5 = T.derive_camera(T.CameraSettings.default(), w5, h5).to(dev)
    kw5 = dict(width=w5, height=h5, spp=4, max_depth=30, t_min=1e-3, frame_seed=3)
    mk.render_cuda(scene, cam5, **kw5)
    mk.render_reference(scene, cam5, **kw5)
    plain5_a, plain = cuda_ms(lambda: mk.render_reference(scene, cam5, **kw5), 1)
    kernel5_ms, kern = cuda_ms(lambda: mk.render_cuda(scene, cam5, **kw5), 5)
    plain5_b, _ = cuda_ms(lambda: mk.render_reference(scene, cam5, **kw5), 1)
    m5 = T.images_match(kern, plain, 0.01, 2e-4)
    emit({"phase": "kernel_vs_plain", "size": [w5, h5], "spp": 4, "max_depth": 30,
          "flip_frac": m5.flip_frac, "mean_abs": m5.mean_abs, "max_abs": m5.max_abs,
          "kernel_ms": kernel5_ms, "plain_ms": (plain5_a + plain5_b) / 2,
          "card": smi, "ok": m5.ok})
    gate("kernel_vs_plain", m5.ok, str(m5))

    # 6. the main path at full size, through the public entry point
    w, h, spp = 1280, 720, 16
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=30, backend="cuda")
    main_scene, main_cam = T.one_weekend_scene(0), T.CameraSettings.default()
    frame_ms, img, launches = time_main_path(T, mk, 5)
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    shape_ok = tuple(img.shape) == (h, w, 3)
    # The plain version of the same frame (its launches do not count).
    cam6 = T.derive_camera(main_cam, w, h).to(dev)
    plain_ms, plain_img = cuda_ms(lambda: mk.render_reference(
        main_scene.to(dev), cam6, width=w, height=h, spp=spp, max_depth=30,
        t_min=cfg.t_min, frame_seed=7), 1)
    m6 = T.images_match(img, plain_img, 0.01, 2e-4)
    emit({"phase": "main_path", "size": [w, h], "spp": spp, "max_depth": 30,
          "shape": list(img.shape), "finite": finite, "mean": mean,
          "launches": launches, "ms_per_frame": frame_ms,
          "primary_mrays_per_s": w * h * spp / (frame_ms * 1e3),
          "plain_ms": plain_ms, "vs_plain_flip_frac": m6.flip_frac,
          "vs_plain_mean_abs": m6.mean_abs, "vs_plain_max_abs": m6.max_abs,
          "card": smi})
    gate("main_path", shape_ok and finite and 0.0 < mean < 1.0,
         f"shape {tuple(img.shape)}, finite {finite}, mean {mean}")
    gate("main_path", launches == {"megakernel:brute": 7},
         f"expected 7 brute-scan megakernel launches, counted {launches}")
    gate("main_path", m6.ok, f"vs plain: {m6}")

    # 7. the sphere BVH against the plain scan of the same spheres
    final = T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11))
    gate("sphere_bvh", final.sphere_bvh is not None, "make_scene built no sphere BVH")
    final_dev = final.to(dev)
    brute_dev = dataclasses.replace(final_dev, sphere_bvh=None)
    w7, h7 = 320, 180
    cam7 = T.derive_camera(T.CameraSettings.default(), w7, h7).to(dev)
    kw7 = dict(width=w7, height=h7, spp=4, max_depth=50, t_min=1e-3, frame_seed=5)
    walk = against_plain(T, mk, lambda: mk.render_cuda(final_dev, cam7, **kw7),
                         final_dev, cam7, kw7, 0.02, 2e-3)
    brute = against_plain(T, mk, lambda: mk.render_cuda(brute_dev, cam7, **kw7),
                          final_dev, cam7, kw7, 0.01, 2e-4,
                          plain=(walk["plain_img"], walk["plain_ms"]))
    m7, m7b = walk["match"], brute["match"]
    # The walk adds no flips over the scan: held to the brute kernel on the
    # same spheres at the standard contract.
    m7w = T.images_match(walk["img"], brute["img"], 0.01, 2e-4)
    emit({"phase": "sphere_bvh", "spheres": final.spheres.count,
          "bvh_nodes": final.sphere_bvh.num_nodes, "size": [w7, h7], "spp": 4,
          "max_depth": 50, "flip_frac": m7.flip_frac, "mean_abs": m7.mean_abs,
          "max_abs": m7.max_abs, "bvh_kernel_ms": walk["ms"], "brute_kernel_ms": brute["ms"],
          "plain_ms": walk["plain_ms"], "brute_vs_plain_flip_frac": m7b.flip_frac,
          "brute_vs_plain_mean_abs": m7b.mean_abs, "walk_vs_brute_flip_frac": m7w.flip_frac,
          "walk_vs_brute_mean_abs": m7w.mean_abs, "walk_vs_brute_max_abs": m7w.max_abs,
          "launches": {"walk": walk["launches"], "brute": brute["launches"]},
          "card": smi, "ok": m7.ok and m7w.ok})
    gate("sphere_bvh", m7.ok, f"walk vs plain: {m7}")
    gate("sphere_bvh", m7w.ok, f"walk vs brute kernel: {m7w}")
    gate("sphere_bvh", walk["launches"] == {"megakernel:sphere_bvh": 6},
         f"expected 6 sphere-BVH launches, counted {walk['launches']}")
    gate("sphere_bvh", brute["launches"] == {"megakernel:brute": 6},
         f"expected 6 brute-scan launches, counted {brute['launches']}")

    # 8. the mesh kernel against the plain version
    ico4 = mesh_scene(4).to(dev)
    w8, h8 = 320, 240
    cam8 = T.derive_camera(mesh_cam, w8, h8).to(dev)
    kw8 = dict(width=w8, height=h8, spp=2, max_depth=8, t_min=1e-3, frame_seed=8)
    r8 = against_plain(T, mk, lambda: mk.render_cuda(ico4, cam8, **kw8),
                       ico4, cam8, kw8, 0.01, 2e-4)
    m8 = r8["match"]
    emit({"phase": "mesh_vs_plain", "triangles": ico4.mesh.num_triangles,
          "bvh_nodes": ico4.bvh.num_nodes, "size": [w8, h8], "spp": 2, "max_depth": 8,
          "flip_frac": m8.flip_frac, "mean_abs": m8.mean_abs, "max_abs": m8.max_abs,
          "kernel_ms": r8["ms"], "plain_ms": r8["plain_ms"], "launches": r8["launches"],
          "card": smi, "ok": m8.ok})
    gate("mesh_vs_plain", m8.ok, str(m8))
    gate("mesh_vs_plain", r8["launches"] == {"megakernel:mesh_bvh": 6},
         f"expected 6 mesh-BVH launches, counted {r8['launches']}")

    # 9-10. BASELINE configs 3 and 4 at full size, through the public entry
    # point (2 warm-up and 5 timed frames), each gated against the plain
    # version of the same frame.
    paths = {}
    for phase, route, scene, cam, cfg, seed, flip, mean_tol in (
        ("config3", "sphere_bvh", final, T.CameraSettings.default(),
         T.RenderConfig(width=1280, height=720, spp=1, max_depth=50, backend="cuda"), 3,
         0.02, 2e-3),
        ("config4", "mesh_bvh", mesh_scene(6), mesh_cam,
         T.RenderConfig(width=640, height=480, spp=1, max_depth=8, backend="cuda"), 4,
         0.01, 2e-4),
    ):
        kw = dict(width=cfg.width, height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                  t_min=cfg.t_min, frame_seed=seed)
        r = against_plain(
            T, mk, lambda: T.render(scene, cam, cfg, frame_seed=seed), scene.to(dev),
            T.derive_camera(cam, cfg.width, cfg.height).to(dev), kw, flip, mean_tol, warmup=2)
        m = r["match"]
        paths[phase] = dict(r, route=route, inputs=(scene.to(dev), T.derive_camera(
            cam, cfg.width, cfg.height).to(dev), kw))
        emit({"phase": phase, "size": [cfg.width, cfg.height], "spp": cfg.spp,
              "max_depth": cfg.max_depth, "spheres": scene.spheres.count,
              "triangles": 0 if scene.mesh is None else scene.mesh.num_triangles,
              "finite": r["finite"], "mean": r["mean"], "launches": r["launches"],
              "ms_per_frame": r["ms"],
              "primary_mrays_per_s": cfg.width * cfg.height * cfg.spp / (r["ms"] * 1e3),
              "plain_ms": r["plain_ms"], "vs_plain_flip_frac": m.flip_frac,
              "vs_plain_mean_abs": m.mean_abs, "vs_plain_max_abs": m.max_abs,
              "vs_plain_limits": [flip, mean_tol], "card": smi, "ok": m.ok})
        gate(phase, r["finite"] and 0.0 < r["mean"] < 1.0,
             f"finite {r['finite']}, mean {r['mean']}")
        gate(phase, r["launches"] == {"megakernel:" + route: 7},
             f"expected 7 {route} megakernel launches, counted {r['launches']}")
        gate(phase, m.ok, f"vs plain: {m}")

    # 11. the NEE kernel against its plain version, each case on its own key
    nee_runs = {}
    for case, route, scene, cam_kw, cfg in (
        ("nee", "brute+nee", lit["nee"], BASE_CAMERA,
         T.RenderConfig(width=320, height=240, spp=4, max_depth=8, sky_intensity=0.0,
                        nee=True, mis=True, russian_roulette_depth=3)),
        ("many_lights", "mesh_bvh+nee", lit["many_lights"], BASE_CAMERA,
         T.RenderConfig(width=320, height=240, spp=4, max_depth=4, sky_intensity=0.0,
                        nee=True, mis=True)),
        ("night", "brute+nee", lit["night"], NIGHT_CAMERA,
         T.RenderConfig(width=320, height=180, spp=4, max_depth=30, nee=True, mis=True)),
    ):
        sc = scene.to(dev)
        cam = T.derive_camera(T.CameraSettings.make(**cam_kw), cfg.width, cfg.height).to(dev)
        kw = render_kw(cfg, 3)
        r = against_plain(T, mk, lambda: mk.render_cuda(sc, cam, **kw), sc, cam, kw,
                          0.01, 2e-4)
        m = r["match"]
        nee_runs[case] = dict(r, route=route, inputs=(sc, cam, kw))
        emit({"phase": "nee_vs_plain", "case": case, "size": [cfg.width, cfg.height],
              "spp": cfg.spp, "max_depth": cfg.max_depth, "lights": [
                  0 if sc.lights is None else sc.lights.count,
                  0 if sc.tri_lights is None else sc.tri_lights.count],
              "flip_frac": m.flip_frac, "mean_abs": m.mean_abs, "max_abs": m.max_abs,
              "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "launches": r["launches"],
              "card": smi, "ok": m.ok})
        gate("nee_vs_plain", m.ok, f"{case}: {m}")
        gate("nee_vs_plain", r["launches"] == {"megakernel:" + route: 6},
             f"{case}: expected 6 {route} launches, counted {r['launches']}")

    # 12-13. the lit path and the samplers at full frame size, through the
    # public entry point, each held to the plain version of the same frame.
    for phase, route, scene, cam, cfg, seed, flip, mean_tol in (
        ("lit_path", "mesh_bvh+nee", T.cornell_box_scene(), T.cornell_camera(),
         T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, sky_intensity=0.0,
                        nee=True, mis=True, backend="cuda"), 0, 0.015, 1e-3),
        ("sampler_path", "brute+sobol", T.one_weekend_scene(0), T.CameraSettings.default(),
         T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, sampler="sobol",
                        backend="cuda"), 7, 0.01, 2e-4),
        ("sampler_path", "brute+stratified", T.one_weekend_scene(0),
         T.CameraSettings.default(),
         T.RenderConfig(width=320, height=180, spp=16, max_depth=30, sampler="stratified",
                        backend="cuda"), 7, 0.01, 2e-4),
    ):
        sc_dev = scene.to(dev)
        cam_dev = T.derive_camera(cam, cfg.width, cfg.height).to(dev)
        kw = render_kw(cfg, seed)
        r = against_plain(T, mk, lambda: T.render(scene, cam, cfg, frame_seed=seed), sc_dev,
                          cam_dev, kw, flip, mean_tol, warmup=2)
        # The kernel alone, scene and camera already on the card: short
        # frames are host-bound in render() (PERF.md section 5).
        kernel_ms, _ = cuda_ms(lambda: mk.render_cuda(sc_dev, cam_dev, **kw), 5)
        m = r["match"]
        paths[route] = dict(r, route=route, kernel_ms=kernel_ms, inputs=(sc_dev, cam_dev, kw))
        emit({"phase": phase, "route": route, "size": [cfg.width, cfg.height],
              "spp": cfg.spp, "max_depth": cfg.max_depth, "sampler": cfg.sampler,
              "nee": cfg.nee, "mis": cfg.mis, "finite": r["finite"], "mean": r["mean"],
              "launches": r["launches"], "ms_per_frame": r["ms"], "kernel_ms": kernel_ms,
              "primary_mrays_per_s": cfg.width * cfg.height * cfg.spp / (r["ms"] * 1e3),
              "plain_ms": r["plain_ms"], "vs_plain_flip_frac": m.flip_frac,
              "vs_plain_mean_abs": m.mean_abs, "vs_plain_max_abs": m.max_abs,
              "vs_plain_limits": [flip, mean_tol], "card": smi, "ok": m.ok})
        gate(phase, r["finite"] and 0.0 < r["mean"] < 1.0,
             f"{route}: finite {r['finite']}, mean {r['mean']}")
        gate(phase, r["launches"] == {"megakernel:" + route: 7},
             f"expected 7 {route} megakernel launches, counted {r['launches']}")
        gate(phase, m.ok, f"{route} vs plain: {m}")

    # 14. the BVH builder that ran: the native one, as in the CPU tests
    from gpu_ray_tracing_tpu_torch.ops import bvh as bvh_ops
    builds = dict(bvh_ops.BUILDS)
    emit({"phase": "bvh_builds", "builds": builds})
    gate("bvh_builds", builds.get("native", 0) > 0 and builds.get("numpy", 0) == 0,
         f"expected only native BVH builds, got {builds}")

    # 15. the adaptive kernel (K1f) against its plain version
    adaptive_runs = {}
    # Each image is held to 1% / 2e-4, the chaotic Cornell box at the flip
    # of its contract in phase 12 (1.5%: a pixel flips when any of its
    # samples does).  The Cornell box is noisy enough that at tol 0.03 every
    # tile takes the budget; at 0.5 its three tiles stop at three counts.
    for case, route, scene, cam_s, w, h, tol, extra, flip in (
        ("one_weekend", "brute+adaptive", T.one_weekend_scene(0), T.CameraSettings.default(),
         320, 180, 0.03, {}, 0.01),
        ("cornell", "mesh_bvh+nee+adaptive", T.cornell_box_scene(), T.cornell_camera(), 128, 96,
         0.5, dict(nee=True, mis=True, sky_intensity=0.0), 0.015),
    ):
        sc = scene.to(dev)
        cam = T.derive_camera(cam_s, w, h).to(dev)
        kw = dict(width=w, height=h, spp=32, max_depth=8, t_min=1e-3, frame_seed=3,
                  adaptive_tol=tol, adaptive_min_spp=4, return_spp_map=True, **extra)
        mk.LAUNCHES.clear()
        mk.render_cuda(sc, cam, **kw)
        k_ms, (img, smap) = cuda_ms(lambda: mk.render_cuda(sc, cam, **kw), 5)
        ad_l = dict(mk.LAUNCHES)
        p_ms, (pimg, pmap) = cuda_ms(lambda: mk.render_reference(sc, cam, **kw), 1)
        tiles_differ, mm = adaptive_match(T, img, smap, pimg, pmap, flip, 2e-4)
        early = bool(smap.min() < smap.max())
        rays = mk.render_cuda(sc, cam, **{**kw, "return_spp_map": False},
                              return_ray_count=True)[1]
        # Bytes: the image and spp map written, the six state planes read
        # and written.
        adaptive_runs[case] = dict(route=route, launches=ad_l, ms=k_ms, plain_ms=p_ms,
                                   match=mm, scene=sc, rays=float(rays.double().sum()),
                                   out_bytes=(3 + 1 + 2 * 6) * 4 * w * h)
        emit({"phase": "adaptive_vs_plain", "case": case, "route": route, "size": [w, h],
              "budget": 32, "max_depth": 8, "tol": tol, "min_spp": 4,
              "tiles": int(smap[::32, ::128].numel()), "tiles_differ": tiles_differ,
              "tile_spp": smap[::32, ::128].flatten().tolist(),
              "spp_mean": float(smap.mean()), "spp_min": float(smap.min()),
              "spp_max": float(smap.max()), "flip_frac": mm.flip_frac,
              "mean_abs": mm.mean_abs, "max_abs": mm.max_abs, "limits": [flip, 2e-4],
              "kernel_ms": k_ms,
              "plain_ms": p_ms, "launches": ad_l, "card": smi,
              "ok": mm.ok and tiles_differ <= 1 and early})
        gate("adaptive_vs_plain", tiles_differ <= 1, f"{case}: {tiles_differ} tiles differ")
        gate("adaptive_vs_plain", mm.ok, f"{case}: {mm}")
        gate("adaptive_vs_plain", early, f"{case}: no tile stopped before the budget")
        gate("adaptive_vs_plain", ad_l == {"megakernel:" + route: 6},
             f"{case}: expected 6 {route} launches, counted {ad_l}")

    # 16. adaptive resume at the main path's size, bit for bit
    ad_cfg = T.RenderConfig(width=1280, height=720, spp=32, max_depth=30, adaptive_tol=0.03,
                            adaptive_min_spp=8)
    one = T.render(main_scene, main_cam, ad_cfg, frame_seed=7)
    st = T.init_adaptive_accum(720, 1280, device=dev)
    for _ in range(4):
        st = T.adaptive_progressive_step(st, main_scene, main_cam, ad_cfg, frame_seed=7,
                                         spp_per_step=8)
    resume_exact = bool(torch.equal(st.image, one))
    st5 = T.adaptive_progressive_step(st, main_scene, main_cam, ad_cfg, frame_seed=7,
                                      spp_per_step=8)
    fifth_noop = bool(torch.equal(st5.count, st.count) and torch.equal(st5.image, one))
    wide = T.render(main_scene, main_cam, dataclasses.replace(
        ad_cfg, adaptive_tol=1e6, adaptive_min_spp=4), frame_seed=7)
    fixed4 = T.render(main_scene, main_cam, dataclasses.replace(ad_cfg, spp=4, adaptive_tol=0.0),
                      frame_seed=7)
    prefix_exact = bool(torch.equal(wide, fixed4))
    emit({"phase": "adaptive_resume", "size": [1280, 720], "budget": 32, "max_depth": 30,
          "tol": 0.03, "min_spp": 8, "resume_equals_one_shot": resume_exact,
          "fifth_step_noop": fifth_noop, "prefix_equals_fixed_spp4": prefix_exact,
          "spp_min": float(st.count.min()), "spp_max": float(st.count.max()),
          "finite": bool(torch.isfinite(one).all())})
    gate("adaptive_resume", resume_exact, "4 chunked steps differ from the one-shot render")
    gate("adaptive_resume", fifth_noop, "a fifth step changed the state")
    gate("adaptive_resume", prefix_exact, "tol 1e6 / min 4 differs from the fixed spp=4 frame")

    # 17. the adaptive main path, timed beside the fixed 32-spp frame
    fixed32 = dataclasses.replace(ad_cfg, adaptive_tol=0.0)
    mk.LAUNCHES.clear()
    for _ in range(2):
        T.render(main_scene, main_cam, ad_cfg, frame_seed=7)
    ad_ms, ad_img = cuda_ms(lambda: T.render(main_scene, main_cam, ad_cfg, frame_seed=7), 5)
    ad_launches = dict(mk.LAUNCHES)
    T.render(main_scene, main_cam, fixed32, frame_seed=7)
    fx_ms, fx_img = cuda_ms(lambda: T.render(main_scene, main_cam, fixed32, frame_seed=7), 5)
    main_dev = main_scene.to(dev)
    ad_kw = dict(width=1280, height=720, spp=32, max_depth=30, t_min=ad_cfg.t_min, frame_seed=7,
                 adaptive_tol=0.03, adaptive_min_spp=8, return_spp_map=True)
    k_img, smap = mk.render_cuda(main_dev, cam6, **ad_kw)
    # The plain version of the same frame (its launches do not count).
    ad_plain_ms, (p_img, p_map) = cuda_ms(lambda: mk.render_reference(main_dev, cam6, **ad_kw), 1)
    ad_tiles_differ, m17 = adaptive_match(T, k_img, smap, p_img, p_map, 0.01, 2e-4)
    ad_rays = T.count_traced_rays(main_scene, main_cam, ad_cfg, frame_seed=7)["rays_traced"]
    spp_mean = float(smap.mean())
    rel = float((ad_img - fx_img).abs().mean() / fx_img.mean())
    emit({"phase": "adaptive_path", "size": [1280, 720], "budget": 32, "max_depth": 30,
          "tol": 0.03, "min_spp": 8, "ms_per_frame": ad_ms, "spp_mean": spp_mean,
          "spp_min": float(smap.min()), "spp_max": float(smap.max()),
          "ms_per_sample_taken": ad_ms / spp_mean, "fixed32_ms_per_frame": fx_ms,
          "fixed32_ms_per_sample": fx_ms / 32, "rays_traced": ad_rays,
          "rel_mean_diff_vs_fixed32": rel, "launches": ad_launches,
          "finite": bool(torch.isfinite(ad_img).all()), "render_equals_render_cuda":
          bool(torch.equal(ad_img, k_img)), "plain_ms": ad_plain_ms,
          "vs_plain_tiles": int(smap[::32, ::128].numel()),
          "vs_plain_tiles_differ": ad_tiles_differ, "vs_plain_flip_frac": m17.flip_frac,
          "vs_plain_mean_abs": m17.mean_abs, "vs_plain_max_abs": m17.max_abs,
          "vs_plain_limits": [0.01, 2e-4], "card": smi})
    gate("adaptive_path", ad_launches == {"megakernel:brute+adaptive": 7},
         f"expected 7 brute+adaptive launches, counted {ad_launches}")
    gate("adaptive_path", bool(torch.isfinite(ad_img).all()), "the adaptive frame is not finite")
    gate("adaptive_path", bool(torch.equal(ad_img, k_img)), "render() differs from render_cuda")
    gate("adaptive_path", ad_tiles_differ <= 1, f"{ad_tiles_differ} tiles differ from plain")
    gate("adaptive_path", m17.ok, f"vs plain: {m17}")

    # 18. the reference's own loop: 16 progressive steps at the main size,
    # as a user calls it (scene on the host, camera settings), and again
    # with the scene on the card and the camera derived once
    prog_cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30)
    state = T.init_accum(720, 1280)
    T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7)  # warm-up
    torch.cuda.synchronize()
    mk.LAUNCHES.clear()
    t0 = time.perf_counter()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(16):
        state = T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    step_ms = ev0.elapsed_time(ev1) / 16
    prog_launches = dict(mk.LAUNCHES)
    resident = T.init_accum(720, 1280)
    ev0.record()
    for _ in range(16):
        resident = T.progressive_step(resident, main_dev, cam6, prog_cfg, frame_seed=7)
    ev1.record()
    torch.cuda.synchronize()
    resident_ms = ev0.elapsed_time(ev1) / 16
    batch16 = T.render(main_scene, main_cam, prog_cfg, frame_seed=7)
    prog_err = float((state.rgb - batch16).abs().max())
    reset = T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7, reset=True)
    two = T.init_accum(720, 1280)
    for _ in range(2):
        two = T.progressive_step(two, main_scene, main_cam, prog_cfg, frame_seed=7,
                                 spp_per_step=8)
    two_err = float((two.rgb - state.rgb).abs().max())
    emit({"phase": "progressive_path", "size": [1280, 720], "steps": 16, "max_depth": 30,
          "ms_per_step": step_ms, "host_ms_per_step": host_ms,
          "ms_per_step_scene_on_card": resident_ms, "count": int(state.count),
          "max_abs_vs_render_spp16": prog_err, "reset_count": int(reset.count),
          "two_steps_of_8_max_abs": two_err, "launches": prog_launches, "card": smi})
    gate("progressive_path", prog_err <= 1e-5, f"16 steps vs render(spp=16): {prog_err}")
    gate("progressive_path", prog_launches == {"megakernel:brute": 16},
         f"expected 16 brute launches, counted {prog_launches}")
    gate("progressive_path", int(state.count) == 16 and int(reset.count) == 1,
         f"count {int(state.count)}, after reset {int(reset.count)}")
    gate("progressive_path", two_err <= 2e-5, f"2 steps of 8 vs 16 of 1: {two_err}")
    gate("progressive_path", bool(torch.equal(resident.rgb, state.rgb)),
         "the card-resident steps differ from the host-scene steps")

    # 19. ray counters: exact against the plain version, the analytic cases,
    # and the main path's rays with the counter on and off
    diffuse = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, T.LAMBERTIAN, (0.8, 0.3, 0.3), 0.0)]))
    cnt_cfg = T.RenderConfig(width=48, height=32, spp=4, max_depth=3)
    got = T.count_traced_rays(diffuse, base_cam, cnt_cfg, frame_seed=7, return_map=True)
    _, want = mk.render_reference(diffuse.to(dev), T.derive_camera(base_cam, 48, 32).to(dev),
                                  width=48, height=32, spp=4, max_depth=3, t_min=1e-3,
                                  frame_seed=7, return_ray_count=True)
    counters_exact = bool(torch.equal(got["map"], want))
    up = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 10.0, 0.0], [0.0, 0.0, 1.0], 20.0, 0.0,
                               10.0)
    down = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0], 40.0, 0.0,
                                 10.0)
    lit_ground = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 50.0, 0.0), 5.0, T.EMISSIVE, (1.0, 1.0, 1.0), 4.0)]))
    analytic = []
    for sc, c, per, extra in ((ground, up, 1, dict(max_depth=6)),
                              (ground, down, 2, dict(max_depth=2)),
                              (lit_ground, down, 3, dict(max_depth=2, nee=True,
                                                         sky_intensity=0.0))):
        r = T.count_traced_rays(sc, c, T.RenderConfig(width=48, height=32, spp=4, **extra),
                                frame_seed=3)
        analytic.append(r["rays_traced"] == per * r["primary_rays"])
    kw_main = dict(width=1280, height=720, spp=16, max_depth=30, t_min=1e-3, frame_seed=7)
    main_cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30)
    main_rays = T.count_traced_rays(main_scene, main_cam, main_cfg, frame_seed=7)["rays_traced"]
    off_a, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, **kw_main), 3)
    on_a, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, return_ray_count=True, **kw_main), 3)
    on_b, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, return_ray_count=True, **kw_main), 3)
    off_b, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, **kw_main), 3)
    off_ms, on_ms = (off_a + off_b) / 2, (on_a + on_b) / 2
    emit({"phase": "ray_count", "diffuse_exact_vs_plain": counters_exact,
          "analytic_exact": analytic, "main_path_rays_traced": main_rays,
          "main_path_primary_rays": 1280 * 720 * 16, "kernel_ms_counter_off": [off_a, off_b],
          "kernel_ms_counter_on": [on_a, on_b], "counter_cost": on_ms / off_ms - 1.0,
          "bounce_mrays_per_s": main_rays / (off_ms * 1e3), "card": smi})
    gate("ray_count", counters_exact, "the kernel's counters differ from the plain version's")
    gate("ray_count", all(analytic), f"analytic cases: {analytic}")

    def rays_of(sc, cam, kw):
        return float(mk.render_cuda(sc, cam, return_ray_count=True, **kw)[1].double().sum())

    kernel = dict(route="cuda", source=KERNEL_SOURCE, replaces=REPLACES)
    main_bound = bound(T, mk, main_dev, main_rays, 3 * 4 * 1280 * 720)
    rows = [
        dict(kernel, name="megakernel:brute", path="brute",
             launches=launches.get("megakernel:brute", 0),
             max_abs_err=m6.max_abs, ms=frame_ms, plain_ms=plain_ms, **main_bound),
    ]
    for p in (paths["config3"], paths["config4"], paths["mesh_bvh+nee"], nee_runs["night"],
              paths["brute+sobol"]):
        sc, cam, kw = p["inputs"]
        b = bound(T, mk, sc, rays_of(sc, cam, kw), 3 * 4 * kw["width"] * kw["height"])
        rows.append(dict(kernel, name="megakernel:" + p["route"], path=p["route"],
                         launches=p["launches"].get("megakernel:" + p["route"], 0),
                         max_abs_err=p["match"].max_abs, ms=p["ms"], plain_ms=p["plain_ms"],
                         **b))
    # The adaptive rows: the main frame (phase 17) and the Cornell box, the
    # NEE instance (phase 15).
    cb = adaptive_runs["cornell"]
    rows.append(dict(kernel, name="megakernel:brute+adaptive", path="brute+adaptive",
                     launches=ad_launches.get("megakernel:brute+adaptive", 0),
                     max_abs_err=m17.max_abs, ms=ad_ms, plain_ms=ad_plain_ms,
                     **bound(T, mk, main_dev, ad_rays, (3 + 2 * 6) * 4 * 1280 * 720)))
    rows.append(dict(kernel, name="megakernel:" + cb["route"], path=cb["route"],
                     launches=cb["launches"].get("megakernel:" + cb["route"], 0),
                     max_abs_err=cb["match"].max_abs, ms=cb["ms"], plain_ms=cb["plain_ms"],
                     **bound(T, mk, cb["scene"], cb["rays"], cb["out_bytes"])))
    n_salts, n_pairs = len(salts), len(pairs)
    probe_bytes = {"hash_probe": 4 * (values.size * (1 + 2 + 2 * n_salts) + n_salts),
                   "sampler_probe": 2 * 4 * values.size * (2 + 2 * n_pairs)}
    rows += [
        dict(kernel, name=name, path=name, replaces=PROBE_REPLACES[name], **p,
             bound_ms=probe_bytes[name] / HBM_RATE * 1e3, bound_by="bytes",
             library_ms=None)
        for name, p in probes.items()
    ]
    emit({"kernels": rows})
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
