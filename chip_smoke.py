#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gpu_ray_tracing_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the megakernel from gpu_ray_tracing_tpu_torch/ops/cuda/megakernel.cu
with nvcc, then drives the port's main path on the card in phases, one JSON
line each:

  1. device       the card, its compute capability and power limit
  2. build        nvcc version, build seconds, the kernel's registers
  3. hash_probe   the kernel's hashes vs ops/rng.py on 1M u32 values: bit-exact
  4. goldens      backend='cuda' renders vs the committed goldens, at
                  tests/test_goldens.py's decision-flip thresholds
  5. kernel_vs_plain  One-Weekend 320x180, 4 spp, depth 30: render_cuda vs
                  its plain PyTorch version, flip <= 1% and mean |diff| < 2e-4
  6. main_path    render(one_weekend_scene(0), CameraSettings.default(),
                  1280x720, 16 spp, depth 30, backend='cuda'): 2 warm-up and
                  5 timed frames (CUDA events), launch counts, output checks,
                  and the same frame from the plain version

then the kernels line, the card's `nvidia-smi` name and power limit, and last
{"ok": true, "device": {...}}.  A failed gate exits nonzero before that line.
Without a CUDA device, or outside the repository, it exits nonzero and prints
no result.  It needs no network and starts no process that outlives it.
"""

from __future__ import annotations

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
# The JAX tests' BASE_CAMERA (tests/test_api.py:22-29).
BASE_CAMERA = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0],
                   vup=[0.0, 1.0, 0.0], field_of_view=60.0, defocus_angle=0.0,
                   focus_distance=2.0)

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


def main() -> int:
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
    regs = [ln.strip() for ln in info.ptxas_report.splitlines() if "registers" in ln]
    emit({"phase": "build", "nvcc": info.nvcc_version, "compiled": info.compiled,
          "nvcc_seconds": info.seconds, "load_seconds": time.perf_counter() - t0,
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": regs})
    gate("build", info.compiled, "the library was not compiled from the checkout")

    # 3. hash probe
    values = np.random.default_rng(20261016).integers(0, 2**32, 1 << 20, dtype=np.uint64)
    values = values.astype(np.uint32)
    values[:2] = (0, 2**32 - 1)
    vt = torch.from_numpy(values.view(np.int32).copy()).to(dev)
    salts = [1, 2, 3, 4, 16, 17, 18, 1000]
    got = mk.hash_probe(vt, salts, 5, 99)
    want = mk.hash_probe_reference(vt, salts, 5, 99)
    exact = {k: bool(torch.equal(got[k], want[k])) for k in want}
    emit({"phase": "hash_probe", "n": int(values.size), "salts": salts, "bit_exact": exact})
    gate("hash_probe", all(exact.values()), f"hashes differ: {exact}")

    # 4. goldens, through the public entry point with backend='cuda'
    base_cam = T.CameraSettings.make(**BASE_CAMERA)
    cases = [
        ("base_normal_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=1, integrator="normal"), 0, 0.002, 1e-5),
        ("base_path_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=4, max_depth=8), 42, 0.005, 1e-4),
        ("one_weekend_48x27.npy", T.one_weekend_scene(0), T.CameraSettings.default(),
         dict(width=48, height=27, spp=2, max_depth=6), 3, 0.01, 2e-4),
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
    mk.LAUNCHES.clear()
    for _ in range(2):
        T.render(main_scene, main_cam, cfg, frame_seed=7)
    frame_ms, img = cuda_ms(lambda: T.render(main_scene, main_cam, cfg, frame_seed=7), 5)
    launches = dict(mk.LAUNCHES)
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
    gate("main_path", launches.get("megakernel", 0) == 7,
         f"expected 7 megakernel launches, counted {launches}")
    gate("main_path", m6.ok, f"vs plain: {m6}")

    emit({"kernels": [{
        "name": "megakernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches.get("megakernel", 0),
        "max_abs_err": m6.max_abs, "ms": frame_ms, "plain_ms": plain_ms,
    }]})
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
