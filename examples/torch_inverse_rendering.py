"""Inverse rendering with the PyTorch/CUDA port: recover scene albedos from a
target image by gradient descent through the renderer.

The port's counterpart of examples/inverse_rendering.py.  It renders a
target with the true albedos of base_scene(), scrambles them (numpy seed
123), and runs torch.optim.Adam on d(image)/d(albedo) until the render
matches, a fresh frame_seed each step (the stochastic gradient averages
over the sampler).  On backend='cuda' (the default) or 'wavefront' the
forward is the card's kernel and the backward replays the plain
integrator on the same stream (ops/autograd.py); backend='torch' runs the
plain version with autograd, on the CPU too.

Run:  python examples/torch_inverse_rendering.py [--steps 200] [--backend torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch import CameraSettings, RenderConfig, base_scene, render

CAMERA = dict(look_from=[0.0, 0.3, 1.5], look_at=[0.0, 0.0, -1.0], vup=[0.0, 1.0, 0.0],
              field_of_view=55.0, defocus_angle=0.0, focus_distance=2.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=72)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "wavefront", "torch"])
    ap.add_argument("--max-error", type=float, default=0.15,
                    help="exit 1 unless the final max albedo error is below this")
    args = ap.parse_args(argv)

    device = torch.device("cuda" if args.backend != "torch" else "cpu")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp, max_depth=6,
                       backend=args.backend)
    scene = base_scene(device=device)
    camera = CameraSettings.make(**CAMERA, device=device)
    true_albedo = scene.albedo
    with torch.no_grad():
        target = render(scene, camera, cfg, frame_seed=0)

    rng = np.random.default_rng(123)
    albedo = torch.tensor(rng.random(tuple(true_albedo.shape), dtype=np.float32),
                          device=device, requires_grad=True)
    opt = torch.optim.Adam([albedo], lr=args.lr)
    print(f"initial albedo error: {float((albedo.detach() - true_albedo).abs().max()):.3f}")
    for i in range(args.steps):
        opt.zero_grad()
        img = render(dataclasses.replace(scene, albedo=albedo), camera, cfg, frame_seed=1 + i)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        if i % max(1, args.steps // 10) == 0:
            err = float((albedo.detach() - true_albedo).abs().max())
            print(f"step {i:4d}  loss {float(loss):.6f}  max albedo error {err:.4f}")

    err = float((albedo.detach() - true_albedo).abs().max())
    print(f"final max albedo error: {err:.4f}")
    print("true     :", true_albedo.cpu().numpy().round(3).tolist())
    print("recovered:", albedo.detach().cpu().numpy().round(3).tolist())
    return 0 if err < args.max_error else 1


if __name__ == "__main__":
    sys.exit(main())
