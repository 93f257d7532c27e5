"""Turntable animation with the PyTorch/CUDA port: orbit the camera around
a scene and write a GIF.

The port's counterpart of examples/turntable.py: the camera path is data
(`stack_camera_track` of `orbit_yaw` poses), `render_animation` renders
every frame (one megakernel launch a frame on the card, the plain version
with --device cpu), and the frames encode to an animated GIF (PPM frames
without PIL).

Run:  python examples/torch_turntable.py --frames 36 --out turntable.gif [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' raises without a card")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--out", default="turntable.gif")
    ap.add_argument("--fps", type=int, default=12)
    args = ap.parse_args(argv)

    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.api import _cuda_device
    from gpu_ray_tracing_tpu_torch.utils.image import to_uint8, tonemap, write_ppm

    on_card = args.device == "cuda"
    dev = _cuda_device("cuda") if on_card else torch.device("cpu")
    scene = rt.make_scene(rt.one_weekend_scene(0)).to(dev)
    cfg = rt.RenderConfig(width=args.width, height=args.height, spp=args.spp,
                          max_depth=args.depth, backend="cuda" if on_card else "torch",
                          russian_roulette_depth=4)
    step = 2.0 * np.pi / args.frames
    track = rt.stack_camera_track(
        [rt.orbit_yaw(rt.CameraSettings.default(device=dev), step * f)
         for f in range(args.frames)])
    frames = rt.render_animation(scene, track, cfg, frame_seeds=list(range(args.frames)))
    frames = frames.cpu().numpy()
    try:
        from PIL import Image
    except ImportError:
        os.makedirs("turntable_frames", exist_ok=True)
        for i, f in enumerate(frames):
            write_ppm(f"turntable_frames/frame_{i:04d}.ppm", f)
        print("PIL unavailable; wrote PPM frames to turntable_frames/")
        return 0
    pil = [Image.fromarray(to_uint8(tonemap(f))) for f in frames]
    pil[0].save(args.out, save_all=True, append_images=pil[1:],
                duration=int(1000 / args.fps), loop=0)
    print(f"wrote {args.out} ({args.frames} frames, {cfg.width}x{cfg.height}, "
          f"{cfg.spp} spp, backend={cfg.backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
