"""The Cornell box with the PyTorch/CUDA port: triangle lights and NEE/MIS.

The port's counterpart of examples/cornell_box.py.  A closed box lit by
one small ceiling quad is the worst case for pure BSDF sampling: a random
bounce rarely finds the lamp.  Next-event estimation samples the lamp's
area at every diffuse vertex, and MIS keeps the mirror and glass spheres'
view of it unbiased.  Compare with --no-nee.  On the card the frame is one
launch of the megakernel (backend='cuda'); --device cpu renders its plain
version.

Run:  python examples/torch_cornell_box.py [--spp 64] [--out cornell.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from gpu_ray_tracing_tpu_torch import RenderConfig, cornell_box_scene, cornell_camera, render
from gpu_ray_tracing_tpu_torch.api import _cuda_device
from gpu_ray_tracing_tpu_torch.utils.image import write_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' raises without a card")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--light", type=float, default=15.0, help="lamp emission scale")
    ap.add_argument("--no-nee", action="store_true",
                    help="BSDF sampling only, the reference's estimator (watch the noise)")
    ap.add_argument("--out", default="cornell.png")
    args = ap.parse_args(argv)

    on_card = args.device == "cuda"
    dev = _cuda_device("cuda") if on_card else torch.device("cpu")
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp, max_depth=args.max_depth,
        backend="cuda" if on_card else "torch",
        nee=not args.no_nee, mis=not args.no_nee, sky_intensity=0.0,
    )
    scene = cornell_box_scene(light_intensity=args.light).to(dev)
    t0 = time.perf_counter()
    img = render(scene, cornell_camera(device=dev), cfg, frame_seed=0)
    if on_card:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{args.width}x{args.height} @ {args.spp} spp, depth {args.max_depth}, "
          f"backend={cfg.backend}, nee={'off' if args.no_nee else 'on+mis'}: {dt:.2f} s"
          + (" (the first call on the card includes the kernel build)" if on_card else ""))
    print(f"wrote {write_image(args.out, img)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
