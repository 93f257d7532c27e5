"""Offline high-spp accumulation with the PyTorch/CUDA port: batched steps
and checkpoints.

The port's counterpart of examples/offline_accumulate.py.  Converging a
frame to hundreds of samples when no one watches it frame by frame:

  - `progressive_step(spp_per_step=k)` folds k samples a step, one launch
    for the k samples on the card;
  - on the card, `RenderConfig(backend='wavefront', regenerate='auto')`
    keeps one ray pool across the samples of a step (ray regeneration);
    with --device cpu the wavefront engine's plain version runs instead;
  - the accumulation state (running mean and count) is checkpointed to
    .npz every few steps, stamped with the render's fingerprint, so a long
    render survives an interruption and resumes exactly: the counter
    stream draws sample `count` the same way on resume.

Run:  python examples/torch_offline_accumulate.py --spp 256 --out render.png [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' raises without a card")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=256, help="total samples to reach")
    ap.add_argument("--spp-per-step", type=int, default=8)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--rr", type=int, default=5, metavar="DEPTH",
                    help="russian-roulette start depth (0 = off)")
    ap.add_argument("--checkpoint", default="accum.npz")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="checkpoint every N batched steps")
    ap.add_argument("--preview-every", type=int, default=0, metavar="N",
                    help="also write <out>_preview every N steps (0 = off), "
                         "independent of --checkpoint-every")
    ap.add_argument("--out", default="render.png")
    args = ap.parse_args(argv)

    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.api import _cuda_device
    from gpu_ray_tracing_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        load_accum,
        render_fingerprint,
        save_accum,
    )
    from gpu_ray_tracing_tpu_torch.utils.image import write_image

    on_card = args.device == "cuda"
    dev = _cuda_device("wavefront") if on_card else torch.device("cpu")
    scene = rt.make_scene(rt.one_weekend_scene(0)).to(dev)
    cfg = rt.RenderConfig(
        width=args.width, height=args.height, spp=args.spp, max_depth=args.depth,
        backend="wavefront" if on_card else "wavefront_torch", regenerate="auto",
        russian_roulette_depth=args.rr,
    )
    cam = rt.CameraSettings.default(device=dev)

    # A resume against another scene, seed or config fails instead of
    # folding mismatched samples.
    fingerprint = render_fingerprint(scene, cfg, frame_seed=0)
    if os.path.exists(checkpoint_path(args.checkpoint)):
        state = load_accum(args.checkpoint, expect_fingerprint=fingerprint, device=dev)
        print(f"resumed {args.checkpoint} at {int(state.count)} spp")
    else:
        state = rt.init_accum(cfg.height, cfg.width, device=dev)

    t0 = time.perf_counter()
    step = 0
    while int(state.count) < args.spp:
        state = rt.progressive_step(state, scene, cam, cfg, frame_seed=0,
                                    spp_per_step=args.spp_per_step)
        step += 1
        if step % args.checkpoint_every == 0:
            save_accum(args.checkpoint, state, fingerprint=fingerprint)
            n = int(state.count)
            print(f"{n}/{args.spp} spp  ({n / max(time.perf_counter() - t0, 1e-9):.1f} spp/s)")
        if args.preview_every and step % args.preview_every == 0:
            # Its own cadence: previews do not wait for a checkpoint step.
            root, ext = os.path.splitext(args.out)
            written = write_image(root + "_preview" + (ext or ".png"), state.rgb)
            print(f"preview -> {written}")

    save_accum(args.checkpoint, state, fingerprint=fingerprint)
    print(f"wrote {write_image(args.out, state.rgb)} at {int(state.count)} spp")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
