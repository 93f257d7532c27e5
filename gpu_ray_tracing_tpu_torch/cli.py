"""Command-line interface of the PyTorch/CUDA port (port of
gpu_ray_tracing_tpu/cli.py): offline renders, animations, progressive
sessions and a live terminal viewer.

  python -m gpu_ray_tracing_tpu_torch render      --scene one-weekend --out img.png
  python -m gpu_ray_tracing_tpu_torch render      --bench-frames 10 --trace traces/
  python -m gpu_ray_tracing_tpu_torch animate     --frames 24 --out-dir frames/
  python -m gpu_ray_tracing_tpu_torch progressive --steps 64 --checkpoint c.npz
  python -m gpu_ray_tracing_tpu_torch view        --scene base --spp 64

Every scene and camera is built on --device, 'cuda' by default: without a
card that raises, and nothing renders on the CPU instead; pass --device
cpu for the plain PyTorch versions.  --backend auto is decided from
--device alone: on 'cuda' the hand-written kernels (the megakernel, the
wavefront engine for --regenerate, the adaptive kernel for
--adaptive-tol) and the plain stream on the card for --rng wgsl and
--rng threefry, which the kernels do not draw; on 'cpu' the plain versions
('torch', or 'wavefront_torch' for --regenerate).  --seed is the frame
seed of the hash and wgsl streams and the key of the threefry stream,
which a progressive session offsets by the step (from the resumed count)
so that no step draws another's samples.  `render --trace DIR` records
the timed frames with torch.profiler into DIR/trace.json, the program's
`grt.` spans with them, and prints each span's calls, host time and the
CUDA runtime's synchronisations and launches inside it, a frame, and which
camera derivation (host or autograd) the command ran, how often.
`progressive` resumes from its checkpoint file when present.  The
one-weekend scenes are the port's one_weekend_scene(--scene-seed): drawn
from numpy with the JAX package's seed mix (its key(seed) scene, sphere
for sphere), and not padded.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import time

import torch


def _nonneg_int(text: str) -> int:
    v = int(text)
    if v < 0:
        raise argparse.ArgumentTypeError(f"expected >= 0, got {text!r}")
    return v


def _vec3(text: str) -> list[float]:
    parts = [float(x) for x in text.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z got {text!r}")
    return parts


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--scene", default="one-weekend",
                    choices=["base", "one-weekend", "one-weekend-full", "mesh",
                             "night", "cornell"],
                    help="one-weekend(-full) is one_weekend_scene(--scene-seed), "
                         "drawn from numpy with the JAX package's seed mix")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--integrator", default="path",
                    choices=["path", "normal", "albedo", "depth"],
                    help="albedo/depth render first-hit AOV guide "
                         "channels (e.g. for external denoisers)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where scenes, cameras and frames live; 'cuda' raises "
                         "without a card (no CPU fallback)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "wavefront", "torch", "wavefront_torch"],
                    help="auto: from --device (module docstring)")
    ap.add_argument("--rng", default="hash", choices=["hash", "wgsl", "threefry"],
                    help="wgsl is the reference shader's own stream and threefry "
                         "jax.random's stream under PRNGKey(--seed), both "
                         "through the plain integrator")
    ap.add_argument("--sampler", default="independent",
                    choices=["independent", "stratified", "sobol"],
                    help="sample generator; 'stratified' (jittered grid) and "
                         "'sobol' (Owen-scrambled (0,2)-sequence, best at "
                         "power-of-two spp) lower variance at equal spp "
                         "(both require --rng hash)")
    ap.add_argument("--regenerate", default="off", choices=["auto", "on", "off"],
                    help="wavefront ray regeneration: refill dead rays "
                         "with the next sample's primaries (spp > 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation (needs emissive lights)")
    ap.add_argument("--mis", action="store_true",
                    help="multiple importance sampling of NEE vs BSDF rays "
                         "(requires --nee)")
    ap.add_argument("--sky-intensity", type=float, default=1.0)
    ap.add_argument("--russian-roulette", type=int, default=0, metavar="DEPTH",
                    help="RR termination from this bounce (0 = off)")
    ap.add_argument("--clamp", type=float, default=0.0,
                    help="per-sample radiance clamp (firefly control; "
                         "0 = off; biased, try 5-50)")
    ap.add_argument("--adaptive-tol", type=float, default=0.0,
                    help="adaptive sampling tolerance (render command only; "
                         "the megakernel): > 0 makes --spp a per-tile budget, "
                         "tiles stop once their relative standard error drops "
                         "below this (try 0.01-0.05)")
    ap.add_argument("--adaptive-min-spp", type=int, default=8,
                    help="samples every tile takes before the adaptive "
                         "convergence test may stop it")
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--obj", default=None, help="OBJ file for --scene mesh")
    ap.add_argument("--look-from", type=_vec3, default=None)
    ap.add_argument("--look-at", type=_vec3, default=None)
    ap.add_argument("--fov", type=float, default=None)
    ap.add_argument("--defocus-angle", type=float, default=None)
    ap.add_argument("--focus-distance", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=2.2)


def _device(args) -> torch.device:
    """--device as a torch device: the current card for 'cuda', which
    raises when none is visible."""
    if args.device == "cpu":
        return torch.device("cpu")
    from gpu_ray_tracing_tpu_torch.api import _cuda_device

    return _cuda_device("cuda", hint="pass --device cpu for the plain PyTorch versions")


def _build_scene(args, device: torch.device):
    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.models.spheres import (
        DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL,
    )

    if args.scene == "base":
        return rt.base_scene(device=device)
    if args.scene == "one-weekend":
        return rt.one_weekend_scene(args.scene_seed, device=device)
    if args.scene == "one-weekend-full":
        return rt.one_weekend_scene(args.scene_seed, grid_min=-11, grid_max=11, device=device)
    if args.scene == "night":
        return rt.make_scene(rt.make_spheres([
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.65, 0.65, 0.65), 0.0),
            ((0.0, 2.6, -1.0), 0.7, EMISSIVE, (1.0, 0.85, 0.6), 8.0),
            ((-2.4, 0.5, -0.5), 0.5, METAL, (0.9, 0.9, 0.95), 0.03),
            ((2.0, 0.5, -1.0), 0.5, DIELECTRIC, (1, 1, 1), 1.5),
            ((0.0, 0.5, -1.0), 0.5, LAMBERTIAN, (0.2, 0.4, 0.8), 0.0),
            ((-4.5, 1.2, -4.0), 0.8, EMISSIVE, (0.4, 0.6, 1.0), 6.0),
        ])).to(device)
    if args.scene == "cornell":
        # Triangle lights end to end (pair with --nee --mis
        # --sky-intensity 0; the box is closed, all light is the lamp).
        return rt.cornell_box_scene().to(device)
    # mesh: a ground sphere and a mesh object (--obj or the bunny stand-in)
    ground = rt.make_spheres([((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    mesh = rt.load_obj(args.obj) if args.obj else rt.bunny_stand_in(albedo=(0.75, 0.6, 0.45))
    mesh = rt.transform_mesh(mesh, scale=0.8, translate=(0.0, 0.8, 0.0))
    return rt.make_scene(ground, mesh).to(device)


def _build_camera(args, device: torch.device):
    import gpu_ray_tracing_tpu_torch as rt

    cam = rt.CameraSettings.default()
    if args.look_from is None:
        if args.scene == "night":
            cam = rt.CameraSettings.make([0.0, 1.3, 4.0], [0.0, 0.7, -1.0], cam.vup, 45.0,
                                         0.0, cam.focus_distance)
        elif args.scene == "mesh":
            cam = rt.CameraSettings.make([0.0, 1.2, 3.0], [0.0, 0.7, 0.0], cam.vup, 50.0,
                                         0.0, cam.focus_distance)
        elif args.scene == "cornell":
            cam = rt.cornell_camera()
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    for flag, field in (("look_from", "look_from"), ("look_at", "look_at"),
                        ("fov", "field_of_view"), ("defocus_angle", "defocus_angle"),
                        ("focus_distance", "focus_distance")):
        if getattr(args, flag) is not None:
            cam = cam.replace(**{field: f32(getattr(args, flag))})
    # A degenerate pose fails here, before any render.
    rt.validate_camera(cam)
    return cam.to(device)


def _rng_kwargs(args, offset: int = 0) -> dict:
    """--seed (+ offset) as render()'s key (threefry) or frame seed (the
    hash and wgsl streams)."""
    if args.rng == "threefry":
        return {"key": args.seed + offset}
    return {"frame_seed": args.seed + offset}


def _backend(args) -> str:
    """--backend, with 'auto' decided from --device (never by looking for
    a card)."""
    if args.backend != "auto":
        return args.backend
    if args.device == "cpu":
        return "wavefront_torch" if args.regenerate != "off" else "torch"
    if args.regenerate != "off":
        return "wavefront"
    if getattr(args, "adaptive_tol", 0.0) > 0.0:
        return "cuda"
    return "cuda" if args.rng == "hash" else "torch"


def _build_config(args):
    import gpu_ray_tracing_tpu_torch as rt

    return rt.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.depth, integrator=args.integrator, backend=_backend(args),
        rng=args.rng, nee=args.nee, mis=getattr(args, "mis", False),
        clamp=getattr(args, "clamp", 0.0),
        sky_intensity=args.sky_intensity,
        russian_roulette_depth=args.russian_roulette,
        regenerate=args.regenerate,
        sampler=args.sampler,
        adaptive_tol=getattr(args, "adaptive_tol", 0.0),
        adaptive_min_spp=getattr(args, "adaptive_min_spp", 8),
    )


def _setup(args):
    """(device, scene, camera) of a command."""
    dev = _device(args)
    return dev, _build_scene(args, dev), _build_camera(args, dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_render(args, cfg) -> int:
    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.models.camera import CAMERA_DERIVATIONS
    from gpu_ray_tracing_tpu_torch.utils.image import write_image
    from gpu_ray_tracing_tpu_torch.utils.profiling import device_trace, span_table, time_frames

    if args.denoise and args.integrator != "path":
        print("error: --denoise filters the path integrator's beauty "
              "pass; drop --integrator or --denoise", file=sys.stderr)
        return 2
    if args.trace and not args.bench_frames:
        print("error: --trace records the timed frames; give --bench-frames N",
              file=sys.stderr)
        return 2
    dev, scene, cam = _setup(args)
    derived = collections.Counter(CAMERA_DERIVATIONS)
    # Derived once: the settings do not change between frames, and a
    # derivation from settings on the card reads them (one synchronisation),
    # which would wait for the previous frame, so the card would idle while
    # the host enqueues the next.
    cam = rt.derive_camera(cam, cfg.width, cfg.height)
    if args.denoise:
        def frame_fn(i):
            return rt.render_denoised(scene, cam, cfg, iterations=args.denoise,
                                      **_rng_kwargs(args, i))
    else:
        def frame_fn(i):
            return rt.render(scene, cam, cfg, **_rng_kwargs(args, i))
    out_path = write_image(args.out, frame_fn(0), args.gamma)
    # Times what was written: with --denoise the beauty pass, the guides
    # and the filter.
    stats = None
    if args.bench_frames:
        with (device_trace(args.trace, device=dev) if args.trace
              else contextlib.nullcontext()) as prof:
            stats = time_frames(frame_fn, width=cfg.width, height=cfg.height, spp=cfg.spp,
                                frames=args.bench_frames, warmup=0, device=dev)
    print(f"wrote {out_path} ({cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"backend={cfg.backend}, device={dev.type})" + (f" {stats}" if stats else ""))
    if args.trace:
        # The host's time and runtime calls by span, a frame, on standard
        # error; the timeline itself is in <dir>/trace.json.
        frames = stats.frames * len(stats.window_seconds)
        for name, r in span_table(prof.events(), frames).items():
            print(f"span {name}: {r['calls']:.2f} calls, {r['total_ms']:.3f} ms, self "
                  f"{r['self_ms']:.3f} ms, {r['syncs']:.2f} syncs, {r['launches']:.2f} "
                  "launches a frame", file=sys.stderr)
        # Which camera derivation the command ran, and how often.
        derived = CAMERA_DERIVATIONS - derived
        print(f"camera derivations: {derived['host']} host, {derived['autograd']} autograd, "
              f"for the written frame and {frames} timed frames", file=sys.stderr)
    return 0


def cmd_animate(args, cfg) -> int:
    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.utils.image import write_image

    _, scene, cam = _setup(args)
    track = rt.stack_camera_track(
        [rt.orbit_yaw(cam, args.orbit_step * f) for f in range(args.frames)])
    if args.rng == "threefry":
        anim_kwargs = {"key": args.seed}
    else:
        anim_kwargs = {"frame_seeds": list(range(args.seed, args.seed + args.frames))}
    frames = rt.render_animation(scene, track, cfg, **anim_kwargs)
    os.makedirs(args.out_dir, exist_ok=True)
    frames = frames.cpu().numpy()
    for f in range(args.frames):
        write_image(os.path.join(args.out_dir, f"frame_{f:04d}.png"), frames[f], args.gamma)
    print(f"wrote {args.frames} frames to {args.out_dir}")
    return 0


def cmd_progressive(args, cfg) -> int:
    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        load_accum,
        render_fingerprint,
        save_accum,
    )
    from gpu_ray_tracing_tpu_torch.utils.image import write_image

    if args.adaptive_tol > 0.0:
        print("error: --adaptive-tol is a one-shot `render` mode; progressive "
              "accumulation needs exact per-sample counts", file=sys.stderr)
        return 2
    dev, scene, cam = _setup(args)
    # Scene contents, seed and every stream-relevant config field (not the
    # backend): a resume against other flags fails instead of folding
    # mismatched samples.
    fingerprint = render_fingerprint(scene, cfg, frame_seed=args.seed)
    if args.checkpoint and os.path.exists(checkpoint_path(args.checkpoint)):
        try:
            state = load_accum(args.checkpoint, expect_fingerprint=fingerprint, device=dev)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if tuple(state.rgb.shape) != (cfg.height, cfg.width, 3):
            raise SystemExit(
                f"checkpoint {args.checkpoint} is {state.rgb.shape[1]}x"
                f"{state.rgb.shape[0]}, but --width/--height request "
                f"{cfg.width}x{cfg.height}; the state cannot be resumed at a "
                "different resolution"
            )
        print(f"resumed from {args.checkpoint} at {int(state.count)} spp")
    else:
        state = rt.init_accum(cfg.height, cfg.width, device=dev)
    resumed = int(state.count)
    preview_base = args.out or "progressive.png"
    for step in range(args.steps):
        # hash/wgsl: a constant frame seed, the accumulated count is the
        # sample index, as in render().  threefry: a key a step, offset by
        # the resumed count, or a resumed session would draw the first
        # session's samples again.
        kw = _rng_kwargs(args, resumed + step if args.rng == "threefry" else 0)
        state = rt.progressive_step(state, scene, cam, cfg, **kw)
        if args.preview_every and (step + 1) % args.preview_every == 0:
            root, ext = os.path.splitext(preview_base)
            p = write_image(f"{root}_preview{ext or '.png'}", state.rgb, args.gamma)
            print(f"preview at {int(state.count)} spp -> {p}", flush=True)
    if args.checkpoint:
        save_accum(args.checkpoint, state, fingerprint=fingerprint)
    if args.out:
        write_image(args.out, state.rgb, args.gamma)
    print(f"{int(state.count)}/{cfg.spp} spp accumulated"
          + (f"; wrote {args.out}" if args.out else ""))
    return 0


class _RawKeys:
    """Non-blocking key reads from a tty, its mode restored on exit.
    Outside a tty (tests, pipes, --no-input) it is inert and `poll()`
    yields only the injected test keys."""

    def __init__(self, enabled: bool, inject: list[str] | None = None):
        self._enabled = enabled and sys.stdin.isatty()
        self._saved = None
        self._inject = list(inject or [])

    def __enter__(self):
        if self._enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, self._saved)
        return False

    def poll(self) -> str:
        """All pending input (escape sequences whole), without blocking;
        one injected batch a call in test mode."""
        out = self._inject.pop(0) if self._inject else ""
        if not self._enabled:
            return out
        import select

        # The raw fd, not sys.stdin: a buffered read(1) would pull the rest
        # of an escape sequence into Python's buffer, where select() on the
        # fd no longer sees it.
        fd = sys.stdin.fileno()
        while select.select([fd], [], [], 0)[0]:
            chunk = os.read(fd, 64)
            if not chunk:
                break
            out += chunk.decode("utf-8", errors="ignore")
        return out


def _view_key_ops():
    """view's key bindings -> (camera op, signed step): W/S dolly, A/D
    strafe, R/F and up/down elevate, J/L and left/right orbit, 1/2 pitch,
    +/- zoom (the reference's keyboard systems, camera.rs:125-253)."""
    from gpu_ray_tracing_tpu_torch.models import camera as cam_ops

    move, turn, fovs = 0.4, 0.08, 2.0
    return {
        "w": (cam_ops.dolly, -move), "s": (cam_ops.dolly, move),
        "a": (cam_ops.strafe, -move), "d": (cam_ops.strafe, move),
        "r": (cam_ops.elevate, move), "f": (cam_ops.elevate, -move),
        "\x1b[A": (cam_ops.elevate, move), "\x1b[B": (cam_ops.elevate, -move),
        "j": (cam_ops.orbit_yaw, turn), "l": (cam_ops.orbit_yaw, -turn),
        "\x1b[D": (cam_ops.orbit_yaw, turn), "\x1b[C": (cam_ops.orbit_yaw, -turn),
        "1": (cam_ops.orbit_pitch, turn), "2": (cam_ops.orbit_pitch, -turn),
        "+": (cam_ops.zoom, -fovs), "-": (cam_ops.zoom, fovs),
    }


def cmd_view(args, cfg) -> int:
    """Live progressive viewer in the terminal: progressive steps repainted
    as half-block cells; a camera key applies its motion op and restarts
    the accumulation (the reference's camera_has_moved, wgsl:352-358)."""
    import gpu_ray_tracing_tpu_torch as rt
    from gpu_ray_tracing_tpu_torch.utils.ansi import (
        CLEAR_SCREEN,
        CURSOR_HOME,
        HIDE_CURSOR,
        SHOW_CURSOR,
        image_to_ansi,
    )

    if args.adaptive_tol > 0.0:
        print("error: --adaptive-tol does not compose with the viewer's "
              "progressive accumulation; use `render`", file=sys.stderr)
        return 2
    dev, scene, cam = _setup(args)
    if args.spp_per_step == 0:
        # Batch samples per repaint, so a repaint is not a launch's fixed
        # cost; keys are polled between batches.  A threefry step draws one
        # sample.
        args.spp_per_step = 1 if cfg.rng == "threefry" else next(
            k for k in (8, 6, 5, 4, 3, 2, 1) if cfg.spp % k == 0)
    if args.spp_per_step > 1 and cfg.spp % args.spp_per_step != 0:
        print(f"error: --spp-per-step {args.spp_per_step} must divide "
              f"--spp {cfg.spp}", file=sys.stderr)
        return 2
    if args.cols is None:
        import shutil

        args.cols = min(shutil.get_terminal_size((80, 24)).columns, cfg.width)
    key_ops = _view_key_ops()
    inject = args.inject_keys.split(",") if args.inject_keys else None
    state = rt.init_accum(cfg.height, cfg.width, device=dev)
    reset, step, quit_key = False, 0, False
    interactive = not args.no_input
    sys.stdout.write(CLEAR_SCREEN + (HIDE_CURSOR if interactive else ""))
    try:
        with _RawKeys(interactive, inject) as keys:
            while (args.max_steps == 0 or step < args.max_steps) and not quit_key:
                t0 = time.perf_counter()
                state = rt.progressive_step(
                    state, scene, cam, cfg, reset=reset, spp_per_step=args.spp_per_step,
                    **_rng_kwargs(args, step if args.rng == "threefry" else 0))
                _sync(dev)
                dt = time.perf_counter() - t0
                count = int(state.count)
                reset = False
                frame = image_to_ansi(state.rgb, args.cols, args.gamma)
                pos = cam.look_from.cpu().numpy()
                status = (
                    f"{count}/{cfg.spp} spp | {dt * 1e3:6.1f} ms/step "
                    f"({args.spp_per_step} spp/step = "
                    f"{args.spp_per_step / max(dt, 1e-9):5.1f} spp/s) | "
                    f"cam ({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}) "
                    f"fov {float(cam.field_of_view):.0f}"
                )
                help_line = ("[wasd] move  [rf/arrows] up/down  [jl/arrows] "
                             "orbit  [12] pitch  [+-] zoom  [0] re-center  "
                             "[x] quit") if interactive else ""
                sys.stdout.write(CURSOR_HOME + frame + "\n" + status + "\x1b[K\n"
                                 + help_line + "\x1b[K")
                sys.stdout.flush()
                pressed = keys.poll()
                moved = False
                i = 0
                while i < len(pressed):
                    tok = pressed[i]
                    if tok == "\x1b" and pressed[i:i + 3] in key_ops:
                        tok = pressed[i:i + 3]
                    i += len(tok)
                    if tok in ("x", "\x1b"):
                        quit_key = tok == "x"  # a bare ESC is a dropped sequence tail
                        if quit_key:
                            break
                        continue
                    if tok == "0":  # re-center on the scene origin
                        cam = cam.replace(look_at=torch.zeros(3, dtype=torch.float32,
                                                              device=dev))
                        moved = True
                        continue
                    op = key_ops.get(tok)
                    if op is None:
                        continue
                    fn, amount = op
                    cam = fn(cam, amount)
                    moved = True
                if moved:
                    rt.validate_camera(cam)
                    reset = True
                step += 1
    finally:
        if interactive:
            sys.stdout.write(SHOW_CURSOR)
        sys.stdout.write("\n")
        sys.stdout.flush()
    if args.out:
        from gpu_ray_tracing_tpu_torch.utils.image import write_image

        print(f"wrote {write_image(args.out, state.rgb, args.gamma)}")
    return 0


def cmd_bench() -> int:
    print("error: the port's benchmark is `python3 rtbench/run.py --workload <name> "
          "--seed <n> --seconds <s> --trace <0|1>` from the repository's root "
          "(rtbench/README.md); time a frame here with `render --bench-frames N`",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_ray_tracing_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--bench-frames", type=int, default=0,
                   help="also time this many frames and print throughput")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="record the timed frames with torch.profiler into DIR/trace.json "
                        "and print the host's time by span on standard error")
    p.add_argument("--denoise", type=_nonneg_int, default=0, metavar="ITERS",
                   help="AOV-guided a-trous denoise of the beauty pass with "
                        "this many passes (0 = off; try 3-5 at low --spp)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("animate", help="render an orbiting camera track")
    _add_common(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--orbit-step", type=float, default=0.1, help="radians per frame")
    p.add_argument("--out-dir", default="frames")
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("progressive", help="progressive accumulation with checkpoint/resume")
    _add_common(p)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--preview-every", type=int, default=0, metavar="N",
                   help="write a <out>_preview image snapshot every N steps "
                        "(0 = off) so long renders are inspectable mid-run")
    p.set_defaults(fn=cmd_progressive)

    p = sub.add_parser(
        "view",
        help="live progressive viewer in the terminal (ANSI truecolor "
             "half-blocks) with interactive keyboard camera",
    )
    _add_common(p)
    p.add_argument("--cols", type=int, default=None,
                   help="frame width in terminal columns (default: fit)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N steps (0 = run until [x])")
    p.add_argument("--spp-per-step", type=int, default=0,
                   help="samples folded per repaint (must divide --spp); "
                        "0 = auto: the largest divisor of --spp up to 8 "
                        "(keys are polled between batches)")
    p.add_argument("--no-input", action="store_true",
                   help="disable keyboard handling (non-tty/CI runs)")
    p.add_argument("--out", default=None,
                   help="write the final accumulation to this image on exit")
    p.add_argument("--inject-keys", default=None, help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("bench", help="names the benchmark's command (rtbench/run.py): exits 2")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.command == "bench":
        return cmd_bench()
    # The config is checked first: a refused combination exits before
    # anything is built.
    try:
        cfg = _build_config(args)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return args.fn(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
