"""The port's command line (gpu_ray_tracing_tpu_torch/cli.py) on the CPU:
the JAX package's CLI cases (tests/test_utils.py:224-340, :439-513)
through `--device cpu`, where `--backend auto` resolves to the plain
versions; a written PNG equal to write_image of render() on the same
arguments; the refusals (threefry, bench, a missing card) with their
messages; the `auto` rules on both devices; and `python -m
gpu_ray_tracing_tpu_torch --help` in a subprocess.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch import cli
from gpu_ray_tracing_tpu_torch.utils.checkpoint import load_accum
from gpu_ray_tracing_tpu_torch.utils.image import write_image

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def main(argv):
    return cli.main(argv + CPU)


def test_cli_render(tmp_path):
    out = os.path.join(tmp_path, "img.png")
    rc = main(["render", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "2", "--depth", "4", "--out", out])
    assert rc == 0 and os.path.exists(out)


@pytest.mark.parametrize("extra,cfg_kw", [
    ([], {}),
    (["--rng", "wgsl"], dict(rng="wgsl")),
    (["--nee", "--mis", "--sky-intensity", "0", "--russian-roulette", "2"],
     dict(nee=True, mis=True, sky_intensity=0.0, russian_roulette_depth=2)),
])
def test_cli_png_equals_write_image_of_render(tmp_path, extra, cfg_kw, capsys):
    """The file the CLI writes decodes to write_image(render(...)) of the
    same scene, camera, config and seed, byte for byte."""
    scene = "night" if cfg_kw.get("nee") else "base"
    out = os.path.join(tmp_path, "cli.png")
    rc = main(["render", "--scene", scene, "--width", "40", "--height", "30", "--spp", "2",
               "--depth", "5", "--seed", "9", "--out", out] + extra)
    assert rc == 0 and "backend=torch" in capsys.readouterr().out
    ns = argparse.Namespace(scene=scene, scene_seed=0, obj=None, look_from=None,
                            look_at=None, fov=None, defocus_angle=None, focus_distance=None)
    dev = torch.device("cpu")
    cfg = T.RenderConfig(width=40, height=30, spp=2, max_depth=5, backend="torch", **cfg_kw)
    img = T.render(cli._build_scene(ns, dev), cli._build_camera(ns, dev), cfg, frame_seed=9)
    ref = os.path.join(tmp_path, "api.png")
    write_image(ref, img)
    assert np.array_equal(np.asarray(Image.open(out)), np.asarray(Image.open(ref)))


def test_cli_render_denoise(tmp_path):
    out = os.path.join(tmp_path, "dn.png")
    rc = main(["render", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "2", "--depth", "4", "--denoise", "3", "--out", out])
    assert rc == 0 and os.path.exists(out)
    rc = main(["render", "--scene", "base", "--width", "16", "--height", "16",
               "--spp", "1", "--denoise", "2", "--integrator", "depth",
               "--out", os.path.join(tmp_path, "bad.png")])
    assert rc == 2


def test_cli_regenerate_with_auto_backend(tmp_path, capsys):
    """--regenerate on with --backend auto selects the wavefront engine's
    plain version on the CPU."""
    out = os.path.join(tmp_path, "regen.png")
    rc = main(["render", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "2", "--depth", "4", "--regenerate", "on", "--out", out])
    assert rc == 0 and os.path.exists(out)
    assert "backend=wavefront_torch" in capsys.readouterr().out


def test_cli_bench_frames_prints_frame_stats(tmp_path, capsys):
    out = os.path.join(tmp_path, "b.png")
    rc = main(["render", "--scene", "base", "--width", "16", "--height", "12", "--spp", "1",
               "--depth", "2", "--bench-frames", "2", "--out", out])
    line = capsys.readouterr().out
    assert rc == 0 and '"frames": 2' in line and '"device": "cpu"' in line


def test_cli_progressive_preview_every(tmp_path):
    out = os.path.join(tmp_path, "prog.png")
    rc = main(["progressive", "--scene", "base", "--width", "32", "--height", "24",
               "--spp", "4", "--depth", "3", "--steps", "4", "--preview-every", "2",
               "--out", out])
    assert rc == 0 and os.path.exists(out)
    assert os.path.exists(os.path.join(tmp_path, "prog_preview.png"))


def test_cli_progressive_resume(tmp_path):
    """Two sessions of 2 steps resume into the state of one session of 4,
    bit for bit."""
    ckpt = os.path.join(tmp_path, "c.npz")
    out = os.path.join(tmp_path, "p.png")
    common = ["progressive", "--scene", "base", "--width", "32", "--height", "24",
              "--spp", "64", "--depth", "4", "--checkpoint", ckpt]
    assert main(common + ["--steps", "2"]) == 0
    assert int(load_accum(ckpt).count) == 2
    assert main(common + ["--steps", "2", "--out", out]) == 0
    resumed = load_accum(ckpt)
    assert int(resumed.count) == 4 and os.path.exists(out)
    once = os.path.join(tmp_path, "once.npz")
    assert main(common[:-1] + [once, "--steps", "4"]) == 0
    assert torch.equal(load_accum(once).rgb, resumed.rgb)


def test_cli_progressive_fingerprint_mismatch(tmp_path):
    ckpt = os.path.join(tmp_path, "sess.npz")
    base_args = ["progressive", "--scene", "base", "--width", "32", "--height", "24",
                 "--spp", "8", "--depth", "3", "--steps", "1", "--checkpoint", ckpt]
    assert main(base_args + ["--seed", "1"]) == 0
    assert main(base_args + ["--seed", "1"]) == 0
    with pytest.raises(SystemExit, match="different render"):
        main(base_args + ["--seed", "2"])


def test_cli_progressive_rejects_adaptive(capsys):
    rc = main(["progressive", "--scene", "base", "--width", "16", "--height", "12",
               "--backend", "cuda", "--adaptive-tol", "0.05", "--steps", "1"])
    assert rc == 2 and "one-shot" in capsys.readouterr().err


def test_cli_animate(tmp_path):
    out_dir = os.path.join(tmp_path, "frames")
    rc = main(["animate", "--scene", "base", "--width", "32", "--height", "24",
               "--spp", "1", "--depth", "3", "--frames", "2", "--out-dir", out_dir])
    assert rc == 0 and sorted(os.listdir(out_dir)) == ["frame_0000.png", "frame_0001.png"]


def test_cli_mesh_scene(tmp_path):
    out = os.path.join(tmp_path, "mesh.png")
    rc = main(["render", "--scene", "mesh", "--width", "40", "--height", "30",
               "--spp", "1", "--depth", "3", "--integrator", "normal", "--out", out])
    assert rc == 0 and os.path.exists(out)


def test_cli_view_progressive_and_reset(tmp_path, capsys):
    """A camera key applies its motion op and restarts the accumulation;
    [x] quits."""
    out = os.path.join(tmp_path, "view.png")
    rc = main(["view", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "8", "--depth", "3", "--max-steps", "4", "--no-input",
               "--cols", "24", "--out", out, "--spp-per-step", "1",
               "--inject-keys", "w,,x"])
    captured = capsys.readouterr().out
    assert rc == 0 and os.path.exists(out)
    assert "▀" in captured
    assert "1/8 spp" in captured and "2/8 spp" in captured
    assert "3/8 spp" not in captured


def test_cli_view_auto_batches_steps(capsys):
    rc = main(["view", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "12", "--depth", "3", "--max-steps", "2", "--no-input",
               "--cols", "24"])
    captured = capsys.readouterr().out
    assert rc == 0
    assert "6/12 spp" in captured and "12/12 spp" in captured
    assert "6 spp/step" in captured and "spp/s" in captured


def test_cli_view_rejects_adaptive(capsys):
    rc = main(["view", "--scene", "base", "--width", "48", "--height", "36",
               "--spp", "8", "--max-steps", "1", "--no-input",
               "--backend", "cuda", "--adaptive-tol", "0.05"])
    assert rc == 2


def test_rawkeys_keeps_escape_sequences_whole(monkeypatch):
    import pty
    import time

    master, slave = pty.openpty()
    sin = os.fdopen(slave, "r")
    try:
        monkeypatch.setattr(sys, "stdin", sin)
        with cli._RawKeys(True) as keys:
            os.write(master, b"\x1b[Aw")
            for _ in range(100):
                time.sleep(0.01)
                got = keys.poll()
                if got:
                    break
            assert got == "\x1b[Aw"
    finally:
        os.close(master)
        sin.close()


def test_cli_refuses_threefry_and_bench(capsys):
    assert main(["render", "--rng", "threefry", "--out", "never.png"]) == 2
    err = capsys.readouterr().err
    assert "rng='threefry' is not ported yet (ROADMAP Queue 1 item 2" in err
    assert not os.path.exists("never.png")
    assert cli.main(["bench"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and "the row that waits for the benchmark" in err


def test_cli_without_a_card_raises_and_renders_nothing(tmp_path, monkeypatch):
    """--device cuda (the default) with no card visible raises the
    backend's error; nothing renders on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = os.path.join(tmp_path, "never.png")
    for extra in ([], ["--rng", "wgsl"], ["--backend", "torch"], ["--regenerate", "on"]):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU and none is visible"):
            cli.main(["render", "--scene", "base", "--width", "8", "--height", "8",
                      "--spp", "1", "--out", out] + extra)
    assert not os.path.exists(out)


@pytest.mark.parametrize("device,flags,backend", [
    ("cuda", [], "cuda"),
    ("cuda", ["--rng", "wgsl"], "torch"),
    ("cuda", ["--regenerate", "on"], "wavefront"),
    ("cuda", ["--regenerate", "auto"], "wavefront"),
    ("cuda", ["--adaptive-tol", "0.03"], "cuda"),
    ("cpu", [], "torch"),
    ("cpu", ["--rng", "wgsl"], "torch"),
    ("cpu", ["--regenerate", "on"], "wavefront_torch"),
    ("cpu", ["--backend", "cuda"], "cuda"),
])
def test_auto_backend_is_decided_from_the_device(device, flags, backend):
    ap = argparse.ArgumentParser()
    cli._add_common(ap)
    args = ap.parse_args(["--device", device] + flags)
    assert cli._backend(args) == backend


def test_python_dash_m_help():
    out = subprocess.run([sys.executable, "-m", "gpu_ray_tracing_tpu_torch", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for word in ("render", "animate", "progressive", "view", "--device", "numpy"):
        assert word in out.stdout


def test_offline_example_preview_cadence(tmp_path):
    """examples/torch_offline_accumulate.py --preview-every N writes
    previews on its own cadence, not only at checkpoint boundaries (model:
    test_utils.py::test_offline_example_preview_cadence)."""
    import importlib.util

    path = os.path.join(REPO, "examples", "torch_offline_accumulate.py")
    spec = importlib.util.spec_from_file_location("torch_offline_accumulate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = os.path.join(tmp_path, "r.png")
    ck = os.path.join(tmp_path, "ck.npz")
    rc = mod.main(["--device", "cpu", "--width", "32", "--height", "24", "--spp", "2",
                   "--spp-per-step", "1", "--depth", "3", "--rr", "0", "--out", out,
                   "--checkpoint", ck, "--checkpoint-every", "1000", "--preview-every", "1"])
    assert rc == 0
    assert os.path.exists(os.path.join(tmp_path, "r_preview.png")) and os.path.exists(out)
    assert int(load_accum(ck).count) == 2
