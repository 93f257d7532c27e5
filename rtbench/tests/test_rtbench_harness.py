"""The harness on the CPU: BENCHMARK.json against the contract's limits on
names and units, the statistics of a window, the per-layer readers on a
synthetic trace, and a configuration, traffic mix and metric added as new
files that the harness finds by name."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from rtbench import check, spec, stats
from rtbench.trace import TraceView, summarize

import tiny

BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_names_and_units():
    assert spec.validate(BENCH) == []
    assert set(BENCH) == TOP_KEYS
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_benchmark_entries_hold_what_the_contract_takes():
    assert BENCH["paths"] == ["rtbench"] and BENCH["command"][1] == "rtbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
    for w in BENCH["workloads"]:
        cell = spec.cell(BENCH, w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end) and cell.per_layer


def test_frame_ms_is_the_window_over_its_frames_and_p95_sees_a_stall():
    """Frames back to back: 99 of 10 ms and one stall of 500 ms.  frame_ms
    carries the stall (the window over the frames); with six stalls in the
    window the 95th percentile is a stall, though the median of any chunk
    of 20 frames would read 10 ms."""
    lat = [0.010] * 99 + [0.500]
    assert stats.frame_ms(sum(lat), len(lat)) == pytest.approx(14.9)
    assert stats.p95_ms(lat) == pytest.approx(10.0)
    lat = [0.010] * 94 + [0.500] * 6
    assert stats.p95_ms(lat) == pytest.approx(500.0)


def _ev(name, dev, start, end):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _rank(kernel_us, gather_us, frames=4, frame_us=1000):
    """A synthetic rank: `frames` calls of frame_us each; in every frame a
    render_kernel of kernel_us and an all_gather of gather_us after it, the
    device otherwise idle; c10d's mirrored span over the gather."""
    ev = [_ev("rtbench.window", False, 0, frames * frame_us),
          _ev("rtbench.window", True, 0, frames * frame_us)]
    for f in range(frames):
        t = f * frame_us
        ev += [_ev("rtbench.call", False, t, t + 100),
               _ev("aten::copy_", False, t + 10, t + 90),
               _ev("void render_kernel<true, false, true>(Args)", True, t + 100,
                   t + 100 + kernel_us),
               _ev("ncclDevKernel_AllGather_RING_LL(x)", True, t + 100 + kernel_us,
                   t + 100 + kernel_us + gather_us),
               _ev("nccl:all_gather", True, t + 100 + kernel_us,
                   t + 100 + kernel_us + gather_us)]
    return summarize(ev)


def test_readers_on_a_synthetic_trace():
    ranks = [_rank(400, 300), _rank(600, 100)]
    assert ranks[0].frames == 4 and ranks[0].window_s == pytest.approx(4e-3)
    assert ranks[0].busy_s == pytest.approx(4 * 700e-6)
    assert ranks[0].gaps[0][0].startswith("rtbench.call > aten::copy_") or ranks[0].gaps
    view = TraceView(ranks=ranks, enqueue_s=[1e-4] * 4, untraced_frame_s=1e-3,
                     rays_traced=1e6, work_per_ray_flops=100.0, width=10, height=10,
                     kind="NVIDIA H100 80GB HBM3")
    read = lambda name: spec.load_module("metrics", name).read(view)
    assert read("device_idle_pct") == pytest.approx(30.0)
    assert read("band_skew") == pytest.approx(1.5)
    assert read("render_kernel_ms") == pytest.approx(0.6)
    assert read("allgather_ms") == pytest.approx(0.1)
    assert read("enqueue_ms") == pytest.approx(0.1)
    bound = 1e8 / 67e12
    assert read("kernel_roofline_pct") == pytest.approx(100 * bound / 1e-3)
    one = dataclasses.replace(view, ranks=ranks[:1])
    assert spec.load_module("metrics", "band_skew").read(one) is None
    assert spec.load_module("metrics", "wavefront_bounce_ms").read(view) is None


def test_one_frame_wrong_fails_the_run():
    """Three sound frames and one half wrong: the pooled flip share (about
    12%) is within a 15% limit, but the frame alone is not, so the run is not
    correct."""
    limits = {"flip_frac": 0.15, "mean_abs": 1.0}
    sound = [10.0, 0.5, 1000.0, 3000.0, 0.0]
    per_frame = torch.tensor([sound, sound, sound, [500.0, 25.0, 1000.0, 3000.0, 0.0]],
                             dtype=torch.float64)
    pooled, failed, correct = check.decide(per_frame, limits)
    assert pooled["flip_frac"] <= limits["flip_frac"] and failed == 1 and not correct
    assert check.decide(per_frame[:3], limits) == (check.readings(per_frame[:3].sum(0)), 0, True)


def test_a_cpu_run_writes_no_device_metric():
    line = tiny.run(tiny.cell("one_weekend_720p.frame16"), trace=True)
    assert line["device"]["platform"] == "cpu"
    assert set(line["metrics"]) <= {"enqueue_ms"}
    assert list(line)[-1] == "compared"


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with entries in BENCHMARK.json and no edit to a file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    with open(os.path.join(spec.HERE, "configs", "one_weekend_720p.json")) as f:
        conf = dict(json.load(f), name="one_weekend_360p", width=640, height=360)
    (root / "rtbench/configs/one_weekend_360p.json").write_text(json.dumps(conf))
    (root / "rtbench/traffic/frame4.json").write_text(json.dumps(
        {"entry": "render", "backend": "cuda", "spp": 4, "check_frames": 2,
         "check_pixels": 64}))
    (root / "rtbench/metrics/frames_traced.py").write_text(
        "def read(tv):\n    return float(tv.ranks[0].frames)\n")
    bench["configs"].append({"name": "one_weekend_360p", "source": "x", "reduced": [],
                             "file": "rtbench/configs/one_weekend_360p.json", "why": "x"})
    bench["workloads"].append({"name": "one_weekend_360p.frame4", "config": "one_weekend_360p",
                               "traffic": "frame4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "frame_ms", "workloads": ["one_weekend_360p.frame4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = ("from rtbench import spec\n"
             "c = spec.cell(spec.load_benchmark(), 'one_weekend_360p.frame4')\n"
             "assert c.config['width'] == 640 and c.traffic['spp'] == 4\n"
             "assert [m['name'] for m in c.per_layer] == ['frames_traced']\n"
             "print(spec.load_module('metrics', 'frames_traced').__file__)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith(str(root))


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """A short run of the first cell through the command, on a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", str(2**31 + 11),
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
