"""The program's spans (`grt.*`, gpu_ray_tracing_tpu_torch/utils/profiling
.span) in a traced window.  The program records them as host operations,
which the profiler does not mirror onto the card's timeline, so the
trace's device readings are those of the same frames without spans; an
idle gap that a span covers, with no operation inside it at the gap's
middle, is named by the span."""

import types

import pytest

from rtbench import spec
from rtbench.trace import TraceView, summarize


def _ev(name, dev, start, end):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _events(spans: bool, frames=4, frame_us=1000):
    """A frame: the call (0-300 µs) derives the camera with a copy to the
    card (20-60; the copy's kernel at 40-45), packs the scene (70-240) and
    launches the render kernel (250-290; it runs 300-900).  With `spans`
    the program's spans surround the three parts."""
    ev = [_ev("rtbench.window", False, 0, frames * frame_us),
          _ev("rtbench.window", True, 0, frames * frame_us)]
    for f in range(frames):
        t = f * frame_us
        ev += [_ev("rtbench.call", False, t, t + 300),
               _ev("aten::copy_", False, t + 30, t + 50),
               _ev("Memcpy HtoD (Pageable -> Device)", True, t + 40, t + 45),
               _ev("cudaLaunchKernel", False, t + 260, t + 270),
               _ev("void render_kernel<true, false, true>(Args)", True, t + 300, t + 900)]
        if spans:
            ev += [_ev("grt.render", False, t + 5, t + 295),
                   _ev("grt.camera", False, t + 20, t + 60),
                   _ev("grt.pack_scene", False, t + 70, t + 240),
                   _ev("grt.launch", False, t + 250, t + 290)]
    return ev


def test_spans_leave_the_device_readings_as_they_were():
    plain, spanned = summarize(_events(False)), summarize(_events(True))
    assert spanned.frames == plain.frames == 4
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.kernel_s == plain.kernel_s
    assert not any(k.startswith("grt.") for k in spanned.kernel_s)
    view = lambda r: TraceView(ranks=[r], enqueue_s=[3e-4] * 4, untraced_frame_s=1e-3,
                               rays_traced=1e6, work_per_ray_flops=100.0, width=10,
                               height=10, kind="NVIDIA H100 80GB HBM3")
    for m in spec.load_benchmark()["per_layer"]:
        read = spec.load_module("metrics", m["name"]).read
        assert read(view(spanned)) == read(view(plain)), m["name"]


def test_an_idle_gap_is_named_by_the_span_around_it():
    """The longest gap (45-300 µs of each frame) has its middle in
    pack_scene: the span names it; without spans only the call does."""
    assert summarize(_events(True)).gaps[0][0] == "rtbench.call > grt.pack_scene"
    assert summarize(_events(False)).gaps[0][0] == "rtbench.call"
