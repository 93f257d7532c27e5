"""The port's spans (utils/profiling.span) on the CPU: off, a span is one
check and a shared no-op; under torch.profiler each layer boundary of the
frame path records its `grt.` span, nested as the calls are, and
`span_table` sums a trace's spans and the CUDA runtime calls inside them.
The sharded spans are checked in tests/test_torch_sharding.py, on its
ranks."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf
from gpu_ray_tracing_tpu_torch.utils import profiling

torch.set_num_threads(1)

CAMERA = T.CameraSettings.make([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                               60.0, 0.0, 2.0)


def _spans(prof) -> list:
    """(name, start, end) of every `grt.` span of a trace, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(profiling.SPAN_PREFIX)), key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_with_the_profiler_off_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span recorded with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    first = profiling.span("render")
    assert first is profiling.span("camera") is profiling._NO_SPAN
    with first:
        pass


def test_span_is_a_host_operation_named_with_the_prefix():
    """Recorded as a host operation, not a user annotation: the profiler
    mirrors only user annotations onto the card's timeline, where they would
    read as device work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    events = [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    assert sorted(e.name for e in events) == ["grt.inner", "grt.outer"]
    assert not any(getattr(e, "is_user_annotation", False) for e in events)
    outer, inner = sorted(_spans(prof), key=lambda s: s[0] != "grt.outer")
    assert _inside(inner, outer)


def test_render_records_render_enclosing_camera():
    cfg = T.RenderConfig(width=16, height=12, spp=1, max_depth=2, backend="torch")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.render(T.base_scene(), CAMERA, cfg, frame_seed=3)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["grt.render", "grt.camera"]
    assert _inside(spans[1], spans[0])
    # A derived Camera is rendered as given: no camera span.
    cam = T.derive_camera(CAMERA, 16, 12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.render(T.base_scene(), cam, cfg, frame_seed=3)
    assert [s[0] for s in _spans(prof)] == ["grt.render"]


def test_pack_scene_records_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        packed = mk.pack_scene(T.make_scene(T.base_scene()), False, False, None)
    assert packed.route.geometry == "brute"
    assert [s[0] for s in _spans(prof)] == ["grt.pack_scene"]


@pytest.mark.parametrize("regenerate", ["off", "on"])
def test_wavefront_records_its_iterations_and_reads(regenerate):
    """One grt.wavefront inside grt.render; max_depth iterations a sample
    batch (one batch here) or one a pool iteration; one read span for each
    read of the device that LAST_RUN counts."""
    cfg = T.RenderConfig(width=16, height=12, spp=2, max_depth=3, backend="wavefront_torch",
                         regenerate=regenerate)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.render(T.base_scene(), CAMERA, cfg, frame_seed=5)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    (loop,) = [s for s in spans if s[0] == "grt.wavefront"]
    assert _inside(loop, spans[0]) and spans[0][0] == "grt.render"
    iterations = [s for s in spans if s[0] == "grt.wavefront.iteration"]
    reads = [s for s in spans if s[0] == "grt.wavefront.read"]
    assert all(_inside(s, loop) for s in iterations + reads)
    assert len(iterations) == wf.LAST_RUN["enqueued"]["bounce"]
    if regenerate == "off":
        assert len(iterations) == cfg.max_depth and wf.LAST_RUN["sample_batch"] == cfg.spp
    else:
        assert len(iterations) % wf.POLL_EVERY == 0
    assert len(reads) == wf.LAST_RUN["host_syncs"] >= 1
    assert names.count("grt.pack_scene") == 0  # the plain engine packs nothing


def _event(name, start, end):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start,
                                                                              end=end))


def test_span_table_sums_spans_and_the_runtime_calls_inside_them():
    """Two frames of a synthetic trace (µs): render 0-100 holds camera
    10-30 (a copy's sync) and launch 40-60 (a runtime and a driver
    launch); a sync at 70 in
    render's own time, a launch outside any span."""
    events = []
    for t in (0, 1000):
        events += [_event("grt.render", t, t + 100), _event("grt.camera", t + 10, t + 30),
                   _event("cudaMemcpyAsync", t + 12, t + 14),
                   _event("cudaStreamSynchronize", t + 14, t + 20),
                   _event("grt.launch", t + 40, t + 60),
                   _event("cudaLaunchKernelExC_v11060", t + 45, t + 50),
                   _event("cuLaunchKernelEx", t + 52, t + 55),
                   _event("cudaDeviceSynchronize", t + 70, t + 71),
                   _event("cudaLaunchKernel", t + 200, t + 201),
                   _event("aten::copy_", t + 11, t + 21)]
    table = profiling.span_table(events, frames=2)
    assert set(table) == {"outside", "grt.render", "grt.camera", "grt.launch"}
    render, camera, launch = table["grt.render"], table["grt.camera"], table["grt.launch"]
    assert render["calls"] == camera["calls"] == launch["calls"] == 1.0
    assert render["total_ms"] == pytest.approx(0.1)
    assert render["self_ms"] == pytest.approx(0.1 - 0.02 - 0.02)
    assert camera["self_ms"] == camera["total_ms"] == pytest.approx(0.02)
    assert (camera["syncs"], camera["launches"]) == (1.0, 0.0)
    assert (launch["syncs"], launch["launches"]) == (0.0, 2.0)
    assert (render["syncs"], render["launches"]) == (1.0, 0.0)
    assert table["outside"] == dict(calls=0.0, total_ms=0.0, self_ms=0.0, syncs=0.0,
                                    launches=1.0)


def test_span_table_of_a_profiled_render():
    cfg = T.RenderConfig(width=16, height=12, spp=1, max_depth=2, backend="torch")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            T.render(T.base_scene(), CAMERA, cfg, frame_seed=k)
    table = profiling.span_table(prof.events(), frames=2)
    assert table["grt.render"]["calls"] == table["grt.camera"]["calls"] == 1.0
    assert 0.0 < table["grt.camera"]["total_ms"] < table["grt.render"]["total_ms"]
    assert table["grt.render"]["self_ms"] == pytest.approx(
        table["grt.render"]["total_ms"] - table["grt.camera"]["total_ms"])
    # No card: no runtime call anywhere.
    assert all(r["syncs"] == r["launches"] == 0.0 for r in table.values())
