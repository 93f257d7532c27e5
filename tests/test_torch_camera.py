"""The camera's two derivations (models/camera.py) on the CPU.

Settings that need no gradient are derived on the host in NumPy (one read
of the settings, one copy of the camera); settings that need one are
derived as PyTorch operations that autograd records.  Both give the same
bits on every pose below, the same refusals of a degenerate pose, and the
host path dispatches no PyTorch arithmetic.  The card's version of the
bit-equality is `test_derive_camera_on_the_card_equals_the_cpu` in
tests/test_torch_cuda.py, on the same poses (`camera_poses`).
"""

import collections
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch.models import camera as C

torch.set_num_threads(1)

SIZES = [(96, 54), (1280, 720), (600, 600), (1920, 1080), (1283, 717), (48, 27)]

DEGENERATE = [
    dict(look_from=[1.0, 2.0, 3.0], look_at=[1.0, 2.0, 3.0], vup=[0.0, 1.0, 0.0],
         field_of_view=40.0, defocus_angle=0.0, focus_distance=1.0),
    dict(look_from=[0.0, 5.0, 0.0], look_at=[0.0, 0.0, 0.0], vup=[0.0, 1.0, 0.0],
         field_of_view=40.0, defocus_angle=0.0, focus_distance=1.0),
]


def _pose(look_from, look_at, vup, fov, defocus, focus) -> dict:
    return dict(look_from=look_from, look_at=look_at, vup=vup, field_of_view=fov,
                defocus_angle=defocus, focus_distance=focus)


def camera_poses(n: int = 256, seed: int = 21) -> list[dict]:
    """`n` poses as CameraSettings.make's keywords: the benchmark's four
    cameras, the defaults, the Cornell view, then poses drawn from `seed`
    (fov 10-120 degrees, defocus 0-10, focus 0.1-100 log-uniform; every
    third vup within about 1e-3 rad of the view axis, still valid)."""
    configs = pathlib.Path(__file__).resolve().parents[1] / "rtbench" / "configs"
    poses = []
    for name in ("one_weekend_720p", "cornell_box_600", "one_weekend_1080p", "mesh_bvh_480p"):
        cam = json.loads((configs / f"{name}.json").read_text())["params"]["camera"]
        poses.append(_pose(cam["look_from"], cam["look_at"], cam["vup"], cam["fov"],
                           cam["defocus"], cam["focus"]))
    for s in (T.CameraSettings.default(), T.cornell_camera()):
        poses.append({f.name: getattr(s, f.name).numpy() for f in dataclasses.fields(s)})
    rng = np.random.default_rng(seed)
    while len(poses) < n:
        look_from = rng.uniform(-60.0, 60.0, 3)
        look_at = rng.uniform(-60.0, 60.0, 3)
        if len(poses) % 3 == 0:
            axis = (look_from - look_at) / np.linalg.norm(look_from - look_at)
            vup = rng.choice([-1.0, 1.0]) * axis + rng.normal(0.0, 1e-3, 3)
        else:
            vup = rng.normal(0.0, 1.0, 3)
        poses.append(_pose(look_from, look_at, vup, rng.uniform(10.0, 120.0),
                           rng.uniform(0.0, 10.0), 10.0 ** rng.uniform(-1.0, 2.0)))
    return poses


def assert_cameras_equal(got: T.Camera, want: T.Camera) -> None:
    for f in dataclasses.fields(T.Camera):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype == torch.float32, f.name
        assert a.shape == b.shape, f.name
        assert torch.equal(a.cpu(), b.cpu()), f.name


@pytest.mark.parametrize("size", SIZES)
def test_host_derivation_equals_the_autograd_derivation(size):
    """Every Camera field, bit for bit, on 256 poses at each size."""
    for pose in camera_poses():
        settings = T.CameraSettings.make(**pose)
        assert_cameras_equal(C._derive_host(settings, *size), C._derive_autograd(settings, *size))


@pytest.mark.parametrize("pose", DEGENERATE, ids=["look_from_is_look_at", "vup_on_axis"])
def test_degenerate_poses_raise_alike_on_both_paths(pose):
    settings = T.CameraSettings.make(**pose)
    with pytest.raises(ValueError, match="degenerate camera") as host:
        C._derive_host(settings, 8, 8)
    with pytest.raises(ValueError, match="degenerate camera") as grad:
        C._derive_autograd(settings, 8, 8)
    assert str(host.value) == str(grad.value)
    with pytest.raises(ValueError, match="degenerate camera") as public:
        T.derive_camera(settings, 8, 8)
    assert str(public.value) == str(host.value)


def _derivations(fn) -> collections.Counter:
    before = collections.Counter(C.CAMERA_DERIVATIONS)
    fn()
    return C.CAMERA_DERIVATIONS - before


def test_settings_without_grad_take_the_host_path():
    settings = T.CameraSettings.default()
    assert _derivations(lambda: T.derive_camera(settings, 64, 36)) == {"host": 1}
    # A tensor that requires grad, with grad mode off, needs no gradient.
    wants = settings.replace(field_of_view=settings.field_of_view.clone().requires_grad_(True))
    with torch.no_grad():
        assert _derivations(lambda: T.derive_camera(wants, 64, 36)) == {"host": 1}
    # render() derives through the same function, once a call.
    cfg = T.RenderConfig(width=16, height=12, spp=1, max_depth=2, backend="torch")
    assert _derivations(lambda: T.render(T.base_scene(), settings, cfg, frame_seed=1)) == {
        "host": 1}
    # Nothing is kept: each call reads the settings it is given.
    cam = T.derive_camera(settings.replace(field_of_view=torch.tensor(50.0)), 64, 36)
    assert not torch.equal(cam.pixel_delta_u, T.derive_camera(settings, 64, 36).pixel_delta_u)


def _camera_f64(look_from, look_at, vup, fov, defocus, focus, width, height) -> list:
    """The camera's closed form in f64 PyTorch with torch.tan: an
    independent reference for the gradients."""
    h = torch.tan(fov * (math.pi / 180.0) / 2.0)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    w = (look_from - look_at) / torch.linalg.vector_norm(look_from - look_at)
    u = torch.linalg.cross(vup, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)
    vu, vv = vw * u, -vh * v
    radius = focus * torch.tan(defocus / 2.0 * (math.pi / 180.0))
    return [look_from, look_from - focus * w - vu / 2.0 - vv / 2.0, vu / width, vv / height,
            u * radius, v * radius]


@pytest.mark.parametrize("index", [0, 1, 7, 100])
def test_settings_with_grad_take_the_autograd_path(index):
    """Settings that require grad are derived by autograd: the same bits as
    the host path, and d(camera)/d(field_of_view, look_from) as the f64
    closed form's within f32 rounding."""
    pose = camera_poses()[index]
    base = T.CameraSettings.make(**pose)
    fov = base.field_of_view.clone().requires_grad_(True)
    look_from = base.look_from.clone().requires_grad_(True)
    settings = base.replace(field_of_view=fov, look_from=look_from)
    out = {}
    assert _derivations(lambda: out.update(cam=T.derive_camera(settings, 1280, 720))) == {
        "autograd": 1}
    cam = out["cam"]
    with torch.no_grad():
        assert_cameras_equal(T.derive_camera(settings, 1280, 720), cam)
    weights = torch.linspace(0.5, 2.0, 18, dtype=torch.float64).reshape(6, 3)
    fields = [cam.center, cam.viewport_upper_left, cam.pixel_delta_u, cam.pixel_delta_v,
              cam.defocus_disk_u, cam.defocus_disk_v]
    loss = sum((f.double() * wt).sum() for f, wt in zip(fields, weights))
    got = torch.autograd.grad(loss, [fov, look_from])

    ref = [getattr(base, f.name).double().clone() for f in dataclasses.fields(base)]
    ref[0].requires_grad_(True)
    ref[3].requires_grad_(True)
    ref_fields = _camera_f64(*ref, 1280, 720)
    ref_loss = sum((f * wt).sum() for f, wt in zip(ref_fields, weights))
    want = torch.autograd.grad(ref_loss, [ref[3], ref[0]])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, rtol=2e-4, atol=1e-6 * float(w.abs().max()))


class _OpCounter(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it, views apart."""

    def __init__(self):
        super().__init__()
        self.ops, self.views = collections.Counter(), collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        (self.views if func.is_view else self.ops)[name] += 1
        return func(*args, **(kwargs or {}))


def test_host_path_dispatches_no_arithmetic():
    """Besides views, the host path dispatches one concatenation (the read)
    and one allocation (the camera's buffer): no arithmetic operation and
    no copy on the CPU.  The autograd path dispatches over 100."""
    settings = T.CameraSettings.default()
    with _OpCounter() as host:
        T.derive_camera(settings, 1280, 720)
    assert sum(host.ops.values()) <= 3, host.ops
    assert set(host.ops) <= {"cat", "empty", "_to_copy", "copy_"}, host.ops
    assert host.ops["cat"] == 1 and host.ops["_to_copy"] + host.ops["copy_"] <= 1, host.ops
    with _OpCounter() as grad:
        C._derive_autograd(settings, 1280, 720)
    assert sum(grad.ops.values()) > 100, grad.ops
