"""Camera model (port of gpu_ray_tracing_tpu/models/camera.py).

`CameraSettings` is the user-facing pose, `Camera` the derived per-render
camera the integrators read, and `derive_camera` the closed-form math of
the reference's camera.rs:293-350, in float32 like the JAX package.  The
motion ops (`dolly` ... `zoom`) are pure (settings, amount) -> settings
functions of the reference's keyboard systems (camera.rs:125-253), from
which animation tracks are built.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.ops.rounding import cos_sin, cross, dot3, sqrt


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _fields_to(obj, device):
    return type(obj)(*(getattr(obj, f.name).to(device)
                       for f in dataclasses.fields(obj)))


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    """User-facing camera parameters (camera.rs:10-28), f32 tensors."""

    look_from: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    vup: torch.Tensor  # (3,)
    field_of_view: torch.Tensor  # scalar, degrees
    defocus_angle: torch.Tensor  # scalar, degrees
    focus_distance: torch.Tensor  # scalar

    @staticmethod
    def make(look_from, look_at, vup, field_of_view, defocus_angle,
             focus_distance, device=None) -> "CameraSettings":
        """Settings from plain numbers or arrays, as f32 tensors."""
        return CameraSettings(
            look_from=_f32(look_from, device),
            look_at=_f32(look_at, device),
            vup=_f32(vup, device),
            field_of_view=_f32(field_of_view, device),
            defocus_angle=_f32(defocus_angle, device),
            focus_distance=_f32(focus_distance, device),
        )

    @staticmethod
    def default(device=None) -> "CameraSettings":
        """Reference defaults (camera.rs:30-46)."""
        return CameraSettings.make(
            [13.0, 2.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            20.0, 0.6, 10.0, device=device,
        )

    def to(self, device) -> "CameraSettings":
        return _fields_to(self, device)

    def replace(self, **kw) -> "CameraSettings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Derived per-render camera (the live fields of camera.rs:256-291)."""

    center: torch.Tensor  # (3,)
    viewport_upper_left: torch.Tensor  # (3,)
    pixel_delta_u: torch.Tensor  # (3,)
    pixel_delta_v: torch.Tensor  # (3,)
    defocus_disk_u: torch.Tensor  # (3,)
    defocus_disk_v: torch.Tensor  # (3,)
    defocus_angle: torch.Tensor  # scalar, degrees

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "Camera":
        return _fields_to(self, device)


@functools.cache
def _libm_tanf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").tanf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


class _Tan(torch.autograd.Function):
    """tan of an f32 scalar, rounded as the C library's tanf rounds it:
    jnp.tan on XLA:CPU calls tanf, which is not correctly rounded, and
    one ulp of the viewport flips grazing hits in the goldens.  The
    derivative is jnp.tan's, 1 + tan^2 of the value returned."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.tensor(_libm_tanf()(float(x.detach())), dtype=torch.float32,
                         device=x.device)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (y,) = ctx.saved_tensors
        return grad * (1.0 + y * y)


def _tan(x: torch.Tensor) -> torch.Tensor:
    return _Tan.apply(x)


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm and jnp.cross are jitted: XLA:CPU rounds their
    # products as fused multiply-adds, and so does the port (ops/rounding).
    return sqrt(dot3(v, v))


def validate_camera(settings: CameraSettings) -> None:
    """Reject degenerate poses that would normalize a zero vector and
    render NaNs: look_from == look_at, or vup parallel to the view axis."""
    s = settings
    gaze = (s.look_from.detach().cpu().double()
            - s.look_at.detach().cpu().double()).numpy()
    if float(np.dot(gaze, gaze)) == 0.0:
        raise ValueError(
            "degenerate camera: look_from == look_at (the view basis "
            "would normalize a zero vector and render NaNs)"
        )
    cr = np.cross(s.vup.detach().cpu().double().numpy(), gaze)
    if float(np.dot(cr, cr)) == 0.0:
        raise ValueError(
            "degenerate camera: vup is parallel to the view axis "
            "(u = vup x w would normalize a zero vector)"
        )


def derive_camera(settings: CameraSettings, width: int, height: int) -> Camera:
    """CameraSettings -> Camera (camera.rs:293-350), float32 throughout."""
    s = settings
    validate_camera(s)
    f32 = torch.float32
    aspect_ratio = torch.tensor(width, dtype=f32) / torch.tensor(height, dtype=f32)
    deg = torch.tensor(math.pi / 180.0, dtype=f32)

    theta = s.field_of_view * deg.to(s.field_of_view.device)
    h = _tan(theta / 2.0)
    viewport_height = 2.0 * h * s.focus_distance
    viewport_width = viewport_height * aspect_ratio.to(h.device)

    gaze = s.look_from - s.look_at
    w = gaze / _norm(gaze)
    uu = cross(s.vup, w)
    u = uu / _norm(uu)
    v = cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = -viewport_height * v  # image y grows downward

    # Divided by a tensor on the settings' device: PyTorch's CUDA kernel
    # multiplies by the reciprocal of a Python scalar, one ulp off the
    # quotient for most widths, and the camera would then depend on where
    # its settings lie.
    pixel_delta_u = viewport_u / torch.tensor(float(width), dtype=f32, device=viewport_u.device)
    pixel_delta_v = viewport_v / torch.tensor(float(height), dtype=f32,
                                              device=viewport_v.device)
    viewport_upper_left = (
        s.look_from - s.focus_distance * w - viewport_u / 2.0 - viewport_v / 2.0
    )
    defocus_radius = s.focus_distance * _tan(
        (s.defocus_angle / 2.0) * deg.to(s.defocus_angle.device)
    )
    return Camera(
        center=s.look_from,
        viewport_upper_left=viewport_upper_left,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=s.defocus_angle.to(f32),
    )


# ---------------------------------------------------------------------------
# Camera motion, the pure-functional form of camera.rs:125-253 (the JAX
# package's camera.py:202-266).  Speeds are the caller's `amount`; the
# reference's double-applied yaw (camera.rs:170-206) is not reproduced.
# ---------------------------------------------------------------------------

_Y_AXIS = (0.0, 1.0, 0.0)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v)


def _y_axis(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_Y_AXIS, dtype=torch.float32, device=like.device)


def _forward(settings: CameraSettings) -> torch.Tensor:
    # The reference's "forward" points from look_at toward look_from
    # (camera.rs:134), so W moves the camera away from the target.
    return _normalize(settings.look_from - settings.look_at)


def _right(settings: CameraSettings) -> torch.Tensor:
    fwd = _forward(settings)
    return _normalize(torch.linalg.cross(fwd, _y_axis(fwd)))


def dolly(settings: CameraSettings, amount) -> CameraSettings:
    """W/S: move along the view axis (camera.rs:140-147)."""
    return settings.replace(look_from=settings.look_from + _forward(settings) * amount)


def strafe(settings: CameraSettings, amount) -> CameraSettings:
    """A/D: move along the right axis (camera.rs:150-157)."""
    return settings.replace(look_from=settings.look_from + _right(settings) * amount)


def elevate(settings: CameraSettings, amount) -> CameraSettings:
    """Up/Down arrows: move along world +Y (camera.rs:160-166)."""
    return settings.replace(look_from=settings.look_from + _y_axis(settings.look_from) * amount)


def _rotate_y(v: torch.Tensor, angle) -> torch.Tensor:
    angle = _f32(angle, v.device)
    c, s = cos_sin(angle, f64_on_card=False)
    x, y, z = v[0], v[1], v[2]
    return torch.stack([c * x + s * z, y, -s * x + c * z])


def orbit_yaw(settings: CameraSettings, angle) -> CameraSettings:
    """Left/Right arrows: rotate look_from about look_at around world Y
    (camera.rs:170-187), applied once."""
    view = settings.look_from - settings.look_at
    length = torch.linalg.vector_norm(view)
    direction = _normalize(_rotate_y(view, angle))
    return settings.replace(look_from=settings.look_at + direction * length)


def orbit_pitch(settings: CameraSettings, angle) -> CameraSettings:
    """Keys 1/2: pitch look_from about look_at around the right axis, with
    the flip guard |dot(dir, Y)| < 0.95 (camera.rs:209-242)."""
    view = settings.look_from - settings.look_at
    length = torch.linalg.vector_norm(view)
    fwd = _normalize(view)
    right = _normalize(torch.linalg.cross(fwd, _y_axis(fwd)))
    # Rodrigues rotation of fwd around `right`.
    angle = _f32(angle, fwd.device)
    c, s = cos_sin(angle, f64_on_card=False)
    rotated = (fwd * c + torch.linalg.cross(right, fwd) * s
               + right * torch.dot(right, fwd) * (1.0 - c))
    rotated = _normalize(rotated)
    ok = torch.abs(rotated[1]) < 0.95
    new_from = torch.where(ok, settings.look_at + rotated * length, settings.look_from)
    return settings.replace(look_from=new_from)


def zoom(settings: CameraSettings, fov_delta, fov_min=10.0, fov_max=120.0) -> CameraSettings:
    """Mouse-wheel FOV zoom with the 10..120 degree clamp (camera.rs:57-68,
    121-122)."""
    fov = torch.clamp(settings.field_of_view + fov_delta, fov_min, fov_max)
    return settings.replace(field_of_view=fov)
