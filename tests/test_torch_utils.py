"""The port's image, ANSI and timing utilities against the JAX package's
modules, on the CPU: written files and terminal strings byte-equal on the
same inputs (numpy arrays and torch tensors), and the frame timing
records (models: tests/test_utils.py:24-61, :106-120, :406-437).
"""

import json
import os

import numpy as np
import pytest
import torch

from gpu_ray_tracing_tpu.utils import ansi as jansi
from gpu_ray_tracing_tpu.utils import image as jimage
from gpu_ray_tracing_tpu_torch.utils import ansi as tansi
from gpu_ray_tracing_tpu_torch.utils import image as timage
from gpu_ray_tracing_tpu_torch.utils import profiling as tprof

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _hdr(shape, seed=0):
    """Linear HDR values from a seed, some above 1 and some negative."""
    return (np.random.default_rng(seed).random(shape, dtype=np.float32) * 1.6 - 0.2)


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_tonemap_and_to_uint8_equal_jax(gamma):
    img = _hdr((7, 9, 3))
    want = jimage.to_uint8(jimage.tonemap(img, gamma))
    for x in (img, torch.from_numpy(img)):
        got = timage.to_uint8(timage.tonemap(x, gamma))
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(timage.to_uint8([0.0, 0.5, 1.0]), [0, 128, 255])
    with pytest.raises(ValueError, match="non-finite"):
        timage.tonemap(torch.tensor([0.5, float("nan")]))


def test_ppm_bytes_equal_jax_and_read_back(tmp_path):
    img = _hdr((7, 9, 3), seed=1)
    jp, tp = os.path.join(tmp_path, "j.ppm"), os.path.join(tmp_path, "t.ppm")
    jimage.write_ppm(jp, img, gamma=2.2)
    timage.write_ppm(tp, torch.from_numpy(img), gamma=2.2)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    back = timage.read_ppm(tp)
    assert np.array_equal(back, jimage.read_ppm(jp)) and back.shape == (7, 9, 3)
    # The token header with a comment, as the JAX reader parses it.
    commented = os.path.join(tmp_path, "c.ppm")
    with open(commented, "wb") as f:
        f.write(b"P6\n# made by hand\n9 7\n255\n" + back.tobytes())
    assert np.array_equal(timage.read_ppm(commented), back)
    truncated = os.path.join(tmp_path, "x.ppm")
    with open(truncated, "wb") as f:
        f.write(b"P6\n9 7\n255\n" + back.tobytes()[:-1])
    with pytest.raises(ValueError, match="truncated"):
        timage.read_ppm(truncated)


def test_png_decodes_equal_to_jax(tmp_path):
    from PIL import Image

    img = _hdr((12, 20, 3), seed=2)
    jp, tp = os.path.join(tmp_path, "j.png"), os.path.join(tmp_path, "t.png")
    assert jimage.write_image(jp, img) == jp
    assert timage.write_image(tp, torch.from_numpy(img)) == tp
    assert np.array_equal(np.asarray(Image.open(tp)), np.asarray(Image.open(jp)))
    # Any other extension is a PPM.
    other = os.path.join(tmp_path, "t.ppm")
    assert timage.write_image(other, img) == other
    assert np.array_equal(timage.read_ppm(other), np.asarray(Image.open(tp)))


@pytest.mark.parametrize("shape,out", [((4, 8, 3), (2, 4)), ((2, 5, 3), (1, 2)),
                                       ((37, 53, 3), (11, 17)), ((6, 6, 3), (6, 6))])
def test_downsample_mean_equal_jax_on_ragged_bins(shape, out):
    img = _hdr(shape, seed=3)
    want = jansi.downsample_mean(img, *out)
    got = tansi.downsample_mean(torch.from_numpy(img), *out)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    np.testing.assert_allclose(tansi.downsample_mean(np.ones((2, 5, 3), np.float32), 1, 2),
                               np.ones((1, 2, 3)))
    with pytest.raises(ValueError, match="downsample only"):
        tansi.downsample_mean(img, shape[0] + 1, 1)


@pytest.mark.parametrize("cols,gamma", [(8, 1.0), (4, 1.0), (24, 2.2), (5, 2.2)])
def test_image_to_ansi_equal_jax(cols, gamma):
    img = _hdr((36, 48, 3), seed=4)
    img[3, 5] = np.nan
    img[10, 11, 1] = np.inf
    want = jansi.image_to_ansi(img, cols, gamma)
    assert tansi.image_to_ansi(torch.from_numpy(img), cols, gamma) == want
    assert tansi.image_to_ansi(img, cols, gamma) == want


def test_ansi_frame_cells_and_nan_to_black():
    """The half-block layout and NaN -> black (test_utils.py:406-437)."""
    img = np.zeros((4, 8, 3), np.float32)
    img[:2] = [1.0, 0.0, 0.0]
    img[2:] = [0.0, 1.0, 0.0]
    lines = tansi.image_to_ansi(img, cols=8, gamma=1.0).split("\n")
    assert len(lines) == 2 and lines[0].count("▀") == 8
    assert "38;2;255;0;0m" in lines[0] and "48;2;0;255;0m" in lines[1]
    one = tansi.image_to_ansi(img, cols=4, gamma=1.0)
    assert "\n" not in one and "38;2;255;0;0m" in one and "48;2;0;255;0m" in one
    bad = torch.full((2, 2, 3), float("nan"))
    assert "38;2;0;0;0m" in tansi.image_to_ansi(bad, cols=2)
    assert tansi.tonemap_u8(bad).max() == 0


def test_frame_stats_math():
    s = tprof.FrameStats(frames=10, seconds=2.0, width=100, height=100, spp=2)
    assert s.ms_per_frame == 200.0
    assert s.mrays_per_sec == 100 * 100 * 2 * 10 / 2.0 / 1e6
    assert s.spp_per_sec == 10.0
    d = json.loads(str(s))
    assert d["device"] == "cpu" and d["ms_per_frame"] == 200.0
    s = tprof.FrameStats(frames=4, seconds=1.0, width=10, height=10, spp=1,
                         window_seconds=(1.0, 1.5))
    assert s.window_spread == 1.5 and json.loads(str(s))["window_spread"] == 1.5


def test_time_frames_on_the_cpu_reads_every_frame():
    calls = []

    def frame(i):
        calls.append(i)
        return torch.full((8, 8, 3), float(i))

    stats = tprof.time_frames(frame, width=8, height=8, spp=1, frames=3, warmup=1, repeats=3)
    assert stats.frames == 3 and stats.seconds > 0 and len(stats.window_seconds) == 3
    assert calls == list(range(10))
    # The checksum covers every timed frame: 192 values of i, i = 1..9.
    assert stats.checksum == 192 * sum(range(1, 10))
    assert stats.device == "cpu" and stats.seconds == sorted(stats.window_seconds)[1]
    # No warm-up: the CPU, as the caller said.
    stats = tprof.time_frames(frame, width=8, height=8, spp=1, frames=2, warmup=0,
                              repeats=1, device="cpu")
    assert stats.frames == 2 and stats.checksum == 192 * (0 + 1)


def test_robust_spread_drops_single_outlier():
    assert tprof.robust_spread([0.10, 0.11, 0.12, 0.11, 90.0]) == pytest.approx(0.02)
    assert tprof.robust_spread([0.10, 0.11, 0.13]) == pytest.approx(0.03)
    assert tprof.robust_spread([0.10, 0.14]) == pytest.approx(0.04)


def test_check_plausible_at_the_h100_ceiling():
    """3.35 TB/s at 12 bytes a ray: ~279,167 Mrays/s a card."""
    assert tprof.MAX_PLAUSIBLE_MRAYS == pytest.approx(3.35e12 / 12 / 1e6)
    tprof.check_plausible(0.99 * tprof.MAX_PLAUSIBLE_MRAYS)
    with pytest.raises(RuntimeError, match="H100 HBM-bandwidth ceiling"):
        tprof.check_plausible(1.01 * tprof.MAX_PLAUSIBLE_MRAYS)
    with pytest.raises(RuntimeError, match="did not include the work"):
        tprof.time_frames(lambda i: torch.zeros(()), width=100_000, height=100_000, spp=1000,
                          frames=1, warmup=0, repeats=1, device="cpu")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
