"""The frozen reference against the program's plain integrator
(backend='torch') on small frames on the CPU, and the configurations' work
counts against a fresh count."""

import json
import os

import numpy as np
import pytest
import torch

from rtbench import spec
from rtbench.entries import render as entry
from rtbench.reference import tracer, work

CONFIGS = ["one_weekend_720p", "cornell_box_600", "one_weekend_1080p"]


def _config(name, width=48, height=36):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return dict(json.load(f), width=width, height=height)


def _frames(name, spp=4, frame_seed=123):
    c = _config(name)
    data = spec.scene_data(c, 5)
    cell = spec.Cell(name, 1, c, {"backend": "torch", "spp": spp}, (), ())
    prog = entry.setup(cell, data, torch.device("cpu"))
    img = prog.frame(frame_seed).numpy()
    sc = tracer.build_scene(data, "cpu")
    cam = tracer.derive_camera(data.camera, c["width"], c["height"], "cpu")
    pid = torch.arange(c["width"] * c["height"])
    ref = tracer.render_pixels(sc, cam, pid, torch.full_like(pid, frame_seed), width=c["width"],
                               spp=spp, opt=tracer.Options(**spec.trace_options(c)))
    return img, ref.numpy().reshape(img.shape)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_plain_integrator(name):
    """Every pixel agrees but where rounding flips a path: the program's
    plain version rounds as XLA:CPU does, the reference as the kernels do."""
    img, ref = _frames(name)
    d = np.abs(img - ref)
    assert np.isfinite(img).all() and np.isfinite(ref).all()
    assert (d.max(-1) > 1e-3).mean() <= 0.03
    assert d.mean() <= 5e-4
    assert abs(img.mean() - ref.mean()) <= 2e-3


def test_reference_draws_follow_the_frame_seed():
    """Another frame seed draws other samples: the frames differ widely."""
    a, _ = _frames("one_weekend_720p", frame_seed=1)
    _, b = _frames("one_weekend_720p", frame_seed=2)
    assert (np.abs(a - b).max(-1) > 1e-3).mean() > 0.5


@pytest.mark.parametrize("name", CONFIGS)
def test_work_per_ray_is_the_committed_count(name):
    """The work a traced ray needs, counted afresh, is the configuration's."""
    c = _config(name, 0, 0)
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    counted = work.count(c)
    assert counted["flops"] == pytest.approx(c["work_per_ray_flops"], rel=1e-6)
    assert counted["queries"]["closest"] > 0


def test_work_counts_boxes_and_primitives():
    """A ray through one sphere in a one-leaf tree pays one box, the
    sphere's test and its roots; a miss pays the box alone."""
    from rtbench.scenes import LAMBERTIAN, spheres_from_entries

    data = spheres_from_entries([((0.0, 0.0, -5.0), 1.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    sc = tracer.build_scene(data, "cpu")
    counter = work.Counter(sc, 1e-3)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    counter("closest", o, d, torch.tensor([4.0, 3.4e35]))
    hit = work.BOX_FLOPS + work.SPHERE_FLOPS + work.ROOT_FLOPS
    assert counter.ops == hit + work.BOX_FLOPS
    assert counter.per_ray == (hit + work.BOX_FLOPS) / 2
