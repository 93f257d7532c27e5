"""The benchmark's triangle-mesh configuration (rtbench/configs/mesh_bvh_480p.json,
BASELINE config 4) on the CPU: its scene generator (rtbench/scenes/mesh_bvh.py)
renders through the program's plain integrator as the benchmark's reference
renders it, the full-size scene is the one the configuration names, and the
program routes it to the global BVH walk, not the shared-memory stage.

The same configuration on the card, against the reference at its
calibrated limits, is tests/test_torch_cuda_mesh.py.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
from rtbench import spec
from rtbench.entries import render as entry
from rtbench.reference import tracer
from rtbench.scenes import mesh_bvh

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

CONFIG = pathlib.Path(spec.HERE) / "configs" / "mesh_bvh_480p.json"


def _config(**changes) -> dict:
    c = json.loads(CONFIG.read_text())
    params = dict(c["params"], **changes.pop("params", {}))
    return dict(c, params=params, **changes)


@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "flat"])
def test_the_scene_renders_as_the_reference_renders_it(smooth):
    """subdivisions 2 (320 faces) at 48x36 and 4 spp through the benchmark's
    entry with backend='torch', against the reference at every pixel: the
    tolerances of rtbench/tests/test_rtbench_reference.py (the plain
    version rounds as XLA:CPU does, the reference as the kernels do)."""
    c = _config(width=48, height=36, params={"subdivisions": 2, "smooth": smooth})
    data = spec.scene_data(c, 5)
    assert data.mesh[0].smooth is smooth
    cell = spec.Cell("mesh_bvh_480p.test", 1, c, {"backend": "torch", "spp": 4}, (), ())
    img = entry.setup(cell, data, torch.device("cpu")).frame(123).numpy()
    sc = tracer.build_scene(data, "cpu")
    cam = tracer.derive_camera(data.camera, c["width"], c["height"], "cpu")
    pid = torch.arange(c["width"] * c["height"])
    ref = tracer.render_pixels(sc, cam, pid, torch.full_like(pid, 123), width=c["width"], spp=4,
                               opt=tracer.Options(**spec.trace_options(c)))
    ref = ref.numpy().reshape(img.shape)
    d = np.abs(img - ref)
    assert np.isfinite(img).all() and np.isfinite(ref).all()
    assert (d.max(-1) > 1e-3).mean() <= 0.03
    assert d.mean() <= 5e-4
    assert abs(img.mean() - ref.mean()) <= 2e-3


def test_full_size_scene_is_the_configurations():
    """subdivisions 6: 81,920 smooth faces, one ground sphere; every vertex
    on the sphere of radius 0.8 about (0, 0.8, 0), to f32 rounding."""
    data = spec.scene_data(_config(), 0)
    (g,) = data.mesh
    assert g.faces.shape == (81_920, 3) and g.vertices.shape == (40_962, 3)
    assert g.vertices.dtype == np.float32 and g.smooth
    assert g.albedo == (0.75, 0.6, 0.45) and g.kind == 0
    assert data.radii.tolist() == [1000.0] and data.centers.tolist() == [[0.0, -1000.0, 0.0]]
    r = np.linalg.norm(g.vertices.astype(np.float64) - [0.0, 0.8, 0.0], axis=1)
    assert np.abs(r - 0.8).max() <= 2.4e-7
    # Each edge is shared by two faces: a closed surface.
    edges = np.sort(np.concatenate([g.faces[:, [0, 1]], g.faces[:, [1, 2]],
                                    g.faces[:, [2, 0]]]), axis=1)
    _, n = np.unique(edges, axis=0, return_counts=True)
    assert (n == 2).all()
    # The geometry is fixed: the seed changes nothing.
    other = spec.scene_data(_config(), 987_654_321_012)
    assert np.array_equal(other.mesh[0].vertices, g.vertices)


def test_the_program_takes_the_global_walk():
    """The program's scene of the configuration is too large for
    render_kernel's stage (its Route's bvh_stage 0) and packs as the mesh
    route: the cell measures the global BVH walk."""
    data = spec.scene_data(_config(), 0)
    sc = entry.program_scene(data, torch.device("cpu"))
    assert sc.mesh.num_triangles == 81_920 and sc.mesh.smooth
    assert mk.bvh_stage_bytes(1, 0, 81_920, sc.bvh.num_nodes) > mk.STAGE_BYTES
    route = mk.pack_scene(sc, False, False, None).route
    assert route == mk.route_of(sc)
    assert route.geometry == "mesh_bvh" and route.bvh_stage == 0
    assert route.path_stage("path", False) == 0


@pytest.mark.parametrize("subdivisions", [0, 1, 3])
def test_the_icosphere_is_the_reference_tests_one(subdivisions):
    """The scene's icosphere is the subdivision the reference's own tests
    check it on (rtbench/tests/meshes.py), vertex for vertex and face for
    face."""
    from rtbench.tests import meshes

    v, f = mesh_bvh.icosphere(subdivisions)
    want_v, want_f = meshes.icosphere(subdivisions)
    assert f.shape == (20 * 4 ** subdivisions, 3)
    assert np.array_equal(v, want_v) and np.array_equal(f, want_f)
