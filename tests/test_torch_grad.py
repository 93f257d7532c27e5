"""Gradients through the port's plain render path against jax.grad.

The port's `backend='torch'` path is plain PyTorch, so autograd
differentiates it; these tests hold its gradients to jax.grad of the JAX
package's jitted pieces (derive_camera, hash ray generation, trace_path;
intersect_bvh) on the same numpy inputs:
- d(image)/d(field_of_view, defocus_angle): the camera's tan, which keeps
  the C library's rounding in the forward pass, has jnp.tan's derivative;
- d(hit t)/d(face vertices) and d(mesh-lit image)/d(face vertices): the
  BVH walk fixes the winning face, and its t is recomputed differentiably,
  as JAX's intersect_bvh does (straight-through).
A path-traced image is a deterministic function of its parameters on the
hash stream, so the gradients agree to f32 rounding; a few hit decisions
may round apart between XLA and torch, which is what each tolerance covers.
Each JAX function is compiled once per module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu as J
import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu.models import camera as jcam
from gpu_ray_tracing_tpu.ops import integrators as ji
from gpu_ray_tracing_tpu.ops import intersect as jx
from gpu_ray_tracing_tpu.ops import rays as jr
from gpu_ray_tracing_tpu_torch.models import camera as tcam
from gpu_ray_tracing_tpu_torch.ops import intersect as tx

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH, SEED = 16, 12, 2, 3, 3
POSE = dict(look_from=[0.0, 0.3, 1.0], look_at=[0.0, 0.0, -1.0], vup=[0.0, 1.0, 0.0],
            focus_distance=2.0)
WEIGHTS = np.random.default_rng(5).random((H, W, 3)).astype(np.float32)


def _jax_settings(fov, defocus):
    return J.CameraSettings(
        look_from=jnp.asarray(POSE["look_from"], jnp.float32),
        look_at=jnp.asarray(POSE["look_at"], jnp.float32),
        vup=jnp.asarray(POSE["vup"], jnp.float32),
        field_of_view=fov, defocus_angle=defocus,
        focus_distance=jnp.float32(POSE["focus_distance"]))


def _jax_image(scene, settings, **trace_kw):
    """JAX's jitted pieces: derive_camera, hash ray generation, trace_path,
    the mean over SPP samples."""
    cam = jcam.derive_camera(settings, W, H)
    acc = jnp.zeros((H * W, 3), jnp.float32)
    for k in range(SPP):
        o, d, seeds = jr.generate_rays_hash(cam, W, H, jnp.uint32(k), jnp.uint32(SEED))
        acc = acc + ji.trace_path(o.reshape(-1, 3), d.reshape(-1, 3), scene, DEPTH, 1e-3,
                                  3.4e35, pixel_seeds=seeds.reshape(-1), **trace_kw)
    return (acc / SPP).reshape(H, W, 3)


def _torch_image(scene, settings, **cfg_kw):
    cfg = T.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, backend="torch", **cfg_kw)
    return T.render(scene, settings, cfg, frame_seed=SEED)


# --- the camera: tan with jnp.tan's derivative --------------------------------


@functools.cache
def _jax_camera_grad():
    scene = J.base_scene()
    loss = lambda fov, defocus: jnp.sum(_jax_image(scene, _jax_settings(fov, defocus)) * WEIGHTS)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))


def test_tan_keeps_the_c_library_value_and_has_tans_derivative():
    x = torch.tensor(0.3, requires_grad=True)
    y = tcam._tan(x)
    assert float(y.detach()) == tcam._libm_tanf()(0.3)
    y.backward()
    assert float(x.grad) == np.float32(1.0) + np.float32(float(y.detach())) ** 2


@pytest.mark.parametrize("fov,defocus", [(60.0, 3.0), (35.0, 1.5)])
def test_camera_gradients_match_jax_grad(fov, defocus):
    """d(weighted image)/d(field_of_view) and d/d(defocus_angle) through
    backend='torch' at 16x12, 2 spp, depth 3, against jax.grad of JAX's
    jitted pieces: within 2% of the larger gradient (a few grazing hits
    round apart; the parent's graph was cut, so both were 0)."""
    want = [float(g) for g in _jax_camera_grad()(jnp.float32(fov), jnp.float32(defocus))]
    f = torch.tensor(fov, requires_grad=True)
    a = torch.tensor(defocus, requires_grad=True)
    settings = T.CameraSettings.make(POSE["look_from"], POSE["look_at"], POSE["vup"], 0.0, 0.0,
                                     POSE["focus_distance"]).replace(field_of_view=f,
                                                                     defocus_angle=a)
    (_torch_image(T.base_scene(), settings) * torch.from_numpy(WEIGHTS)).sum().backward()
    got = [float(f.grad), float(a.grad)]
    scale = max(abs(v) for v in want)
    assert min(abs(v) for v in want) > 1e-4 * scale, want  # both informative
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)


# --- meshes: the winner's t recomputed differentiably --------------------------


def _faces(mesh):
    return {k: np.array(getattr(mesh, k)) for k in ("v0", "e1", "e2")}


def _with_faces(mesh, faces):
    return dataclasses.replace(mesh, **faces)


def _ray_batch():
    rng = np.random.default_rng(7)
    o = (rng.uniform(-0.4, 0.4, (600, 3)) + [0.0, 0.8, 3.0]).astype(np.float32)
    d = (np.float32([0.0, 0.0, -1.0]) + rng.normal(0.0, 0.15, (600, 3))).astype(np.float32)
    return o, d


@functools.cache
def _jax_mesh():
    ico = J.transform_mesh(J.icosphere(2), 0.8, (0.0, 0.8, 0.0))
    return J.make_scene(J.make_spheres([((0, -1000.0, 0), 1000.0, J.LAMBERTIAN,
                                         (0.5, 0.5, 0.5), 0.0)]), ico)


def _graph_nodes(t: torch.Tensor) -> int:
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack += [f for f, _ in node.next_functions]
    return len(seen)


def test_bvh_hit_t_and_its_gradient_match_jax_grad():
    """intersect_bvh on an icosphere(2) behind its BVH: the hit t equals
    JAX's for every ray both hit (same winner), the recomputed t equals the
    brute-force scan's bit for bit, the autograd graph holds the recompute only
    (as many nodes for 8 rays as for 600; a walk recorded into the graph
    grows with its iterations), and d(sum w t)/d(v0, e1, e2) matches
    jax.grad to 1e-4 of its largest entry."""
    scene = _jax_mesh()
    o, d = _ray_batch()
    w = np.random.default_rng(8).random(o.shape[0]).astype(np.float32)

    def jloss(faces):
        h = jx.intersect_bvh(jnp.asarray(o), jnp.asarray(d), _with_faces(scene.mesh, faces),
                             scene.bvh, 1e-3, 3.4e35)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0) * w), h

    (_, jh), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in _faces(scene.mesh).items()})
    tscene = T.from_reference(scene)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in _faces(scene.mesh).items()}
    th = tx.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d),
                          _with_faces(tscene.mesh, leaves), tscene.bvh, 1e-3, 3.4e35)
    hit = np.asarray(jh.hit)
    assert hit.mean() > 0.5 and np.array_equal(th.hit.numpy(), hit)
    assert np.array_equal(th.idx.numpy()[hit], np.asarray(jh.idx)[hit])
    np.testing.assert_allclose(th.t.detach().numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-6)
    brute = tx.intersect_triangles(torch.from_numpy(o), torch.from_numpy(d), tscene.mesh, 1e-3,
                                   3.4e35)
    assert torch.equal(brute.t, th.t.detach())
    few = tx.intersect_bvh(torch.from_numpy(o[:8]), torch.from_numpy(d[:8]),
                           _with_faces(tscene.mesh, leaves), tscene.bvh, 1e-3, 3.4e35)
    assert _graph_nodes(th.t) == _graph_nodes(few.t)
    (torch.where(th.hit, th.t, 0.0) * torch.from_numpy(w)).sum().backward()
    for k, leaf in leaves.items():
        want = np.asarray(jgrad[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


@functools.cache
def _jax_lit_mesh_scene():
    quad = J.make_mesh(np.float32([[-0.6, 1.9, -2.6], [0.6, 1.9, -2.6], [0.6, 1.9, -1.4],
                                   [-0.6, 1.9, -1.4]]), np.int64([[0, 1, 2], [0, 2, 3]]),
                       albedo=(1.0, 0.9, 0.8), mat_kind=J.EMISSIVE, mat_param=6.0)
    ico = J.transform_mesh(J.icosphere(1, albedo=(0.4, 0.5, 0.8)), 0.45, (0.2, 0.45, -2.0))
    spheres = J.make_spheres([((0.0, -1000.0, 0.0), 1000.0, J.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0)])
    return J.make_scene(spheres, J.merge_meshes(quad, ico))


@functools.cache
def _jax_lit_mesh_grad():
    scene = _jax_lit_mesh_scene()
    settings = _jax_settings(jnp.float32(60.0), jnp.float32(0.0))

    def loss(faces):
        sc = dataclasses.replace(scene, mesh=_with_faces(scene.mesh, faces))
        img = _jax_image(sc, settings, sky_intensity=0.0, nee=True, mis=True)
        return jnp.sum(img * WEIGHTS)

    return jax.jit(jax.grad(loss))


def test_mesh_lit_frame_gradient_matches_jax_grad():
    """d(weighted image)/d(v0, e1, e2) of a frame lit by a triangle light
    (an emissive quad over a diffuse icosphere(1) and the ground; NEE+MIS,
    sky 0, 16x12, 2 spp, depth 3) through backend='torch', against jax.grad
    of JAX's jitted pieces: within 2% of each gradient's largest entry."""
    scene = _jax_lit_mesh_scene()
    want = _jax_lit_mesh_grad()({k: jnp.asarray(v) for k, v in _faces(scene.mesh).items()})
    tscene = T.from_reference(scene)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in _faces(scene.mesh).items()}
    tscene = dataclasses.replace(tscene, mesh=_with_faces(tscene.mesh, leaves))
    settings = T.CameraSettings.make(POSE["look_from"], POSE["look_at"], POSE["vup"], 60.0, 0.0,
                                     POSE["focus_distance"])
    img = _torch_image(tscene, settings, sky_intensity=0.0, nee=True, mis=True)
    (img * torch.from_numpy(WEIGHTS)).sum().backward()
    for k, leaf in leaves.items():
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=0.02 * np.abs(w).max(),
                                   err_msg=k)
