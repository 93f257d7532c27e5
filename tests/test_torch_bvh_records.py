"""The node and face records every global BVH walk of the CUDA kernels
reads (ops/cuda/megakernel.bvh_nodes, face_records), on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py and chip_smoke
hold their frames bit-equal to the parent's and to the plain version);
here: the records unpack bit for bit to the BVH's bounds and links and
to the mesh table's vertex slots (mesh_table), a walk that reads nothing but the records
finds the plain version's hits, winners and visit counts on an icosphere
and on One-Weekend's 487-sphere BVH, and a BVH the packing cannot hold is
refused by pack_scene, before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpu_ray_tracing_tpu_torch as T
from gpu_ray_tracing_tpu_torch.ops import intersect as tx
from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
from tests.test_torch_bvh_stage import _rays_outside

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

TMIN, TMAX = 1e-3, 3.4e35
BITS = mk.LEAF_COUNT_BITS


def _mesh_scene(subdivisions: int, leaf_size: int = 4):
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    ico = T.transform_mesh(T.icosphere(subdivisions, albedo=(0.8, 0.4, 0.2), smooth=True), 0.7,
                           (0.0, 0.7, 0.0))
    return T.make_scene(ground, ico, bvh_leaf_size=leaf_size)


def _sphere_bvh_scene():
    """One-Weekend's full grid: 487 spheres behind their BVH."""
    return T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11), sphere_bvh=True)


def _unpack(rec: torch.Tensor):
    """(bmin, bmax, miss, start, count) of node records; start -1 and count
    0 for an inner node."""
    words = rec.view(torch.int32)
    link = words[:, 7]
    leaf = link >= 0
    start = torch.where(leaf, link >> BITS, -1)
    count = torch.where(leaf, link & ((1 << BITS) - 1), 0)
    return rec[:, 0:3], rec[:, 3:6], words[:, 6], start, count


@pytest.mark.parametrize("name", ["icosphere3", "icosphere4_leaf8", "sphere_bvh_487"])
def test_node_records_unpack_to_bvh_planes(name):
    """The records hold the BVH's bounds and links bit for bit (the JAX
    package's bvh_planes layout: tests/test_torch_bvh.py holds them to it)."""
    sc = {"icosphere3": lambda: _mesh_scene(3), "icosphere4_leaf8": lambda: _mesh_scene(4, 8),
          "sphere_bvh_487": _sphere_bvh_scene}[name]()
    bvh = sc.sphere_bvh if name.startswith("sphere") else sc.bvh
    rec = mk.bvh_nodes(bvh, sc.spheres.count if name.startswith("sphere")
                       else sc.mesh.num_triangles)
    assert rec.shape == (bvh.num_nodes, 8) and rec.dtype == torch.float32
    assert rec.is_contiguous() and rec.stride(0) * 4 == 32  # two float4, one sector
    bmin, bmax, miss, start, count = _unpack(rec)
    assert torch.equal(bmin.view(torch.int32), bvh.bbox_min.view(torch.int32))
    assert torch.equal(bmax.view(torch.int32), bvh.bbox_max.view(torch.int32))
    assert torch.equal(miss, bvh.miss_link)
    leaf = bvh.leaf_start >= 0
    assert torch.equal(start, torch.where(leaf, bvh.leaf_start, -1))
    assert torch.equal(count[leaf], bvh.leaf_count[leaf])
    assert int(count[leaf].min()) > 0 and (count[~leaf] == 0).all()


def test_face_records_are_the_tables_first_twelve_slots():
    sc = _mesh_scene(3)
    table = mk.mesh_table(sc.mesh)
    faces = mk.face_records(table)
    assert faces.shape == (sc.mesh.num_triangles, 12) and faces.is_contiguous()
    assert torch.equal(faces.view(torch.int32), table[:, :12].contiguous().view(torch.int32))
    # v0, e1, e2 as the kernel's tri_rows reads them from three float4.
    r = faces.reshape(-1, 3, 4)
    assert torch.equal(r[:, 0, 0:3], sc.mesh.v0)
    assert torch.equal(torch.stack([r[:, 0, 3], r[:, 1, 0], r[:, 1, 1]], 1), sc.mesh.e1)
    assert torch.equal(torch.stack([r[:, 1, 2], r[:, 1, 3], r[:, 2, 0]], 1), sc.mesh.e2)


def _records_walk(o, d, nodes, leaf):
    """The kernels' walk_nodes, one ray at a time, reading only the node
    records: each node's eight words at once, the links from their int
    bits.  `leaf(start, count, tb)` tests a leaf against the window and
    returns the new (tb, winner or None).  Returns (tb, winner, nodes,
    leaves)."""
    rec = nodes.numpy()
    words = rec.view(np.int32)
    inv = (np.float32(1.0) / np.where(np.abs(d) < 1e-20, np.float32(1e-20), d)).astype(np.float32)
    tb, best, node, visits, leaves = np.float32(TMAX), -1, 0, 0, 0
    while node >= 0:
        visits += 1
        a = rec[node]
        t0 = (a[0:3] - o) * inv
        t1 = (a[3:6] - o) * inv
        tn, tf = np.max(np.minimum(t0, t1)), np.min(np.maximum(t0, t1))
        enter = tf >= max(tn, np.float32(TMIN)) and tn < tb
        link = int(words[node, 7])
        if enter and link >= 0:
            leaves += 1
            tb, won = leaf(link >> BITS, link & ((1 << BITS) - 1), tb)
            best = best if won is None else won
        node = node + 1 if enter and link < 0 else int(words[node, 6])
    return tb, best, visits, leaves


def test_a_walk_of_the_records_finds_the_plain_mesh_walks_hits():
    """icosphere(3) behind its BVH: the records walk with the faces read
    from the face records gives intersect_bvh's hits, winners, t and
    counted nodes, leaves and faces, ray for ray."""
    sc = _mesh_scene(3)
    nodes = mk.bvh_nodes(sc.bvh, sc.mesh.num_triangles)
    faces = mk.face_records(mk.mesh_table(sc.mesh)).reshape(-1, 3, 4)
    v0 = faces[:, 0, 0:3]
    e1 = torch.stack([faces[:, 0, 3], faces[:, 1, 0], faces[:, 1, 1]], 1)
    e2 = torch.stack([faces[:, 1, 2], faces[:, 1, 3], faces[:, 2, 0]], 1)
    rng = np.random.default_rng(3)
    o = rng.uniform(-2.5, 2.5, (120, 3)).astype(np.float32) + np.float32([0, 0.7, 0])
    d = (rng.uniform(-0.6, 0.6, (120, 3)) + np.float32([0, 0.7, 0]) - o).astype(np.float32)
    tx.BVH_VISITS = {}
    try:
        hit = tx.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), sc.mesh, sc.bvh, TMIN,
                               TMAX, count="closest")
        got = dict(tx.BVH_VISITS["closest"])
    finally:
        tx.BVH_VISITS = None
    want = {"nodes": 0, "leaves": 0, "faces": 0}
    for r in range(o.shape[0]):
        ot, dt = torch.from_numpy(o[r]), torch.from_numpy(d[r])

        def leaf(start, count, tb):
            won = None
            for j in range(start, start + count):
                want["faces"] += 1
                t, _, _, ok = tx._moller_trumbore(ot, dt, v0[j], e1[j], e2[j], TMIN, float(tb))
                if bool(ok):
                    tb, won = np.float32(float(t)), j
            return tb, won

        tb, best, visits, leaves = _records_walk(o[r], d[r], nodes, leaf)
        want["nodes"] += visits
        want["leaves"] += leaves
        assert bool(hit.hit[r]) == (best >= 0)
        if best >= 0:
            assert int(hit.idx[r]) == best and float(hit.t[r]) == float(tb)
    assert got == want
    assert 0 < int(hit.hit.sum()) < o.shape[0]


def test_a_walk_of_the_records_finds_the_plain_sphere_walks_hits():
    """One-Weekend's 487 spheres behind their BVH: the records walk gives
    walk_sphere_bvh's winners, t and counted nodes, leaves, sphere tests
    and roots, ray for ray."""
    sc = _sphere_bvh_scene()
    nodes, sp = mk.bvh_nodes(sc.sphere_bvh, sc.spheres.count), sc.spheres
    o, d = _rays_outside(sc, 7, 60)
    tx.BVH_VISITS = {}
    try:
        t, idx, hit = tx.walk_sphere_bvh(torch.from_numpy(o), torch.from_numpy(d), sp,
                                         sc.sphere_bvh, TMIN, TMAX, count="closest")
        got = dict(tx.BVH_VISITS["closest"])
    finally:
        tx.BVH_VISITS = None
    want = {"nodes": 0, "leaves": 0, "spheres": 0, "roots": 0}
    for r in range(o.shape[0]):
        ot, dt = torch.from_numpy(o[r])[None, None], torch.from_numpy(d[r])[None, None]

        def leaf(start, count, tb):
            won = None
            for j in range(start, start + count):
                tally = {"tests": 0, "roots": 0}
                root, valid = tx._roots(ot, dt, sp.centers[j][None, None],
                                        sp.radii[j][None, None], TMIN,
                                        torch.full((1, 1), float(tb)), tally)
                want["spheres"] += int(tally["tests"])
                want["roots"] += int(tally["roots"])
                if bool(valid):
                    tb, won = np.float32(float(root)), j
            return tb, won

        tb, best, visits, leaves = _records_walk(o[r], d[r], nodes, leaf)
        want["nodes"] += visits
        want["leaves"] += leaves
        assert int(idx[r]) == best and bool(hit[r]) == (best >= 0)
        if best >= 0:
            assert float(t[r]) == float(tb)
    assert got == want
    assert bool(hit.any()) and not bool(hit.all())


def test_a_bvh_the_records_cannot_hold_is_refused_before_any_launch():
    """A BVH built with leaves of up to 2^8 faces (a leaf size of 512 over
    icosphere(3)'s 1,280, which makes leaves of 320) does not fit start <<
    8 | count: pack_scene raises, and nothing is launched.  So does one
    over more than 2^23 primitives (a start at 2^23), decided from the
    counts alone.  The largest start and count that fit pack and unpack
    exactly."""
    big_leaf = _mesh_scene(3, leaf_size=512)
    assert int(big_leaf.bvh.leaf_count.max()) >= 1 << BITS
    mk.LAUNCHES.clear()
    with pytest.raises(ValueError, match="BVH nodes hold a leaf of at most 255"):
        mk.pack_scene(big_leaf, False, False, None)
    sc = _mesh_scene(3)
    with pytest.raises(ValueError, match="out of at most 2\\^23"):
        mk.bvh_nodes(sc.bvh, (1 << 23) + 1)
    assert not mk.LAUNCHES
    mk.bvh_nodes(dataclasses.replace(sc.bvh, leaf_size=255), 1 << 23)
    edge = dataclasses.replace(
        sc.bvh, leaf_size=255,
        leaf_start=torch.where(sc.bvh.leaf_start >= 0,
                               torch.full_like(sc.bvh.leaf_start, (1 << 23) - 1), -1),
        leaf_count=torch.where(sc.bvh.leaf_start >= 0,
                               torch.full_like(sc.bvh.leaf_count, 255), sc.bvh.leaf_count))
    _, _, _, start, count = _unpack(mk.bvh_nodes(edge, 1 << 23))
    leaf = edge.leaf_start >= 0
    assert (start[leaf] == (1 << 23) - 1).all() and (count[leaf] == 255).all()
    assert (start[~leaf] == -1).all()
    packed = mk.pack_scene(sc, False, False, None)
    assert any(t is not None and t.shape == (sc.bvh.num_nodes, 8) for t in packed.tensors)
