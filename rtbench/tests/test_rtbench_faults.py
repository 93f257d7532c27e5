"""A run whose timed path is broken underneath comes out not correct.

The harness runs each cell on the CPU (its look for a card skipped, the
program's plain backends in the kernels' place) at a small size, once
sound and once with each fault a frame cell can have planted in the
program: a frame returned unchanged from an earlier call (a step that
returns its state unchanged), half the samples traced and the mean taken
over them (half of the batch left out), every pixel scaled as if the sum
were divided by spp - 1 (an answer altered where it is produced), and on
the four-rank cell the gather of the bands left out (the exchange between
chips)."""

import dataclasses
import multiprocessing as mp
import queue

import pytest
import torch

from gpu_ray_tracing_tpu_torch import api
from gpu_ray_tracing_tpu_torch.parallel import sharding
from rtbench import harness

import tiny

CELLS = ["one_weekend_720p.frame16", "cornell_box_600.frame16", "one_weekend_720p.wavefront16"]


def _stale(render):
    first = []

    def wrapped(scene, camera, config, **kw):
        if not first:
            first.append(render(scene, camera, config, **kw))
        return first[0].clone()
    return wrapped


def _half(render):
    return lambda scene, camera, config, **kw: render(
        scene, camera, dataclasses.replace(config, spp=config.spp // 2), **kw)


def _altered(render):
    return lambda scene, camera, config, **kw: render(scene, camera, config, **kw) * (
        config.spp / (config.spp - 1))


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = tiny.run(tiny.cell(name))
    assert line["correct"], line["compared"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(api, "render", FAULTS[fault](api.render))
    line = tiny.run(tiny.cell(name))
    assert not line["correct"], line["compared"]


def _own_band_only(band, mesh):
    """The gather left out: each rank's frame holds its own band, zeros
    elsewhere."""
    n = sharding._axis_size(mesh, sharding.ROW_AXIS)
    xi = mesh.get_local_rank(sharding.ROW_AXIS)
    out = band.new_zeros((band.shape[0] * n, *band.shape[1:]))
    out[xi * band.shape[0]:(xi + 1) * band.shape[0]] = band
    return out


def _rank(rank, port, fault, results):
    torch.set_num_threads(1)
    if fault:
        sharding._gather_rows = _own_band_only
    line = tiny.run(tiny.cell("one_weekend_1080p.rows4"), seconds=0.3, rank=rank, world=4,
                    port=port)
    if rank == 0:
        results.put(line["correct"])


@pytest.mark.parametrize("fault", [False, True])
def test_rows4_gather_left_out_is_not_correct(fault):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = harness.free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, fault, results)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        correct = results.get(timeout=240)
    except queue.Empty:
        correct = None
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
    assert all(p.exitcode == 0 for p in procs)
    assert correct is (not fault)
