"""Cells cut to a size the CPU runs in seconds, through the plain backends,
for the tests that drive the harness without a card."""

from __future__ import annotations

import dataclasses
import time

from rtbench import harness, spec

PLAIN = {"cuda": "torch", "wavefront": "wavefront_torch"}
SEED = 2**31 + 7


def cell(name: str, width: int = 32, height: int = 24, spp: int = 4) -> spec.Cell:
    """The cell `name` at width x height and spp, its limits as committed."""
    c = spec.cell(spec.load_benchmark(), name)
    tr = dict(c.traffic, backend=PLAIN[c.traffic["backend"]], spp=spp, check_pixels=256,
              check_frames=2, warmup_frames=1)
    return dataclasses.replace(c, config=dict(c.config, width=width, height=height), traffic=tr)


def run(c: spec.Cell, seconds: float = 0.5, trace: bool = False, **opt) -> dict:
    """One run of the cell on the CPU: the result line's object."""
    o = harness.Options(c.name, SEED, seconds, trace, device="cpu", **opt)
    out = harness.run_rank(c, o, time.perf_counter())
    return harness.result(c, o, out) if o.rank == 0 else {}
