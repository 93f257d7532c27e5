"""The control fails every cell's limits: the reference in the program's
place, its scene, camera and path state in bfloat16 (the precision below
the configurations' float32), compared with the reference in float32 at a
size a test run holds.  On the card, at the cells' own sizes, the control
read 51-81% of pixels flipped (rtbench/calibrate.py; PERF.md)."""

import pytest
import torch

from rtbench import check, spec

import tiny

CELLS = ["one_weekend_720p.frame16", "cornell_box_600.frame16", "one_weekend_1080p.rows4"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = tiny.cell(name, width=48, height=36)
    data = spec.scene_data(c.config, tiny.SEED)
    pixels = torch.arange(48 * 36)
    ref = check.reference_values(c.config, data, tiny.SEED, [0, 1], pixels, c.traffic["spp"])
    ctl = check.reference_values(c.config, data, tiny.SEED, [0, 1], pixels, c.traffic["spp"],
                                 precision=torch.bfloat16)
    read = check.readings(check.sums(ctl.reshape(2, -1, 3), ref.reshape(2, -1, 3)).sum(0))
    assert not check.verdict(read, c.config["limits"])
    assert read["flip_frac"] > 3 * c.config["limits"]["flip_frac"]
    same = check.readings(check.sums(ref.reshape(2, -1, 3), ref.reshape(2, -1, 3)).sum(0))
    assert check.verdict(same, c.config["limits"])
