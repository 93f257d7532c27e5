"""The readings a cell's limits are set from, in one process a rank:

    python3 rtbench/calibrate.py --workload <name> --seeds 11,12,... [--frames 4]

For each seed it builds the cell's program as a run does, renders frames
0 .. frames-1 of that seed through the timed call, and compares their
sampled pixels (the run's draws) with the reference: the program's
readings, the lower ends of the limits.  At the same pixels it puts the
control in the program's place, the reference computed with its scene,
camera and path state in bfloat16, the precision below the configuration's
float32, and compares that: the upper ends.  One JSON line a seed goes to
standard output.  The benchmark's own runs never run this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from rtbench import check, harness, spec  # noqa: E402


def readings(cell, opt, seeds, frames: int, control: bool = True):
    dev = harness.device_of(opt)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    harness.init_group(opt, dev)
    tr = cell.traffic
    entry = spec.load_module("entries", tr["entry"])
    w, h = cell.config["width"], cell.config["height"]
    for seed in seeds:
        t0 = time.perf_counter()
        data = spec.scene_data(cell.config, seed)
        prog = entry.setup(cell, data, dev)
        keep = check.Reservoir(seed, frames, int(tr["check_pixels"]), w, h, dev)
        for k in range(frames):
            keep.offer(k, prog.frame(check.frame_seed(seed, k)))
        harness.sync(dev)
        t1 = time.perf_counter()
        ks, got = keep.frames(), keep.values()
        del prog, keep
        row = {"seed": seed, "frames": ks, "program_s": t1 - t0}
        pixels = check.Reservoir(seed, frames, int(tr["check_pixels"]), w, h, dev).pixels
        ref = harness.all_reduce(check.reference_values(
            cell.config, data, seed, ks, pixels, tr["spp"], rank=opt.rank, world=opt.world))
        row["reference_s"] = time.perf_counter() - t1
        shape = (len(ks), -1, 3)
        row["program"] = check.readings(harness.all_reduce(
            check.sums(got.reshape(shape), ref.reshape(shape))).sum(0))
        if control:
            ctl = harness.all_reduce(check.reference_values(
                cell.config, data, seed, ks, pixels, tr["spp"],
                rank=opt.rank, world=opt.world, precision=torch.bfloat16))
            row["control"] = check.readings(check.sums(ctl.reshape(shape),
                                                       ref.reshape(shape)).sum(0))
        yield row


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), a.workload)
    opt = harness.Options(a.workload, 0, 0.0, False, rank=a.rank, world=a.world, port=a.port)
    children = []
    if cell.chips > 1 and a.rank == 0:
        opt = harness.Options(a.workload, 0, 0.0, False, world=cell.chips,
                              port=harness.free_port())
        children = harness.spawn_ranks(os.path.abspath(__file__), argv, opt.world, opt.port)
    try:
        for row in readings(cell, opt, [int(s) for s in a.seeds.split(",")], a.frames,
                            not a.no_control):
            if opt.rank == 0:
                print(json.dumps(row), flush=True)
    finally:
        codes = [c.wait() for c in children]
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
