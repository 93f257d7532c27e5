"""The benchmark's one command, run from the root of a checkout:

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It renders the cell's frames through the program (gpu_ray_tracing_tpu_torch)
in a closed loop for `--seconds`, checks frames of the window against the
plain reference, and prints one JSON line last on standard output: the
end-to-end metrics with `--trace 0`, the per-layer metrics with `--trace 1`.
It exits with another code than 0, and prints no line, when the cell's
cards are not there, a rank fails, or JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv: list[str]):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A multi-card cell's other ranks, started by rank 0.
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv: list[str]) -> int:
    args = parse(argv)
    from rtbench import harness  # noqa: PLC0415 - after the path is set

    opt = harness.Options(workload=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), rank=args.rank, world=args.world,
                          port=args.port)
    base = [a for a in argv]
    try:
        return harness.main(opt, base, T0)
    except harness.NotRunnable as e:
        print(f"rtbench: not run: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
