"""One run of one cell: set-up, the measured window, the traced window's
reading, the check against the reference, and the result line.

A cell on one card runs in this process.  A cell on several cards runs one
process a rank: this process is rank 0 and prints the line; it starts the
other ranks as subprocesses of the same command (`--rank`, `--world`,
`--port`), joins them in a process group over localhost, and waits for
each before it exits.  Every rank runs the same loop: the collectives of
the program keep them in step, and every 8 frames the ranks agree whether
the window is over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from rtbench import check, spec, stats
from rtbench.trace import CALL, WINDOW, TraceView, summarize

FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_ray_tracing_tpu"}
STOP_EVERY = 8  # frames between the ranks' agreements on the window's end
TRACE_SECONDS = 2.0  # the longest traced part of a --trace 1 window


class NotRunnable(RuntimeError):
    """The run cannot measure: no card, too few cards, or a forbidden import."""


@dataclasses.dataclass
class Options:
    workload: str
    seed: int
    seconds: float
    trace: bool
    rank: int = 0
    world: int = 1
    port: int = 0
    device: str = "cuda"  # "cpu": the plain backends, for the harness's own tests


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_of(opt: Options) -> torch.device:
    if opt.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", opt.rank % max(1, torch.cuda.device_count()))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _marker(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _start_trace(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    if dist.is_initialized():
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM)
    return t


def gather_objects(obj, world: int) -> list:
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def init_group(opt: Options, dev: torch.device) -> None:
    """Join the ranks' process group over localhost (NCCL on cards, gloo on
    the CPU); nothing on one rank."""
    if opt.world > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{opt.port}",
                                world_size=opt.world, rank=opt.rank)


def run_rank(cell: spec.Cell, opt: Options, t0: float) -> dict:
    """Set up, measure, read the trace and check, on this rank.  Returns what
    rank 0 needs for the line (every rank's share already combined)."""
    dev = device_of(opt)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_group(opt, dev)
    tr = cell.traffic
    data = spec.scene_data(cell.config, opt.seed)
    entry = spec.load_module("entries", tr["entry"])
    prog = entry.setup(cell, data, dev)
    for j in range(int(tr.get("warmup_frames", 3))):
        img = prog.frame(check.frame_seed(opt.seed, 0xFFFF - j))
        sync(dev)
    rays = prog.rays_traced(check.frame_seed(opt.seed, 0)) if opt.trace and opt.rank == 0 else 0.0
    w, h = cell.config["width"], cell.config["height"]
    keep = check.Reservoir(opt.seed, int(tr["check_frames"]), int(tr["check_pixels"]), w, h, dev)
    keep.warm(img)
    del img
    if opt.world > 1:
        dist.barrier()
        all_reduce(torch.zeros(1, device=dev), dist.ReduceOp.MAX)
    sync(dev)

    # With --trace 1 the profiler covers the window's last part only, at
    # most TRACE_SECONDS: the first part times the host's enqueue without
    # the profiler's own cost, and the trace stays short to read.
    trace_s = min(opt.seconds / 2, TRACE_SECONDS)
    traced_from = opt.seconds - trace_s if opt.trace else None
    prof, span, k_traced, t_traced, untraced_frame_s = None, None, None, 0.0, 0.0
    lat, enq = [], []
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    k, t_end = 0, t_w0
    while True:
        if traced_from is not None and prof is None and t_end - t_w0 >= traced_from:
            untraced_frame_s = (t_end - t_w0) / k
            prof, span, k_traced = _start_trace(dev), torch.profiler.record_function(WINDOW), k
            span.__enter__()
            t_traced = time.perf_counter()
        on = prof is not None
        ta = time.perf_counter()
        with _marker(on, CALL):
            img = prog.frame(check.frame_seed(opt.seed, k))
        te = time.perf_counter()
        with _marker(on, "rtbench.sync"):
            sync(dev)
        t_end = time.perf_counter()
        lat.append(t_end - ta)
        enq.append(te - ta)
        keep.offer(k, img)
        del img
        k += 1
        # The window ends at `seconds`; a traced window not before it has
        # been traced for trace_s (the profiler's start takes seconds).
        over = t_end - t_w0 >= opt.seconds and (
            traced_from is None or (prof is not None and t_end - t_traced >= trace_s))
        if opt.world == 1:
            if over:
                break
        elif k % STOP_EVERY == 0:
            done = torch.tensor([float(over)], device=dev)
            if float(all_reduce(done, dist.ReduceOp.MAX)) > 0.0:
                break
    sync(dev)
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    window_s = t_end - t_w0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rank_trace = summarize(prof.events()) if prof is not None else None
    del prof, span

    # The program's state goes before the reference runs.
    pixels, frames, got = keep.pixels, keep.frames(), keep.values()
    del prog, keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_values(cell.config, data, opt.seed, frames, pixels, tr["spp"],
                                 rank=opt.rank, world=opt.world)
    ref = all_reduce(ref)
    per_frame = check.sums(got.reshape(len(frames), -1, 3), ref.reshape(len(frames), -1, 3))
    per_frame = all_reduce(per_frame)

    lat_t = all_reduce(torch.tensor(lat, dtype=torch.float64, device=dev), dist.ReduceOp.MAX)
    shared = gather_objects(dict(peak=int(peak), trace=rank_trace,
                                  forbidden=forbidden_modules()), opt.world)
    if opt.world > 1:
        dist.destroy_process_group()
    call_ms = 1e3 * sum(enq) / k
    return dict(setup_s=setup_s, window_s=window_s, frames=k, latencies=lat_t.cpu().tolist(),
                call_ms=call_ms, wait_ms=1e3 * sum(lat) / k - call_ms, enqueue=enq[:k_traced],
                untraced_frame_s=untraced_frame_s, rays=rays, per_frame=per_frame.cpu(),
                check_frames=frames, ranks=shared, device=dev)


def result(cell: spec.Cell, opt: Options, out: dict) -> dict:
    """The result line's object from rank 0's run."""
    limits = cell.config.get("limits")
    pooled, failed, correct = check.decide(out["per_frame"], limits)
    correct = correct and not any(r["forbidden"] for r in out["ranks"])
    dev = out["device"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": max(r["peak"] for r in out["ranks"])}
    metrics, extra = {}, {}
    if opt.trace:
        traces = [r["trace"] for r in out["ranks"]]
        view = TraceView(ranks=traces, enqueue_s=out["enqueue"],
                         untraced_frame_s=out["untraced_frame_s"],
                         rays_traced=out["rays"],
                         work_per_ray_flops=cell.config.get("work_per_ray_flops") or 0.0,
                         width=cell.config["width"], height=cell.config["height"], kind=kind)
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        device["window_s"] = sum(t.window_s for t in traces) / len(traces)
        ops: dict = {}
        for t in traces:
            for key, s in t.kernel_s.items():
                ops[key] = ops.get(key, 0.0) + s
        extra["breakdown"] = {
            "device_ops": [[k, s] for k, s in sorted(ops.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[label, s] for label, s in traces[0].gaps[:10]],
        }
    else:
        values = {"frame_ms": stats.frame_ms(out["window_s"], out["frames"]),
                  "frame_ms_p95": stats.p95_ms(out["latencies"]),
                  "setup_s": out["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    compared = {n: {"value": pooled[n], "limit": (limits or {}).get(n)} for n in check.NUMBERS}
    compared["nonfinite"] = {"value": pooled["nonfinite"], "limit": 0}
    line = {"correct": bool(correct), "attempted": out["frames"], "failed": int(failed),
            "metrics": metrics, "device": device, **extra,
            "checked_frames": out["check_frames"], "compared": compared}
    return line


def spawn_ranks(script: str, argv: list[str], world: int, port: int) -> list[subprocess.Popen]:
    """Ranks 1 .. world-1 as subprocesses of `script` with `argv`."""
    return [subprocess.Popen([sys.executable, script, *argv, "--rank", str(r), "--world",
                              str(world), "--port", str(port)],
                             stdout=subprocess.DEVNULL, cwd=os.getcwd())
            for r in range(1, world)]


def main(opt: Options, argv: list[str], t0: float) -> int:
    """Run the cell; rank 0 prints the compared numbers on standard error and
    the result as the last line of standard output.  Returns the exit code."""
    cell = spec.cell(spec.load_benchmark(), opt.workload)
    if opt.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NotRunnable(f"the cell needs {cell.chips} CUDA device(s); "
                              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                              " visible")
    children = []
    if cell.chips > 1 and opt.rank == 0:
        opt = dataclasses.replace(opt, world=cell.chips, port=opt.port or free_port())
        children = spawn_ranks(os.path.join(spec.HERE, "run.py"), argv, opt.world, opt.port)
    try:
        out = run_rank(cell, opt, t0)
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        codes = [c.wait() for c in children]
    if opt.rank != 0:
        return 0
    if any(codes):
        raise NotRunnable(f"a rank exited with {codes}")
    line = result(cell, opt, out)
    found = forbidden_modules() + [m for r in out["ranks"] for m in r["forbidden"]]
    if found:
        raise NotRunnable(f"forbidden modules loaded: {sorted(set(found))}")
    _power(out["device"])
    q = statistics.quantiles(out["latencies"], n=4) if len(out["latencies"]) > 1 else [0.0] * 3
    print(f"window: {out['frames']} frames in {out['window_s']:.3f} s; latency ms quartiles "
          f"{q[0] * 1e3:.3f} / {q[1] * 1e3:.3f} / {q[2] * 1e3:.3f}, max "
          f"{max(out['latencies']) * 1e3:.3f}; mean ms in the call {out['call_ms']:.3f}, waiting "
          f"for the card {out['wait_ms']:.3f}; checked frames {out['check_frames']}",
          file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


def _power(dev: torch.device) -> None:
    """The card's name and power limit on standard error, beside the numbers."""
    if dev.type != "cuda":
        return
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", f"--id={dev.index}"],
                           capture_output=True, text=True, timeout=20)
        print(f"card: {q.stdout.strip()}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"card: nvidia-smi not read ({e})", file=sys.stderr)
