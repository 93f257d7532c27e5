"""BENCHMARK.json and the files it names: configurations, traffic mixes,
scene generators, the program's entries and per-layer metric readers.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by name:

  rtbench/configs/<config>.json     the configuration (scene, frame, limits)
  rtbench/traffic/<traffic>.json    the mix (entry point, backend, spp, loop)
  rtbench/scenes/<scene>.py         make(params, seed) -> SceneData
  rtbench/entries/<entry>.py        the program's entry point the window drives
  rtbench/metrics/<metric>.py       read(trace) -> float or None

so a later change adds a cell or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with everything it names, resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the BENCHMARK.json metric entries this cell reports
    per_layer: tuple


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload`, its configuration and traffic loaded."""
    matches = [w for w in bench["workloads"] if w["name"] == workload]
    if not matches:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = matches[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _reported(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if _reported(m, workload)),
    )


def load_module(kind: str, name: str):
    """rtbench/<kind>/<name>.py, loaded by its path (names may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    qual = f"rtbench.{kind}.{name}"
    if qual in sys.modules:
        return sys.modules[qual]
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    found = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(found)
    sys.modules[qual] = mod
    found.loader.exec_module(mod)
    return mod


def scene_data(config: dict, seed: int):
    """The configuration's scene drawn from `seed` (plain NumPy data)."""
    return load_module("scenes", config["scene"]).make(config["params"], seed)


def trace_options(config: dict) -> dict:
    """The integrator's options (the reference's tracer.Options)."""
    integ = config["integrator"]
    return dict(max_depth=int(config["max_depth"]),
                rr_depth=int(integ.get("russian_roulette_depth", 0)),
                sky_intensity=float(integ.get("sky_intensity", 1.0)),
                nee=bool(integ.get("nee", False)), mis=bool(integ.get("mis", False)))


def validate(bench: dict) -> list[str]:
    """What the benchmark's contract refuses in `bench`'s names and units."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[key]]
        bad += [f"{key}: name {n!r}" for n in names if not NAME.match(n)]
        bad += [f"{key}: {n!r} twice" for n in set(names) if names.count(n) > 1]
    for w in bench["workloads"]:
        bad += [f"workload {w['name']}: {k} {w[k]!r}" for k in ("config", "traffic")
                if not NAME.match(w[k])]
    for c in bench["configs"]:
        bad += [f"config {c['name']}: reduced {k!r}" for k in c["reduced"]
                if not NAME.match(k)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            bad.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            bad.append(f"metric {m['name']}: better {m['better']!r}")
    return bad
