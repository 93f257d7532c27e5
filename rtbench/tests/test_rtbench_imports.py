"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's, so a
prefix would be wrong); the reference imports nothing of the program; and
nothing reads the JAX package's benchmarks/ or the root bench.py."""

import ast
import os
import subprocess
import sys

from rtbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_ray_tracing_tpu"}
PORT = "gpu_ray_tracing_tpu_torch"


def _sources(sub=""):
    base = os.path.join(spec.HERE, sub)
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert PORT not in tops, path
        assert tops <= {"__future__", "ctypes", "dataclasses", "json", "math", "sys", "numpy",
                        "torch", "rtbench"}, (path, tops)
        assert not {n for n in _imports(path) if n.startswith("rtbench.")} - {
            "rtbench.reference", "rtbench.spec", "rtbench.scenes"}, path


def test_nothing_reads_the_jax_benchmarks():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert "benchmarks/" not in text and "bench.py" not in text, path
        assert "import benchmarks" not in text and "from benchmarks" not in text, path


def test_loaded_modules_hold_no_jax():
    """Import everything a run loads (harness, entries, scenes, metrics,
    reference) in a fresh interpreter and read sys.modules by top-level
    name."""
    probe = (
        "import sys\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "from rtbench import calibrate, harness, spec\n"
        "b = spec.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = spec.cell(b, w['name'])\n"
        "    spec.load_module('entries', c.traffic['entry'])\n"
        "    spec.load_module('scenes', c.config['scene'])\n"
        "    [spec.load_module('metrics', m['name']) for m in c.per_layer]\n"
        "import rtbench.reference.work\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    tops, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert PORT in tops
    assert not FORBIDDEN & set(eval(tops))  # noqa: S307 - our own printed list
