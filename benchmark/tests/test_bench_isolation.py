"""What the benchmark loads: no JAX, no JAX package, and a reference that
loads nothing of the program either.  Top-level module names are
compared whole: ``wiflow_tpu_torch`` begins with ``wiflow_tpu`` and is
the measured program."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = ("jax", "jaxlib", "flax", "wiflow_tpu")

_CLOSURE = """
import importlib, pkgutil, sys
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__,
                                               "benchmark.")
         if {only!r} in m.name and ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(len(names), " ".join(tops))
"""


def _tops(only=""):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _CLOSURE.format(only=only)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    count, *tops = r.stdout.split()
    return int(count), set(tops)


def test_run_closure_has_no_jax():
    """Every module the run can load (``run.py`` imports the harness, which
    imports the program, each traffic generator and each metric reader by
    name) and ``run.py`` itself."""
    count, tops = _tops()
    assert count >= 15
    assert "wiflow_tpu_torch" in tops
    assert not tops & set(JAX), tops & set(JAX)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.argv = ['run.py', '--workload', "
         "'wiflow.stream.b4096', '--seed', '1', '--seconds', '1']\n"
         "try:\n    runpy.run_path('benchmark/run.py', run_name='__main__')\n"
         "except SystemExit as e:\n    print('rc', e.code)\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         f"{set(JAX)!r}))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    # no card here: the run refuses, prints no result, and has loaded no JAX
    assert r.stdout.strip().splitlines() == ["rc 2", "[]"], (r.stdout,
                                                              r.stderr)


def test_reference_closure_has_no_program():
    count, tops = _tops("reference")
    assert count >= 2
    assert not tops & {*JAX, "wiflow_tpu_torch"}, tops
