"""Run one cell of the benchmark of ``wiflow_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``wiflow_tpu_torch`` and
``BENCHMARK.json``, on a machine with a CUDA card.  The cell is
``benchmark/workloads/<cell>.json``.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number with its limit, which the last lines of standard
error repeat.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run stays in the checkout, at a
# fixed path, so that only a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
    # the package is imported as ``benchmark.*`` from the checkout's root;
    # its own folder comes off the path, so that none of its modules
    # stands in for a top-level module of the same name
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if p and Path(p).resolve() != Path(here)]
    from benchmark import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
