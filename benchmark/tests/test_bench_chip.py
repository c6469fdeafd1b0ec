"""Each cell, run for a few seconds on the card through ``run.py``'s
command line, prints a last line with the result's keys.  On the CPU it
skips.

    python3 -m pytest benchmark/tests/test_bench_chip.py -m chip
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_its_result(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 5), "--seconds", "4",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert out["device"]["busy_s"] > 0
        assert len(out["breakdown"]["device_ops"]) <= 10
    for m in out["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100
