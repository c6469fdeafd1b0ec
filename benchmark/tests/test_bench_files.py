"""The benchmark's files: ``BENCHMARK.json`` against its format, every
configuration, cell and metric file parses and names what exists, and a
cell is added by adding files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    cells = len(b["workloads"])
    # a full check: 2 + 14 runs a cell at run_seconds + 60, 2 x 90 s a
    # cell to compile, 1200 s spare, within 43200 s at 24 cells
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)
    names = ([c["name"] for c in b["configs"]] + [w["name"] for w in
             b["workloads"]] + [m["name"] for m in b["end_to_end"]]
             + [m["name"] for m in b["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs_entries_and_files():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


def test_workload_entries_and_files():
    b = bench()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert (BENCH / "traffic" / f"{cell['generator']}.py").exists()
        assert set(cell["check"]["limits"]) and all(
            v >= 0 for v in cell["check"]["limits"].values())


def test_metric_entries_and_files():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        spec = json.loads((BENCH / "metrics" / f"{m['name']}.json")
                          .read_text())
        assert spec["name"] == m["name"]
        assert (BENCH / "metrics" / f"{spec['reader']}.py").exists()
        for cell in m["workloads"]:
            reports = [e["name"] for e in b["end_to_end"]
                       if cell in e.get("workloads", cells)]
            assert m["moves"] in reports, (m["name"], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for cell in cells:
        assert any(cell in m["workloads"] for m in b["per_layer"])
        assert sum(cell in e.get("workloads", cells)
                   for e in b["end_to_end"]) >= 2


def test_every_file_name_is_a_name():
    for sub in ("configs", "workloads", "metrics"):
        for f in (BENCH / sub).glob("*.json"):
            assert NAME.match(f.stem), f


@pytest.mark.parametrize("what", ["cell", "metric"])
def test_new_entry_by_files_alone(tmp_path, what):
    """In a copy of the checkout's benchmark, a new cell (or per-layer
    metric) is one new file and one new entry of ``BENCHMARK.json``; no
    file that is there changes, and the harness lists it."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = bench()
    if what == "cell":
        cell = json.loads((BENCH / "workloads" / "wiflow.stream.b4096.json")
                          .read_text())
        cell["traffic"] = "stream.b2048"
        cell["params"]["batch"] = 2048
        (tmp_path / "benchmark" / "workloads" / "wiflow.stream.b2048.json"
         ).write_text(json.dumps(cell))
        b["workloads"].append({"name": "wiflow.stream.b2048",
                               "config": "wiflow", "traffic": "stream.b2048",
                               "chips": 1, "why": "a smaller stream batch"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "wiflow.stream.b4096" in m.get("workloads", []):
                m["workloads"].append("wiflow.stream.b2048")
        probe = ("c = h.load_cell('wiflow.stream.b2048'); "
                 "print(c['params']['batch'], len(c['per_layer']))")
        want = "2048 7"
    else:
        (tmp_path / "benchmark" / "metrics" / "serve.host_ms_per_request.json"
         ).write_text(json.dumps({"name": "serve.host_ms_per_request",
                                  "reader": "span",
                                  "span": "serve.request"}))
        b["per_layer"].append({"name": "serve.host_ms_per_request",
                               "unit": "ms", "better": "lower",
                               "source": "program_span",
                               "layer": "serving entry",
                               "moves": "serve_p95_ms",
                               "workloads": ["wiflow.stream.b4096"]})
        probe = ("c = h.load_cell('wiflow.stream.b4096'); "
                 "print('serve.host_ms_per_request' in "
                 "[m['name'] for m in c['per_layer']], len(c['per_layer']))")
        want = "True 8"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c",
                        f"from benchmark import harness as h; {probe}"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == want.split()
    after = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and p in before}
    assert after == before


TOY_PROGRAM = '''
"""A toy model standing in for a new model of the program."""
import torch
from torch import nn


class Toy(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        c, t = cfg["channels"], cfg["window_size"]
        self.k, self.d = cfg["num_keypoints"], cfg["keypoint_dims"]
        self.bn = nn.BatchNorm1d(c, device=device)
        self.lin = nn.Linear(c * t, self.k * self.d, device=device)
        self.dropout_generator = torch.Generator(device=device)

    def forward(self, x):
        return self.lin(self.bn(x).flatten(1)).reshape(-1, self.k, self.d)


def serve_forward(sd, cfg, device):
    model = Toy(cfg, device)
    model.load_state_dict(sd)
    model.eval()
    return lambda x: model(x).detach()


def train_model(cfg, device):
    return Toy(cfg, device)
'''

TOY_REFERENCE = '''
"""Reference of the toy model."""
from benchmark.reference.model import bn_spec
from benchmark.reference.train import pose_loss


def input_shape(cfg):
    return (cfg["channels"], cfg["window_size"])


def spec(cfg):
    k = cfg["num_keypoints"] * cfg["keypoint_dims"]
    return bn_spec("bn", cfg["channels"]) + [
        ("lin.weight", (k, cfg["channels"] * cfg["window_size"]), "conv2d"),
        ("lin.bias", (k,), "conv2d_bias")]


def forward(r, x, cfg):
    x = r.bn(r.q(x.float()), "bn", axis=1).flatten(1)
    y = r.q(x @ r.w("lin.weight").T + r.w("lin.bias"))
    return y.reshape(x.shape[0], cfg["num_keypoints"], cfg["keypoint_dims"])


def loss(pred, target, cfg):
    return pose_loss(pred, target, cfg["loss"])


def forward_flops(cfg):
    return 2.0 * (cfg["channels"] * cfg["window_size"] * cfg["num_keypoints"]
                  * cfg["keypoint_dims"])
'''

TOY_RUN = """
import time, torch
from benchmark import harness as h
torch.set_num_threads(2)
for name in ("toy.serve", "toy.train"):
    out = h.run_cell(h.load_cell(name), 2 ** 31 + 3, 0.3, False,
                     torch.device("cpu"), time.perf_counter())
    print(name, out["correct"], out["attempted"] > 0,
          ",".join(sorted(out["metrics"])))
"""


def test_new_configuration_by_files_alone(tmp_path):
    """In a copy of the checkout's benchmark, a configuration of a new
    model (a toy: a BatchNorm and a linear map) is its file, its adapter
    to the program and its reference module, new files all, with a
    serving and a training cell of it; no file that is there changes,
    and both cells run on the CPU through set-up, window and check and
    come out correct."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    wiflow = json.loads((BENCH / "configs" / "wiflow.json").read_text())
    cfg = {"name": "toy", "program": "toy", "reference": "toy",
           "source": "https://example.org/toy", "reduced": [],
           "channels": 6, "window_size": 4, "num_keypoints": 15,
           "keypoint_dims": 2, "dropout": 0.0, "conv_dropout": 0.0,
           "compute_dtype": "float32", "loss": wiflow["loss"],
           "optimizer": wiflow["optimizer"]}
    new = {
        "configs/toy.json": json.dumps(cfg),
        "programs/toy.py": TOY_PROGRAM,
        "reference/toy.py": TOY_REFERENCE,
        "workloads/toy.serve.json": json.dumps({
            "config": "toy", "traffic": "serve", "generator": "sessions",
            "params": {"subjects": 2, "actions": 3, "frames": 16,
                       "max_sequences": 3, "chunk": 32, "check_every": 1},
            "kernels": [], "trace": {"seconds": 0.2},
            "check": {"limits": {"pose_rms": 1e-4}}}),
        "workloads/toy.train.json": json.dumps({
            "config": "toy", "traffic": "train", "generator": "epochs",
            "params": {"windows": 64, "batch": 16, "switches": {},
                       "check_steps": 3, "warm_steps": 1},
            "kernels": [], "trace": {"steps": 2},
            "check": {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4,
                                 "change_gap": 1e-3, "change_worst": 1e-2,
                                 "input_mean_gap": 1e-4}}}),
    }
    for rel, text in new.items():
        assert not (bench_dir / rel).exists()
        (bench_dir / rel).write_text(text)
    b = bench()
    b["configs"].append({"name": "toy", "source": cfg["source"],
                         "file": "benchmark/configs/toy.json", "reduced": [],
                         "why": "a toy model"})
    for name, rate in (("toy.serve", "serve_"), ("toy.train", "train_")):
        b["workloads"].append({"name": name, "config": "toy",
                               "traffic": name.split(".")[1], "chips": 1,
                               "why": "a toy cell"})
        for m in b["end_to_end"]:
            if m["name"].startswith(rate):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[:2] == [
        "toy.serve True True serve_p95_ms,serve_windows_per_s,setup_s",
        "toy.train True True setup_s,train_windows_per_s"], r.stdout
    after = {p: p.read_bytes() for p in bench_dir.rglob("*")
             if p.is_file() and p in before}
    assert after == before
