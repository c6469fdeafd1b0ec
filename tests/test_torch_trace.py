"""The port's own spans and counters (``wiflow_tpu_torch/utils/trace.py``)
on the CPU, at small shapes: how spans nest, that nothing is recorded
while tracing is off, the span trees of the served forwards and the train
step, the stream layer's row counters, and ``cli.run --profile_dir``'s
trace with the spans merged in."""

import json
import os

import numpy as np
import pytest
import torch

from wiflow_tpu_torch.cli import run
from wiflow_tpu_torch.core.config import LossConfig, ModelConfig, OptimConfig
from wiflow_tpu_torch.data.synthetic import make_preprocessed_dataset
from wiflow_tpu_torch.eval.streaming import make_stream_infer
from wiflow_tpu_torch.models.fast import (
    fast_forward, fast_forward_mmfi, pack_fast, pack_fast_mmfi,
)
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.train.steps import create_train_state, train_step
from wiflow_tpu_torch.utils import trace

SMALL = ModelConfig(num_subcarriers=40, tcn_channels=(40, 240), tcn_groups=4,
                    conv_channels=(4, 8, 16, 32), attention_groups=4,
                    compute_dtype="float32")
SERVE = ["serve.prep", "serve.tcn", "serve.conv_stack", "serve.attention",
         "serve.decode"]
TRAIN = ["train.forward", "train.loss", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def _tracer_off_and_empty():
    """Each test starts and leaves the process's tracer off and empty, on
    one intra-op thread (the test workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()
    torch.set_num_threads(n)


def tree(spans):
    """``{root name: [child names in start order]}`` of one request, and
    the request ids seen."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    assert len(roots) == 1, roots
    kids = sorted((s for s in spans if s.parent == roots[0].id),
                  key=lambda s: s.start_ns)
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    return roots[0].name, [k.name for k in kids], {s.request for s in spans}


def small_wiflow():
    model = WiFlowPoseModel(SMALL, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    return model, pack_fast(model.state_dict(), SMALL, device="cpu")


def small_mmfi():
    cfg = MMFiModelConfig(compute_dtype="float32")
    model = WiFlowMMFiModel(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    return cfg, model, pack_fast_mmfi(model.state_dict(), cfg, device="cpu")


def test_spans_nest_carry_parent_and_request():
    t = trace.Tracer()
    t.enable()
    with t.span("a"):
        with t.span("b"):
            with t.span("c"):
                pass
        with t.span("d"):
            pass
    with t.span("e"):
        pass
    t.count("n", 2)
    t.count("n", 3)
    got = t.collect()
    s = {x.name: x for x in got.spans}
    assert [x.name for x in got.spans] == ["c", "b", "d", "a", "e"]
    assert s["a"].parent == 0 and s["e"].parent == 0
    assert s["b"].parent == s["d"].parent == s["a"].id
    assert s["c"].parent == s["b"].id
    assert {s[k].request for k in "abcd"} == {s["a"].request}
    assert s["e"].request != s["a"].request
    assert all(x.start_ns <= x.end_ns for x in got.spans)
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].end_ns \
        <= s["d"].start_ns <= s["a"].end_ns <= s["e"].start_ns
    assert got.counts == {"n": 5}
    assert t.collect() == ([], {})


def test_off_records_nothing_and_shares_one_no_op():
    t = trace.Tracer()
    assert t.span("a") is t.span("b") is trace.NO_SPAN
    with t.span("a"):
        t.count("n")
    assert t.collect() == ([], {})


def test_anchor_and_chrome_events():
    at = trace.anchor()
    s = trace.Span("x", at[0] + 5_000, at[0] + 7_500, 1, 0, 1)
    (e,) = trace.chrome_events([s], at, at[1] - 1_000_000, pid=3, tid=4)
    assert (e["name"], e["ph"], e["cat"], e["pid"], e["tid"]) == (
        "x", "X", "program_span", 3, 4)
    assert e["ts"] == pytest.approx(1_005.0) and e["dur"] == 2.5
    assert e["args"] == {"id": 1, "parent": 0, "request": 1}


def test_off_fast_forward_and_train_step_record_nothing():
    model, packed = small_wiflow()
    fast_forward(packed, torch.randn(2, 40, 20))
    state = create_train_state(optim=OptimConfig(), model=model)
    train_step(state, torch.randn(4, 40, 20), torch.rand(4, 15, 2))
    assert trace.collect() == ([], {})


@pytest.mark.parametrize("kw", [{}, {"fuse_tcn": False,
                                     "fuse_conv_stack": False}])
def test_fast_forward_span_tree(kw):
    _, packed = small_wiflow()
    trace.enable()
    fast_forward(packed, torch.randn(2, 40, 20), **kw)
    got = trace.collect()
    root, kids, requests = tree(got.spans)
    assert (root, kids) == ("serve.forward", SERVE)
    assert len(requests) == 1 and got.counts == {}


def test_fast_forward_mmfi_span_tree():
    cfg, _, packed = small_mmfi()
    trace.enable()
    fast_forward_mmfi(packed, torch.randn(2, 3, 114, 10))
    root, kids, _ = tree(trace.collect().spans)
    assert (root, kids) == ("serve.forward", SERVE[:2] + ["serve.project"]
                            + SERVE[2:])


@pytest.mark.parametrize("model_kind", ["wiflow", "mmfi"])
def test_train_step_span_tree(model_kind):
    if model_kind == "wiflow":
        model, _ = small_wiflow()
        x, y = torch.randn(4, 40, 20), torch.rand(4, 15, 2)
    else:
        _, model, _ = small_mmfi()
        x, y = torch.randn(4, 3, 114, 10), torch.rand(4, 17, 3)
    state = create_train_state(optim=OptimConfig(), model=model)
    trace.enable()
    train_step(state, x, y, LossConfig())
    got = trace.collect()
    root, kids, requests = tree(got.spans)
    assert (root, kids) == ("train.step", TRAIN)
    assert len(got.spans) == 5 and len(requests) == 1
    assert got.counts == {"train.steps": 1}


def test_train_step_micro_batches_repeat_forward_loss_backward():
    model, _ = small_wiflow()
    state = create_train_state(optim=OptimConfig(), model=model)
    trace.enable()
    train_step(state, torch.randn(4, 40, 20), torch.rand(4, 15, 2),
               grad_accum_steps=2)
    _, kids, _ = tree(trace.collect().spans)
    assert kids == TRAIN[:3] * 2 + TRAIN[3:]


@pytest.mark.parametrize("frames", [24, 60, 63, 64, 101])
def test_stream_counters(frames):
    batch, window = 16, 20
    infer = make_stream_infer(lambda b: b[:, :2, :3].transpose(1, 2),
                              window=window, batch=batch, device="cpu")
    trace.enable()
    out = infer(np.random.default_rng(frames).normal(
        size=(frames, 8)).astype(np.float32))
    got = trace.collect()
    n = frames - window + 1
    pad = (-n) % batch
    assert out.shape == (n, 3, 2)
    assert got.counts == {"stream.rows": n + pad, "stream.pad_rows": pad}
    root, kids, _ = tree(got.spans)
    assert (root, kids) == ("stream.request",
                            ["stream.windows", "stream.gather"])


def test_stream_over_fast_forward_nests_serve_forward():
    _, packed = small_wiflow()
    infer = make_stream_infer(lambda b: fast_forward(packed, b), window=20,
                              batch=8, device="cpu")
    trace.enable()
    infer(torch.randn(30, 40))
    root, kids, requests = tree(trace.collect().spans)
    assert root == "stream.request" and len(requests) == 1
    assert kids == ["stream.windows", "serve.forward", "serve.forward",
                    "stream.gather"]


def test_profile_dir_trace_holds_train_step_spans(tmp_path):
    data_dir = make_preprocessed_dataset(str(tmp_path / "data"), num_files=8,
                                         frames_per_file=40)
    prof = tmp_path / "prof"
    args = ["--data_dir", data_dir, "--output_dir", str(tmp_path / "out"),
            "--device", "cpu", "--compute_dtype", "float32", "--no_videos",
            "--batch_size", "32", "--epochs", "1", "--no_resume",
            "--profile_dir", str(prof)]
    assert run.main(args) == 0
    assert not trace.TRACER.on
    with open(prof / "trace.json") as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    steps = [e for e in ev if e.get("cat") == "program_span"
             and e["name"] == "train.step"]
    assert steps and doc["programCounters"]["train.steps"] == len(steps)
    names = {e["name"] for e in ev if e.get("cat") == "program_span"}
    assert set(TRAIN) <= names
    # on the profiler's clock: each step holds the convolutions its
    # forward runs (the profiler's host clock and the anchor's agree
    # to well under a millisecond)
    convs = [e["ts"] for e in ev if e.get("name") == "aten::convolution"]
    for s in steps:
        assert any(s["ts"] - 1e3 <= t <= s["ts"] + s["dur"] + 1e3
                   for t in convs)
    assert os.path.exists(tmp_path / "out" / "training_history.csv")
