"""The plain reference against the program on the CPU in float32, at the
published widths and small batches: the two eval forwards, and three
train steps of each lowering of each configuration with dropout on (the
masks drawn again by the reference from the same seed), from the drawn
weights and from a snapshot of a state a few steps on.  And the weights
the benchmark draws load into the program's modules by name."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import checks, weights
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name, **kw):
    return dict(json.loads((CONFIGS / f"{name}.json").read_text()), **kw)


@pytest.mark.parametrize("name", ["wiflow", "wiflow_mmfi"])
def test_eval_forward_matches_the_program(name):
    from benchmark import program
    from benchmark.harness import Spans
    cfg = config(name, compute_dtype="float32")
    sd = weights.draw(cfg, 3, "cpu")
    x = torch.randn((8, *ref.input_shape(cfg)),
                    generator=torch.Generator().manual_seed(4))
    model = program.adapter(cfg).train_model(cfg, "cpu").eval()
    model.load_state_dict(sd)                  # every name and shape
    want = ref.serve(ref.state(sd, "cpu"), x, cfg)
    with torch.no_grad():
        got = model(x)
    spans = Spans()
    if name == "wiflow":
        fast = program.stream_server(sd, cfg, 8, {"attention_impl": "v2"},
                                     spans, "cpu")
        served = fast(torch.cat([x[0].T, x[1:, :, -1]]))   # a 27-frame stream
        want_served = ref.serve(ref.state(sd, "cpu"),
                                torch.cat([x[0].T, x[1:, :, -1]])
                                .unfold(0, 20, 1), cfg)
        assert torch.allclose(served, want_served, atol=1e-4)
        assert spans.rows == [8]                   # the batch, padded
    got_fast = program.server(sd, cfg, {}, spans, "cpu")(x)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    assert (got_fast - want).abs().max() <= 1e-4 * scale
    # the served output varies from window to window as much as it is large
    assert (want - want.mean(0)).abs().max() > 0.2 * scale


def _batches(cfg, seed, n=3, rows=16):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(rows, *ref.input_shape(cfg), generator=g),
             torch.rand(rows, cfg["num_keypoints"], cfg["keypoint_dims"],
                        generator=g)) for _ in range(n)]


@pytest.mark.parametrize("name,lowering", [
    ("wiflow", "xla"), ("wiflow", "fused"), ("wiflow_mmfi", "xla"),
    ("wiflow_mmfi", "fused")])
@pytest.mark.parametrize("late", [False, True])
def test_train_steps_match_the_program(name, lowering, late):
    """From the drawn weights, or (``late``) from a snapshot of the
    program's state after two steps more: parameters, running statistics,
    AdamW's moments and step count, the dropout generator."""
    from benchmark import program
    cfg = config(name, compute_dtype="float32")
    sd = weights.draw(cfg, 5, "cpu")
    batches = _batches(cfg, 6)
    state = program.trainer(sd, cfg, {"tcn_train_impl": lowering,
                                      "conv_train_impl": lowering}, 77, "cpu")
    snap, m0 = None, None
    if late:
        for x, y in _batches(cfg, 8, 2):
            program.step(state, x, y)
        snap = program.snapshot(state)
        m0 = snap["exp_avg"]
    before = {k: v.detach().clone() for k, v in
              program.parameters(state).items()}
    key = ref.input_running_mean(cfg)
    assert key == "tcn.network.0.bn1_group.running_mean"
    mean0 = program.buffers(state)[key].clone()
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(program.step(state, x, y).item())
        if i == 0:
            grads = {k: (v - (0 if m0 is None else 0.9 * m0[k])) / 0.1
                     for k, v in program.first_moments(state).items()}
    change = {k: v.detach() - before[k] for k, v in
              program.parameters(state).items()}
    stats = program.buffers(state)
    rec = ref_train.train_steps(sd, cfg, batches, 77, snapshot=snap)
    compared, info = checks.train_gaps(
        losses, rec.losses, grads, rec.grads, change,
        {k: rec.after[k] - rec.before[k] for k in rec.after},
        stats[key] - mean0, rec.stats_after[key] - rec.stats_before[key])
    # every running statistic moves as the program moves it (torch's
    # momentum 0.1 and unbiased variance; 8.4e-5 seen)
    for k, v in rec.stats_after.items():
        assert (stats[k] - v).norm() <= 1e-3 * v.norm(), k
    assert compared["input_mean_gap"] < 1e-3, compared
    # float32 on both sides: the first step's loss to rounding, later
    # steps within what AdamW makes of rounding (5e-5 seen)
    assert abs(losses[0] - rec.losses[0]) <= 1e-6 * rec.losses[0]
    assert compared["loss_gap"] < 1e-3, compared
    assert compared["grad_gap"] < 1e-3 and info["grad_worst"] < 1e-2, info
    assert compared["change_gap"] < 1e-2, compared
    # 21 leaves have no gradient but for rounding: the 15 conv-stack and
    # 2 decoder conv biases a BatchNorm follows, both logits BN shifts,
    # the 1-channel shortcut of ``up`` and the width axis's output BN
    # shift (the height axis normalises its projection); rounding may
    # lift one or two over the rule's thousandth
    assert 19 <= info["leaves_left_out"] <= 21


def test_fp8_rounds_to_e4m3():
    x = torch.tensor([1.0, 1.0625, 500.0, -0.3])
    assert ref.fp8(x).tolist() == [1.0, 1.0, 448.0, -0.3125]
