"""The benchmark's work functions against hand counts, the bounds that
``PERF.md`` records, and the port's own launch plan and FLOP counter."""

import json
import math
from pathlib import Path

import pytest

from benchmark import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_one_tcn_level_by_hand():
    """Level 0 of ``wiflow`` (540 -> 540, 20 groups, k = 3, no shortcut)
    at batch 1: 2 x 20 steps x (3 x 540 x 27 + 540 x 540) x 2 convs."""
    cfg = dict(config("wiflow"), tcn_channels=[540])
    flops, nbytes = work.tcn(cfg, 1, 2)
    weights = 2 * (3 * 540 * 27 + 540 * 540)
    assert flops == 2 * 20 * weights == 26_827_200
    assert nbytes == 20 * (540 + 540) * 2 + weights * 2 + 4 * (540 + 3 * 540)


def test_bounds_recorded_in_perf_md():
    """TCN 0.3512 ms and conv stack 0.1718 ms at batch 4096 in bf16, both
    bound by operations (PERF.md's kernel table, rows 1 and 2)."""
    cfg = config("wiflow")
    t_tcn, by_tcn = work.bound_s(*work.tcn(cfg, 4096, 2), "bfloat16")
    t_conv, by_conv = work.bound_s(*work.conv_stack(cfg, 4096 * 20, 2),
                                   "bfloat16")
    assert round(t_tcn * 1e3, 4) == 0.3512 and by_tcn == "operations"
    assert round(t_conv * 1e3, 4) == 0.1718 and by_conv == "operations"
    t_att, by_att = work.bound_s(*work.attention(cfg, 4096, 2), "bfloat16")
    assert round(t_att * 1e3, 4) == 0.1878 and by_att == "bytes"


def test_forward_flops_about_155_mflop():
    f = work.forward_flops(config("wiflow"))
    assert 150e6 < f < 160e6
    assert f == (work.tcn(config("wiflow"), 1, 2)[0]
                 + work.conv_stack(config("wiflow"), 20, 2)[0]
                 + work.attention(config("wiflow"), 1, 2)[0]
                 + 2 * 300 * (9 * 64 * 32 + 32 * 2))
    assert 20e6 < work.forward_flops(config("wiflow_mmfi")) < 60e6


@pytest.mark.parametrize("name", ["wiflow", "wiflow_mmfi"])
def test_stage_and_join_work_match_the_ports_launch_plan(name):
    """Summed over the port's ``step_launches`` at batch 256, the stage and
    join work (chip_smoke's ``stage_work`` / ``join_work`` formulas) equals
    what :mod:`benchmark.work` derives from the configuration's shapes."""
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig
    from wiflow_tpu_torch.ops.kernels.stage_fused import step_launches
    cfg = config(name)
    port_cfg = ModelConfig() if name == "wiflow" else MMFiModelConfig()
    stages, joins = step_launches(port_cfg, 256)
    assert len(stages) == len(work.stage_ops(cfg, 256))
    assert len(joins) == len(work.join_ops(cfg, 256))

    def plan_stage(c, es):      # chip_smoke.py::stage_work
        ktaps = 1 if c["kind"] in ("identity", "chunk1") else 3
        win = c["lead"][-1]
        wout = (win - 1) // 2 + 1 if c["kind"].startswith("chunk") else win
        rows = math.prod(c["lead"][:-1])
        nw = c["co"] * (c["ci"] // c["groups"]) * ktaps
        xb, ob = rows * win * c["ci"] * es, rows * wout * c["co"] * es
        mask = {None: 0, "element": rows * win * c["ci"],
                "sample": c["lead"][0] * c["ci"]}[c["mask"]]
        vecs = 4 * (3 * c["ci"] * c["pro"] + c["co"] * c["bias"])
        conv = 2 * rows * wout * nw
        return ((conv, xb + ob + 4 * nw + mask + vecs + 8 * c["co"]),
                (conv * (2 if c["need_gx"] else 1),
                 xb + 2 * ob + (xb if c["need_gx"] else 0) + 8 * nw + mask
                 + 2 * vecs + 8 * c["co"]))

    def total(pairs):
        f = b = 0
        for pair in pairs:
            for w in pair:
                f, b = f + w[0], b + w[1]
        return f, b

    assert total(plan_stage(c, 2) for c in stages) == total(
        work.stage_one(c, 2) for c in work.stage_ops(cfg, 256))
    plan_joins = [dict(lead=j["lead"], c=j["c"], mask=j["mask"] is not None,
                       res_norm=j["res_norm"]) for j in joins]
    assert total(work.join_one(j, 2) for j in plan_joins) == total(
        work.join_one(j, 2) for j in work.join_ops(cfg, 256))


def test_forward_flops_against_the_ports_flop_counter():
    """``utils/flops.py::flop_count`` (torch's FlopCounterMode) counts the
    eval module's products and convolutions; it also counts the input
    block's one-channel convs, 2 x 20 x 240 x (3 + 1) x 8 a sample, as
    ``tests/test_torch_baseline_cli.py`` records, and nothing of the
    attention's softmax."""
    import torch
    from wiflow_tpu_torch.core.config import ModelConfig
    from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
    from wiflow_tpu_torch.utils.flops import flop_count
    model = WiFlowPoseModel(ModelConfig(compute_dtype="float32"),
                            device="cpu")
    counted = flop_count(model, torch.zeros(2, 540, 20)) / 2
    ours = work.forward_flops(config("wiflow"))
    assert abs(counted - ours) / ours < 0.02, (counted, ours)


def test_train_bounds_are_positive_and_by_op():
    b = work.train_step_bounds(config("wiflow"), 2048)
    assert set(b) == {"stage", "join", "attention_train"}
    assert all(v > 0 for v in b.values())
    s = work.serve_bounds(config("wiflow"), [4096, 4096])
    assert math.isclose(s["tcn"], 2 * 0.3512e-3, rel_tol=1e-3)
