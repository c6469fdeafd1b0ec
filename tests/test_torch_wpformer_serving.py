"""WPformer's served entry, its channel attention kernel's plan and plain
version, and the benchmark's ``wpformer`` configuration, on the CPU.

* the benchmark's plain reference (``benchmark/reference/wpformer.py``)
  against the port's served entry (``wpformer_forward``, both lowerings
  of the core) and the model's own eval forward, in fp32 at a small size,
  on weights ``benchmark/weights.py`` draws (BatchNorms calibrated);
* the adapter's mapping of the reference's names onto the port's module,
  and back, bit for bit;
* the served entry's spans and counters;
* ``channel_attention_plan`` at the published shape and its refusals; the
  plain version against the model's stock-op core; the adapter's set-up
  check of the kernel, which refuses a kernel with a fault planted;
* the cell loads, runs through the harness on the CPU at a small size and
  comes out correct (and not with a fault planted), its reference module
  loads nothing of JAX or the program, and ``roofline.channel_attention``'s
  reader on a synthetic device trace.

The kernel itself runs on the card only: phase 21 of ``chip_smoke.py``
holds it to the plain version and the stock core there.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import channel_attention_work as caw
from benchmark import devtrace, harness, weights
from benchmark.control import StandIn
from benchmark.metrics import kernel_roofline
from benchmark.programs import wpformer as adapter
from benchmark.reference import model as ref
from benchmark.reference import wpformer as ref_wpformer
from wiflow_tpu_torch.models.baselines import wpformer as W
from wiflow_tpu_torch.ops.kernels import channel_attention as ca
from wiflow_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/wpformer.json").read_text())
# two streams of 30 subcarriers, a two-layer trunk of 8 and 16 channels:
# 240 tokens of 16 channels into the transformer
SMALL = dict(CONFIG, num_chunks=2, resize_to=[30, 16], trunk_widths=[8, 16],
             trunk_blocks=[1, 1], mlp_dim=64, num_subcarriers=60,
             window_size=12, compute_dtype="float32")
TOL = 2e-5          # fp32, x max|ref|: the same ops in other orders


def _x(rows, seed=4, cfg=SMALL):
    return torch.randn((rows, *ref.input_shape(cfg)),
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def drawn():
    return weights.draw(SMALL, 3, "cpu")


def _model(sd, cfg=SMALL):
    m = W.WPformer(**adapter.model_config(cfg), device="cpu")
    m.load_state_dict(adapter.to_program(sd, cfg))
    return m


@pytest.mark.parametrize("core", ["stock", "kernel", "auto"])
def test_reference_matches_served_entry_and_eval_forward(drawn, core):
    x = _x(5)
    want = ref.serve(ref.state(drawn, "cpu"), x, SMALL)
    scale = want.abs().max()
    got = adapter.serve_forward(drawn, SMALL, torch.device("cpu"), core)(x)
    assert got.shape == (5, 15, 2) and got.dtype == torch.float32
    assert (got - want).abs().max() <= TOL * scale
    with torch.no_grad():
        eval_out = _model(drawn).eval()(x)
    assert (eval_out - want).abs().max() <= TOL * scale
    # the output varies from window to window: the check has something
    # to see
    assert (want - want.mean(0)).abs().max() > 0.05 * scale


def test_reference_blocks_in_eval_and_not_in_train(drawn, monkeypatch):
    """Eval: the same rows whole or in blocks of 2; train: the batch's
    statistics over the whole batch, not a block's."""
    x = _x(5)
    p = ref.state(drawn, "cpu")
    whole = ref.serve(p, x, SMALL)
    monkeypatch.setattr(ref_wpformer, "BLOCK", 2)
    assert torch.allclose(ref.serve(p, x, SMALL), whole, atol=1e-6)
    stats = {}
    with torch.no_grad():
        ref.forward(ref.Run(p, train=True, stats=stats), x, SMALL)
    assert stats["bn1"][2] == 5 * 2 * 30 * 16      # rows x streams x H x W


def test_bf16_served_entry_is_near_the_reference(drawn):
    x = _x(6)
    want = ref.serve(ref.state(drawn, "cpu"), x, SMALL)
    cfg = dict(SMALL, compute_dtype="bfloat16")
    spread = (want - want.mean(0)).norm()
    for core in ("stock", "kernel"):
        got = adapter.serve_forward(drawn, cfg, torch.device("cpu"), core)(x)
        assert got.dtype == torch.float32
        assert 0 < ((got - want).norm() / spread).item() < 0.1


def test_state_dict_mapping_round_trips(drawn):
    m = _model(drawn)                    # strict: every name and shape
    names = adapter.names(SMALL)
    assert {s for s, _, _ in names} == set(drawn)
    assert {d for _, d, _ in names} == set(m.state_dict())
    back = adapter.to_reference(m.state_dict(), SMALL)
    assert set(back) == set(drawn)
    for k, v in drawn.items():
        assert torch.equal(back[k], v), k
    # the published nn.Linear's [out, in] is the port's matrix transposed
    wq = m.tf.attn_0.wq1
    assert torch.equal(
        wq, drawn["tf.encoder.layer.0.channel_attn.query1.1.weight"].t())


def test_published_config_counts():
    n, c, h = caw.tokens_channels_heads(CONFIG)
    assert (n, c, h) == (2160, 256, 3)
    flops, nbytes = caw.core(CONFIG, 1)
    assert flops == pytest.approx(1.699e9, rel=1e-3)
    assert nbytes == 10 * 2160 * 256 * 2
    assert caw.bound_s(CONFIG, [512, 512]) == pytest.approx(
        2 * 512 * nbytes / 3.35e12)
    assert ref_wpformer.forward_flops(CONFIG) == pytest.approx(71.42e9,
                                                               rel=1e-3)
    spec = ref.spec(CONFIG)
    params = sum(math.prod(s) for _, s, k in spec
                 if k not in ("running_mean", "running_var", "count"))
    assert params == 10_037_576


def test_spans_and_counters(drawn):
    packed = W.pack_wpformer(_model(drawn))
    x = _x(3)
    trace.collect()
    trace.enable()
    try:
        W.wpformer_forward(packed, x, core="kernel")
        W.wpformer_forward(packed, x, core="stock")
    finally:
        trace.disable()
    got = trace.collect()
    assert got.counts == {"serve.wpformer_streams": 2 * 3 * 2,
                          "serve.channel_attention_windows": 3}
    by_id = {s.id: s for s in got.spans}
    roots = [s for s in got.spans if s.parent == 0]
    assert [s.name for s in roots] == ["serve.forward"] * 2
    for root in roots:
        kids = sorted((s for s in got.spans if s.parent == root.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == [
            "serve.prep", "serve.trunk", "serve.channel_attention",
            "serve.decode"]
        for s in kids:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert by_id[s.parent] is root and s.request == root.request


def test_served_entry_refuses_an_unknown_core_and_mmfi(drawn):
    packed = W.pack_wpformer(_model(drawn))
    with pytest.raises(ValueError, match="core"):
        W.wpformer_forward(packed, _x(1), core="fast")
    mmfi = W.WPformer(num_chunks=3, resize_to=(136, 32), num_keypoints=17,
                      keypoint_dims=3, trunk_widths=(8, 16),
                      trunk_blocks=(1, 1), input_mode="mmfi",
                      compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="wiflow"):
        W.wpformer_forward(W.pack_wpformer(mmfi), torch.zeros(1, 3, 114, 10))


def test_plan_takes_the_published_shape():
    plan = ca.channel_attention_plan(512, 2160, 256, 3, torch.bfloat16)
    row = (256 + 8) * 2
    stage = max(3 * (32 * 72 * 2 + 32 * row), 2 * 64 * row)
    assert plan == ca.ChannelAttentionPlan(
        cluster=4, grid_y=512,
        smem_bytes=3 * 64 * row + stage + (4 * 64 + 8) * 4 + 32)
    assert plan.smem_bytes == 170_048
    assert ca.channel_attention_plan(70000, 5, 64, 1, torch.bfloat16
                                     ).grid_y == 65535


@pytest.mark.parametrize("batch,n,c,heads", [
    (1, 1, 64, 1), (7, 37, 128, 4), (3, 2160, 256, 4), (2, 100, 64, 8)])
def test_plan_takes_what_fits(batch, n, c, heads):
    plan = ca.channel_attention_plan(batch, n, c, heads, torch.bfloat16)
    assert plan.cluster == c // 64
    assert plan.smem_bytes <= 232448


@pytest.mark.parametrize("batch,n,c,heads,dtype,match", [
    (4, 2160, 256, 3, torch.float32, "bfloat16"),
    (4, 2160, 512, 3, torch.bfloat16, "C must be"),
    (4, 2160, 16, 3, torch.bfloat16, "C must be"),
    (4, 2160, 96, 3, torch.bfloat16, "C must be"),
    (4, 2160, 256, 5, torch.bfloat16, "shared memory"),
    (4, 0, 256, 3, torch.bfloat16, "positive"),
    (0, 10, 256, 3, torch.bfloat16, "positive"),
    (4, 10, 256, 0, torch.bfloat16, "positive"),
])
def test_plan_refuses(batch, n, c, heads, dtype, match):
    with pytest.raises(ValueError, match=match):
        ca.channel_attention_plan(batch, n, c, heads, dtype)


def test_wrapper_refuses_a_misshapen_qkv():
    with pytest.raises(ValueError, match="3 x 3 x C"):
        ca.channel_attention(torch.zeros(2, 10, 100), 3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_plain_version_matches_the_stock_core(dtype, tol):
    """The kernel's arithmetic against the model's core: equal in fp32 up
    to the order of sums; in bf16 the model also rounds each head's
    context before the mean, a bf16 step of the largest entry at most."""
    g = torch.Generator().manual_seed(11)
    qkv = torch.randn((3, 50, 3 * 3 * 64), generator=g).to(dtype)
    got = ca.channel_attention_plain(qkv, 3)
    want = W.channel_attention_core(*ca.split_heads(qkv, 3))
    assert got.shape == want.shape == (3, 50, 64)
    assert got.dtype == dtype
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= tol * scale


def test_split_heads_reads_the_packed_columns():
    qkv = torch.arange(2 * 3 * 3 * 2 * 4, dtype=torch.float32).reshape(
        2, 3, 3 * 2 * 4)
    q, k, v = ca.split_heads(qkv, 2)
    assert q.shape == (2, 2, 3, 4)
    assert torch.equal(k[1, 0, 2], qkv[1, 2, 8:12])       # k_0 of token 2
    assert torch.equal(v[0, 1, 1], qkv[0, 1, 20:24])      # v_1 of token 1


@pytest.mark.parametrize("fault", ["none", "head", "zero"])
def test_adapter_check_refuses_a_faulty_kernel(monkeypatch, fault):
    """The set-up check at the published shape: the wrapper (its plain
    version on the CPU) passes; with a head left out or the output zeroed
    it raises."""
    real = ca.channel_attention

    def faulty(qkv, heads):
        out = real(qkv, heads)
        if fault == "zero":
            return torch.zeros_like(out)
        c = qkv.shape[-1] // (3 * heads)
        last = torch.cat([qkv[..., (j * heads + heads - 1) * c:
                              (j * heads + heads) * c] for j in range(3)], -1)
        ctx = ca.channel_attention_plain(last, 1).float() / heads
        return (out.float() - ctx).to(out.dtype)

    if fault != "none":
        monkeypatch.setattr(ca, "channel_attention", faulty)
    if fault == "none":
        adapter.check_kernel(2160, 256, 3, torch.device("cpu"))
    else:
        with pytest.raises(RuntimeError, match="off its plain version"):
            adapter.check_kernel(2160, 256, 3, torch.device("cpu"))


def test_cell_loads():
    cell = harness.load_cell("wpformer.stream.b512")
    assert cell["cfg"]["reduced"] == [] and cell["chips"] == 1
    assert [m["name"] for m in cell["end_to_end"]] == [
        "serve_windows_per_s", "serve_p95_ms", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        "stream.pad_share", "serve.host_ms_per_call", "mfu.serve",
        "idle_share.serve", "roofline.channel_attention"]
    assert cell["params"]["batch"] == 512 and cell["kernels"] == []


def _small_cell():
    cell = harness.load_cell("wpformer.stream.b512")
    return dict(cell, cfg=dict(SMALL, compute_dtype="bfloat16"),
                params=dict(cell["params"], store_frames=2000,
                            frames=[12, 31, 75], batch=16, check_every=1))


def test_cell_runs_on_the_cpu_at_a_small_size():
    torch.set_num_threads(2)
    cell = _small_cell()
    out = harness.run_cell(cell, 2 ** 31 + 77, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 3
    assert set(out["metrics"]) == {"serve_windows_per_s", "serve_p95_ms",
                                   "setup_s"}
    for kind in ("half", "altered"):
        bad = harness.run_cell(cell, 2 ** 31 + 77, 0.2, False,
                               torch.device("cpu"), time.perf_counter(),
                               StandIn(kind))
        assert bad["correct"] is False, kind


def test_reference_loads_nothing_of_jax_or_the_program():
    code = ("import sys; import benchmark.reference.wpformer, "
            "benchmark.channel_attention_work; print(sorted({m.split('.')[0]"
            " for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'wiflow_tpu', 'wiflow_tpu_torch'}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


class _Reading:
    def __init__(self, trace, batches):
        self.cfg, self.trace, self.notes = CONFIG, trace, {}
        self.traced = {"batches": batches}


def _trace(kernels):
    """A device trace between two markers with the given (name, start s,
    seconds) kernels and a cuDNN conv beside them."""
    ev = [{"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 0,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 1e6,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_bf16",
           "ts": 100, "dur": 5000}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": t * 1e6,
            "dur": s * 1e6} for n, t, s in kernels]
    return devtrace.Trace.from_events(ev)


def test_kernel_roofline_reader_on_a_synthetic_trace():
    spec = json.loads((ROOT / "benchmark/metrics/"
                       "roofline.channel_attention.json").read_text())
    name = "void (anonymous namespace)::channel_attention_kernel<256>(Args)"
    # 3 calls of 512 windows, the profiler kept 2 launches of 6.76 ms
    r = _Reading(_trace([(name, 0.1, 0.00676), (name, 0.2, 0.00676)]),
                 [512, 512, 512])
    got = kernel_roofline.read(spec, r)
    bound = 3 * caw.bound_s(CONFIG, [512])
    assert got == pytest.approx(100 * bound / (3 * 0.00676))
    assert 20 < got < 30
    assert r.notes[spec["name"]]["recorded_calls"] == 2
    assert r.notes[spec["name"]]["counted_calls"] == 3
    # a program without the kernel, or a sub-window with no call: nothing
    assert kernel_roofline.read(spec, _Reading(_trace([]), [512])) is None
    assert kernel_roofline.read(spec, _Reading(_trace([(name, 0.1, 1e-3)]),
                                               [])) is None
