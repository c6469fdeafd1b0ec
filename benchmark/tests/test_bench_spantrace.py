"""The attribution of device and idle time to the program's spans
(``benchmark/spantrace.py``) on synthetic Chrome traces: the launch rule,
the idle-gap rule, unmatched operations, the clock check on the first
marker, and the per-layer numbers they give."""

import re

import pytest

from benchmark import spantrace
from wiflow_tpu_torch.utils.trace import Span

SPIN = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
ANCHOR = (1_000_000, 5_000_000)          # span clock, wall clock (ns)
BASE = 4_000_000                         # the trace's baseTimeNanoseconds


def perf(us):
    """The span-clock time (ns) that the trace's ``us`` maps to."""
    return round(us * 1000) + BASE - ANCHOR[1] + ANCHOR[0]


def launch(ts, dur, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def op(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def span(name, a_us, b_us, id_, parent=0):
    return Span(name, perf(a_us), perf(b_us), id_, parent, 1)


def events(extra, window=(10, 1000)):
    """Two markers (the first launched at 2-4 us, running 4-10; the last
    running from ``window[1]``) and ``extra``."""
    return [launch(2, 2, 1), op(4, window[0] - 4, 1, SPIN),
            launch(window[1] - 5, 2, 2), op(window[1], 5, 2, SPIN)] + extra


def attribution(extra, spans=(), counts=None, host=(1.5, 4.5), **kw):
    return spantrace.Attribution(events(extra, **kw), list(spans),
                                 counts or {}, ANCHOR,
                                 (perf(host[0]), perf(host[1])), BASE)


def test_launch_inside_one_span_kernel_elsewhere():
    """The kernel runs after its span has ended; it is the span's."""
    at = attribution([launch(20, 5, 7), op(200, 50, 7),
                      launch(300, 5, 8), op(310, 20, 8)],
                     [span("serve.forward", 15, 40, 1),
                      span("serve.tcn", 18, 30, 2, 1)])
    assert at.clock["ok"] and at.usable is None
    assert at.device_ns == {"serve.tcn": 50_000, "caller": 20_000}
    assert sum(at.device_ns.values()) == at.total_ns == 70_000
    table = at.table()
    assert table["serve.forward"]["host_self_ms"] == pytest.approx(0.013)
    assert table["serve.tcn"]["device_ms"] == pytest.approx(0.05)
    assert table["serve.tcn"]["count"] == 1


def test_gap_under_nested_span():
    """Idle from 100 to 200 us: its middle falls in the inner span, whose
    CUDA call names the gap; the idle before and after is the caller's."""
    at = attribution([launch(20, 5, 7), op(30, 70, 7),
                      launch(149, 2, 8, "cudaMemcpyAsync"),
                      op(200, 800, 8, "Memcpy DtoH")],
                     [span("stream.request", 120, 190, 1),
                      span("stream.gather", 140, 160, 2, 1)])
    assert at.idle_ns == {"stream.gather": 100_000, "caller": 20_000}
    assert at.named_gaps()[0] == ["stream.gather / cudaMemcpyAsync",
                                  pytest.approx(1e-4)]
    assert at.named_gaps()[1][0] == "caller / cudaLaunchKernel"
    q = at.quantities()
    assert q["idle_share.in_program"] == pytest.approx(100 * 100 / 990)


def test_op_with_no_matching_launch():
    small = attribution([launch(20, 5, 7), op(30, 990, 7), op(20, 5, 99)],
                        [span("train.step", 15, 40, 1)],
                        window=(10, 1100))
    assert small.unmatched_ops == 1
    assert small.device_ns["unmatched"] == 5_000
    assert sum(small.device_ns.values()) == small.total_ns
    assert small.usable is None        # 0.5% of device time
    big = attribution([launch(20, 5, 7), op(30, 90, 7), op(200, 50, 99)],
                      [span("train.step", 15, 40, 1)])
    assert "no matched launch" in big.usable
    assert big.quantities() is None
    assert big.notes()["program_clock"]["unmatched_ops"] == 1


@pytest.mark.parametrize("host,ok", [((1.5, 4.5), True),
                                     ((51.9, 60), True),
                                     ((52.1, 60), False),
                                     ((-60, -45.9), True),
                                     ((-60, -46.1), False)])
def test_clock_check_on_the_first_marker(host, ok):
    """The first marker's launch (2-4 us on the trace) must map inside
    the host interval around it, 50 us of slack each side; outside it
    every number is null."""
    at = attribution([launch(20, 5, 7), op(30, 50, 7)],
                     [span("serve.forward", 15, 40, 1)], host=host)
    assert at.clock["ok"] is ok
    if ok:
        assert at.quantities() is not None
    else:
        assert at.quantities() is None
        assert at.usable.startswith("clock check failed")


def test_quantities_of_the_layers():
    own = spantrace.own_kernels()
    ev = [
        # a stream request: the pad copy, a forward of three kernels and
        # its glue, the cat
        launch(20, 2, 10), op(20, 10, 10, "elementwise_kernel"),
        launch(40, 2, 11), op(40, 10, 11, "tcn_level_kernel<bf16>"),
        launch(60, 2, 12), op(60, 10, 12, "conv_stack_kernel<bf16>"),
        launch(80, 2, 13), op(80, 10, 13, "elementwise_kernel"),
        launch(90, 2, 14), op(95, 5, 14, "cat_kernel"),
    ]
    spans = [span("stream.request", 15, 100, 1),
             span("stream.windows", 16, 30, 2, 1),
             span("serve.forward", 35, 92, 3, 1),
             span("serve.tcn", 38, 50, 4, 3),
             span("serve.conv_stack", 55, 70, 5, 3),
             span("stream.gather", 89, 99, 6, 1)]
    q = attribution(ev, spans).quantities(own)
    assert q["stream.own_device_share"] == pytest.approx(100 * 15 / 45)
    assert q["serve.glue_host_ms_per_call"] == pytest.approx(
        (57 - 12 - 15) / 1e3)
    assert "train.optimizer_device_ms_per_step" not in q

    ev = [launch(20, 2, 10), op(20, 10, 10, "stage_conv_kernel<bf16, true>"),
          launch(40, 2, 11), op(40, 20, 11, "elementwise_kernel"),
          launch(70, 2, 12), op(70, 30, 12, "reduce_kernel"),
          launch(110, 2, 13), op(110, 40, 13, "multi_tensor_apply_kernel")]
    spans = [span("train.step", 15, 160, 1),
             span("train.forward", 16, 50, 2, 1),
             span("train.backward", 60, 100, 3, 1),
             span("train.optimizer", 105, 150, 4, 1)]
    q = attribution(ev, spans, {"train.steps": 2}).quantities(own)
    assert q["train.stock_ops_ms_per_step"] == pytest.approx(0.05 / 2)
    assert q["train.optimizer_device_ms_per_step"] == pytest.approx(0.02)


def test_own_kernels_are_the_roofline_files_kernels():
    own = spantrace.own_kernels()
    for name in ("tcn_level_kernel<__nv_bfloat16>",
                 "stage_wgrad_kernel<__nv_bfloat16>",
                 "join_backward_kernel", "axial_core_forward_kernel",
                 "reduce_columns", "sums_backward_kernel"):
        assert own.search(name), name
    for name in ("at::native::elementwise_kernel<128, 4>",
                 "cudnn::cnn::reduce_wgrad_nchw_helper"):
        assert not own.search(name), name
    assert isinstance(own, re.Pattern)


def test_stream_rows_check():
    ok = spantrace.stream_rows_check(
        {"stream.rows": 12288, "stream.pad_rows": 3288}, [4096] * 3, 9000)
    assert ok["equal"]
    off = spantrace.stream_rows_check({"stream.rows": 12288},
                                      [4096] * 3, 9000)
    assert not off["equal"]
