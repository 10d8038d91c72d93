"""busy_share and the traced window's reductions on a synthetic trace."""

import pytest

from benchmark.harness import trace


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


def synthetic():
    # Window 1000..2000 µs. Device busy 1000-1300 (two overlapping
    # kernels), 1500-1700 (a copy); a kernel at 1900-2100 is clipped to
    # 1900-2000; a kernel before the window is dropped.
    return [
        ev("before", "kernel", 0, 500),
        ev(trace.WINDOW, "user_annotation", 1000, 1000),
        ev("void ns::fused_generic_kernel<false, false, true, 0, false>(P)",
           "kernel", 1000, 200),
        ev("void ns::fused_generic_kernel<false, false, true, 0, false>(P)",
           "kernel", 1100, 200),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500, 200),
        ev("void ns::generic_stream_kernel<false, false, 16, 0>(P)", "kernel",
           1900, 200),
        # Host: a round spans the whole window; a shorter op covers the
        # gap 1300-1500; nothing inner covers 1700-1900.
        ev("bench.round", "user_annotation", 1000, 1000),
        ev("aten::index_select", "cpu_op", 1290, 220),
    ]


def test_busy_share_is_the_union_of_device_intervals():
    events = [ev("a", "kernel", 0, 10), ev("b", "kernel", 5, 10),
              ev("c", "gpu_memset", 30, 5), ev("host", "cpu_op", 0, 100)]
    assert trace.busy_share(events) == (pytest.approx(0.020), pytest.approx(0.1))


def test_window_clips_and_sums():
    t = trace.Trace(synthetic())
    assert t.window_s == pytest.approx(1e-3)
    # 300 + 200 + 100 µs busy.
    assert t.busy_s() == pytest.approx(600e-6)
    s, n = t.kernel_seconds(r"fused_generic_kernel<\s*\w+\s*,\s*\w+\s*,\s*(true|1)\b")
    assert (s, n) == (pytest.approx(400e-6), 2)
    s, n = t.kernel_seconds(r"fused_generic_kernel<\s*\w+\s*,\s*\w+\s*,\s*(false|0)\b")
    assert (s, n) == (0.0, 0)
    assert t.kernel_seconds("generic_stream_kernel") == (pytest.approx(100e-6), 1)
    assert t.device_seconds_except("fused_generic_kernel|generic_stream_kernel") \
        == pytest.approx(200e-6)


def test_breakdown_names_the_host_work_of_each_gap():
    t = trace.Trace(synthetic())
    ops = dict((k, v) for k, v in t.device_ops())
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(200e-6)
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == {"aten::index_select": pytest.approx(200e-6),
                    "bench.round": pytest.approx(200e-6)}


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.Trace([ev("k", "kernel", 0, 1)])


@pytest.mark.parametrize("sharded, one_card", [
    ("device_idle_pct.sharded", "device_idle_pct.sweep"),
    ("fused_generic_mc_roofline.sharded", "fused_generic_mc_roofline"),
])
def test_the_sharded_readers_read_only_a_run_over_ranks(sharded, one_card):
    from benchmark import run
    from benchmark.drivers.sharded import MultiTrace

    # Two ranks' traces, as the four-card cell's rank 0 gathers them.
    layer = {"kind": "sweep", "trace": MultiTrace([trace.Trace(synthetic())] * 2),
             "chunks": [{"frames": 64, "iterations": 640}], "n": 10240,
             "m": 2841, "edges": 40960, "schedule": "flooding"}
    # A one-card sweep's layer has no collective reading.
    assert run.read_layer(sharded, layer) is None
    layer["collective_ms"] = 1.5
    value = run.read_layer(sharded, layer)
    assert value is not None and value > 0.0
    assert value == pytest.approx(run.read_layer(one_card, layer))
