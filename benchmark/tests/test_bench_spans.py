"""The readers of the program's spans on hand-built traces: known idle
inside the spans, nesting, and device operations linked to their host
operations by ``External id``; and ``None`` from a trace without spans."""

import pytest

from benchmark import run
from benchmark.drivers.sharded import MultiTrace
from benchmark.harness import spans, trace

SPAN = "user_annotation"


def ev(name, cat, ts, dur, ext=None):
    e = {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


def window(*events):
    return trace.Trace([ev(trace.WINDOW, SPAN, 0, 10000), *events])


def rounds_trace():
    # Two rounds of 1000 µs. Round 1: the card busy 400-1000 (decode), so
    # 400 idle. Round 2 (2000-3000): busy 2100-2300 and 2500-3200 (a
    # kernel that outlasts the span), so 100 + 200 = 300 idle. Idle outside
    # the rounds (1000-2000) is not the library's.
    return window(
        ev("bench.round", SPAN, 0, 1100),
        ev("protocol.round", SPAN, 0, 1000),
        ev("protocol.positions", SPAN, 0, 300),
        ev("protocol.decode", SPAN, 350, 600),
        ev("kernel", "kernel", 400, 600),
        ev("protocol.round", SPAN, 2000, 1000),
        ev("Memcpy HtoD", "gpu_memcpy", 2100, 200),
        ev("kernel", "kernel", 2500, 700),
    )


def layer(kind, t, **kw):
    return {"kind": kind, "trace": t, "chunks": [], **kw}


def test_round_library_idle_is_the_idle_inside_the_round_spans():
    value = run.read_layer("round_library_idle_ms.rounds",
                           layer("rounds", rounds_trace()))
    assert value == pytest.approx((400 + 300) / 2 / 1e3)


def test_combination_idle_is_the_idle_inside_the_combination_spans():
    t = window(
        ev("sim.combination", SPAN, 100, 900),
        ev("sim.chunk", SPAN, 150, 800),
        ev("k", "kernel", 200, 500),
        ev("k", "kernel", 600, 250),  # overlaps the first
        ev("sim.combination", SPAN, 5000, 100),
    )
    # 900 - 650 busy (200-850) = 250, and 100 with nothing: 350 over two.
    value = run.read_layer("combination_idle_ms.sweep", layer("sweep", t))
    assert value == pytest.approx(0.175)


def test_key_draw_counts_the_device_ops_launched_in_the_channel_spans():
    t = window(
        ev("sim.chunk", SPAN, 0, 4000, ext=1),
        ev("channel.keys", SPAN, 100, 500, ext=2),
        ev("aten::randint", "cpu_op", 150, 100, ext=3),
        ev("channel.inject", SPAN, 700, 600, ext=4),
        ev("aten::kthvalue", "cpu_op", 800, 300, ext=5),
        ev("aten::sort", "cpu_op", 850, 200, ext=6),
        ev("sim.decode", SPAN, 1400, 2000, ext=7),
        ev("aten::empty", "cpu_op", 1450, 10, ext=8),
        ev("sim.chunk", SPAN, 5000, 1000, ext=9),
        # Device ops run late, after their spans ended: linked by id.
        ev("randint kernel", "kernel", 1000, 30, ext=3),
        ev("gatherKthValue", "kernel", 1100, 90, ext=6),
        ev("Memset", "gpu_memset", 1200, 10, ext=5),
        ev("decode kernel", "kernel", 1500, 1500, ext=8),
        ev("no host op", "kernel", 3000, 5, ext=99),
        ev("unlinked", "kernel", 3100, 5),
    )
    value = run.read_layer("key_draw_ms_per_chunk.sweep", layer("sweep", t))
    assert value == pytest.approx((30 + 90 + 10) / 2 / 1e3)


def sharded_trace():
    # Rank 0: two steps; in each, a reduction with two waits (100 + 300
    # µs, then 200 µs) inside spans of 1000 and 600 µs.
    rank0 = window(
        ev("parallel.step", SPAN, 0, 2000),
        ev("parallel.reduce", SPAN, 1000, 1000),
        ev("parallel.wait", SPAN, 1100, 100),
        ev("parallel.wait", SPAN, 1500, 300),
        ev("parallel.step", SPAN, 3000, 1000),
        ev("parallel.reduce", SPAN, 3400, 600),
        ev("parallel.wait", SPAN, 3700, 200),
        ev("k", "kernel", 0, 900),
    )
    # Another rank's trace keeps no host events, as the driver leaves it.
    other = window(ev("k", "kernel", 0, 900))
    other.host = []
    return MultiTrace([rank0, other])


def test_the_reduction_splits_into_host_work_and_waits():
    run_ = layer("sweep", sharded_trace(), collective_ms=1.0)
    host = run.read_layer("reduce_host_ms_per_chunk.sharded", run_)
    wait = run.read_layer("rank_wait_ms_per_chunk.sharded", run_)
    assert host == pytest.approx((600 + 400) / 2 / 1e3)
    assert wait == pytest.approx((400 + 200) / 2 / 1e3)
    # Together they are the reduction spans' time a step.
    assert host + wait == pytest.approx((1000 + 600) / 2 / 1e3)


@pytest.mark.parametrize("metric,kind", [
    ("round_library_idle_ms.rounds", "rounds"),
    ("combination_idle_ms.sweep", "sweep"),
    ("key_draw_ms_per_chunk.sweep", "sweep"),
    ("reduce_host_ms_per_chunk.sharded", "sweep"),
    ("rank_wait_ms_per_chunk.sharded", "sweep"),
])
def test_a_program_without_spans_reads_none(metric, kind):
    # A traced window as a program that records no spans leaves it: only
    # the benchmark's own annotations and the device's work.
    t = window(ev("bench.combination", SPAN, 0, 5000),
               ev("aten::randint", "cpu_op", 10, 10, ext=3),
               ev("k", "kernel", 100, 4000, ext=3))
    for tr in (t, MultiTrace([t, t])):
        assert run.read_layer(metric, layer(kind, tr, collective_ms=1.0)) is None
    assert run.read_layer(metric, layer(kind, None)) is None
    # Another kind of cell: nothing to read.
    other = "sweep" if kind == "rounds" else "rounds"
    assert run.read_layer(metric, layer(other, rounds_trace())) is None


def test_cover_measures_a_union_inside_an_interval():
    cover = spans.Cover([(0, 10), (5, 20), (30, 40)])
    assert cover.inside(0, 100) == 30
    assert cover.inside(15, 35) == 10
    assert cover.inside(20, 30) == 0
    assert cover.holds(35) and not cover.holds(25)
