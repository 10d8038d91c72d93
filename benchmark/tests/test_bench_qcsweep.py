"""The QC sweep cell on the CPU (the port runs the fused QC kernel's plain
mc version there): a tiny run is correct and reports its metrics, its
traced passes record one fused QC mc span a chunk, the roofline reader
finds the fused QC kernel's mc mode alone, and the control fails the
check."""

from contextlib import contextmanager

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control_qcsweep, run
from benchmark.drivers import qcsweep
from benchmark.harness import trace
from benchmark.tests.test_bench_drivers import CAP, TINY_SWEEP, tiny

NAME = "qc10k-sweep"
METRIC = "fused_qc_mc_roofline"


def test_a_tiny_qc_sweep_is_correct_and_reports_its_metrics():
    out = tiny(NAME, TINY_SWEEP)
    assert out["correct"] is True
    assert out["attempted"] == 96 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["checks"] == {"frame_mismatch": {"value": 0.0, "limit": 0.0},
                             "stats_gap": {"value": 0.0, "limit": 0.0}}


def test_the_traced_passes_record_one_fused_qc_mc_span_a_chunk(monkeypatch):
    @contextmanager
    def traced_on_the_cpu():
        holder = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield holder
        holder.append([e.name for e in prof.events()])

    monkeypatch.setattr(trace, "traced", traced_on_the_cpu)
    # Few sweeps a frame: the profiler records every torch op of the
    # plain version.
    light = dict(TINY_SWEEP, trials=32, qber=[0.02, 0.025])
    ctx = run.Context(torch, {**run.load_json("workloads", NAME), **light},
                      {**run.load_json("configs", "qc10k"), **CAP},
                      2**31 + 5, "cpu")
    cell = qcsweep.Cell(ctx)
    cell.setup()
    cell.run_traced()
    names = cell.trace
    # One pass: two points of two 16-frame chunks.
    assert len(cell.traced_chunks) == 4
    assert names.count("kernel.fused_qc.mc") == 4
    assert names.count("sim.combination") == 2
    assert not any(n.startswith("kernel.") and n != "kernel.fused_qc.mc"
                   and n != "kernel.plan" for n in names)
    layer = cell.layer()
    assert layer["schedule"] == "layered" and layer["edges"] == 40960


def ev(name, ts, dur):
    return {"name": name, "cat": "kernel", "ts": ts, "dur": dur, "ph": "X"}


@pytest.mark.parametrize("kernel, counted", [
    ("void (anonymous namespace)::fused_qc_kernel<true, false, false, true, "
     "0, false>((anonymous namespace)::Params)", True),
    ("void ns::fused_qc_kernel<false, true, true, true, 1, true>(P)", True),
    ("void ns::fused_qc_kernel<true, false, false, false, 0, false>(P)", False),
    ("void ns::fused_generic_kernel<false, false, true, 0, false>(P)", False),
    ("void ns::qc_stream_kernel<true, false, false, true, 0>(P)", False),
])
def test_the_roofline_reads_the_fused_qc_mc_kernel_alone(kernel, counted):
    t = trace.Trace([{"name": trace.WINDOW, "cat": "user_annotation",
                      "ts": 0, "dur": 10000, "ph": "X"},
                     ev(kernel, 100, 2000), ev(kernel, 3000, 2000)])
    layer = {"kind": "sweep", "trace": t, "n": 10240, "m": 3072,
             "edges": 40960, "schedule": "layered",
             "chunks": [{"frames": 16384, "iterations": 16384 * 6}] * 2}
    value = run.read_layer(METRIC, layer)
    if not counted:
        assert value is None
        return
    from benchmark.harness.bounds import mc_bound

    bound_ms = 2 * mc_bound(16384, 10240, 40960, 16384 * 6, "layered")[0]
    assert value == pytest.approx(100.0 * bound_ms / 4.0)
    assert run.read_layer(METRIC, dict(layer, trace=None)) is None
    assert run.read_layer(METRIC, dict(layer, kind="rounds")) is None


def test_the_qc_control_fails_the_limits(monkeypatch):
    from qkd_ldpc_v_tpu_torch import simulation

    # The control replaces the decode of every chunk step of the process.
    monkeypatch.setattr(simulation.ChunkStep, "decode",
                        simulation.ChunkStep.decode)
    out = tiny(NAME, dict(TINY_SWEEP, trials=96, chunk=96, qber=[0.035],
                          compare=dict(TINY_SWEEP["compare"], combinations=1)),
               hooks=control_qcsweep.hooks)
    assert out["correct"] is False
    assert out["checks"]["frame_mismatch"]["value"] > 0.0
    assert out["checks"]["stats_gap"]["value"] > 0.0
