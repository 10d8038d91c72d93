"""The 100k QC sweep cell on the CPU (the port runs the streamed QC
kernel's plain mc version there, since the fused QC kernel does not hold
the flagship): a tiny run is correct and reports its metrics, its traced
passes record one streamed QC mc span a chunk and no other kernel, the
roofline reader finds the streamed QC kernel's min-sum mc mode alone, the
control fails the check, and each QC configuration states its code's
facts."""

from contextlib import contextmanager
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control_qcsweep, run
from benchmark.drivers import qcsweep
from benchmark.harness import trace
from benchmark.harness.bounds import mc_bound
from benchmark.reference.qc import read_qc
from benchmark.tests.test_bench_drivers import CAP, TINY_SWEEP, tiny
from benchmark.tests.test_bench_qcsweep import ev

ROOT = Path(__file__).resolve().parents[2]
NAME = "qc100k-sweep"
METRIC = "qc_stream_mc_roofline"
SPAN = "kernel.qc_stream.mc"
# N=102400 on the CPU: few frames and one point a run, the same cap.
ONE = dict(TINY_SWEEP["compare"], combinations=1)
FAMILIES = ("kernel.fused_qc.", "kernel.qc_stream.", "kernel.fused_generic.",
            "kernel.generic_stream.", "kernel.spa.", "kernel.channel.")


def test_a_tiny_flagship_sweep_is_correct_and_reports_its_metrics():
    out = tiny(NAME, dict(TINY_SWEEP, trials=16, qber=[0.02], compare=ONE))
    assert out["correct"] is True
    assert out["attempted"] == 16 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["checks"] == {"frame_mismatch": {"value": 0.0, "limit": 0.0},
                             "stats_gap": {"value": 0.0, "limit": 0.0}}


def test_the_traced_passes_record_one_qc_stream_mc_span_a_chunk(monkeypatch):
    @contextmanager
    def traced_on_the_cpu():
        holder = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield holder
        holder.append([e.name for e in prof.events()])

    monkeypatch.setattr(trace, "traced", traced_on_the_cpu)
    light = dict(TINY_SWEEP, trials=16, chunk=8, qber=[0.02, 0.025])
    ctx = run.Context(torch, {**run.load_json("workloads", NAME), **light},
                      {**run.load_json("configs", "qc100k"), **CAP},
                      2**31 + 5, "cpu")
    cell = qcsweep.Cell(ctx)
    cell.setup()
    cell.run_traced()
    names = cell.trace
    # One pass: two points of two 8-frame chunks.
    assert len(cell.traced_chunks) == 4
    assert names.count(SPAN) == 4
    assert names.count("sim.combination") == 2
    # No other mode of the streamed kernel and no other kernel family.
    assert not any(n.startswith(FAMILIES) and n != SPAN for n in names)
    layer = cell.layer()
    assert layer["schedule"] == "layered" and layer["edges"] == 307200


@pytest.mark.parametrize("kernel, counted", [
    ("void (anonymous namespace)::qc_stream_kernel<true, false, false, true, "
     "0>((anonymous namespace)::Params, (anonymous namespace)::McDraw)", True),
    ("void ns::qc_stream_kernel<false, true, true, true, 0>(P)", True),
    # Trial and decode modes (MC false).
    ("void ns::qc_stream_kernel<true, false, false, false, 0>(P)", False),
    ("void ns::qc_stream_kernel<false, false, false, false, 0>(P)", False),
    # The SPA pair's mc mode: other work than mc_bound counts.
    ("void ns::qc_stream_kernel<false, false, false, true, 1>(P)", False),
    ("void ns::qc_stream_kernel<false, false, false, true, 2>(P)", False),
    ("void ns::fused_qc_kernel<true, false, false, true, 0, false>(P)", False),
    ("void ns::fused_qc_kernel<false, true, true, true, 1, true>(P)", False),
])
def test_the_roofline_reads_the_qc_stream_mc_kernel_alone(kernel, counted):
    t = trace.Trace([{"name": trace.WINDOW, "cat": "user_annotation",
                      "ts": 0, "dur": 10000, "ph": "X"},
                     ev(kernel, 100, 2000), ev(kernel, 3000, 2000)])
    layer = {"kind": "sweep", "trace": t, "n": 102400, "m": 30720,
             "edges": 307200, "schedule": "layered",
             "chunks": [{"frames": 4096, "iterations": 4096 * 8}] * 2}
    value = run.read_layer(METRIC, layer)
    if not counted:
        assert value is None
        return
    bound_ms = 2 * mc_bound(4096, 102400, 307200, 4096 * 8, "layered")[0]
    assert value == pytest.approx(100.0 * bound_ms / 4.0)
    assert run.read_layer(METRIC, dict(layer, trace=None)) is None
    assert run.read_layer(METRIC, dict(layer, kind="rounds")) is None


def test_the_flagship_control_fails_the_limits(monkeypatch):
    from qkd_ldpc_v_tpu_torch import simulation

    # The control replaces the decode of every chunk step of the process.
    monkeypatch.setattr(simulation.ChunkStep, "decode",
                        simulation.ChunkStep.decode)
    out = tiny(NAME, dict(TINY_SWEEP, trials=16, chunk=16, qber=[0.035],
                          compare=ONE),
               hooks=control_qcsweep.hooks)
    assert out["correct"] is False
    assert out["checks"]["frame_mismatch"]["value"] > 0.0
    assert out["checks"]["stats_gap"]["value"] > 0.0


@pytest.mark.parametrize("config, edges, asset", [
    ("qc10k", 40960, "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"),
    ("qc100k", 307200, "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56).mtrx"),
])
def test_the_qc_configuration_states_its_codes_facts(config, edges, asset):
    c = run.load_json("configs", config)
    matrix = run.Context.path(c["matrix"])
    qc = read_qc(matrix)
    present = qc.shifts >= 0
    assert c["matrix_format"] == "qc" and c["schedule"] == "layered"
    assert (c["num_bit_nodes"], c["num_check_nodes"]) == (qc.n, qc.m)
    assert c["edges"] == int(present.sum()) * qc.z == edges
    assert c["lifting"] == qc.z
    assert c["base_matrix"] == list(qc.shifts.shape)
    assert {c["column_weight"]} == set(present.sum(axis=0).tolist())
    assert c["row_weights"] == sorted(set(present.sum(axis=1).tolist()))
    assert c["code_rate"] == pytest.approx(1 - qc.m / qc.n, abs=5e-3)
    # A byte copy of the repository's asset.
    assert matrix.read_bytes() == (ROOT / "sparse_matrices" / "matrices_qc"
                                   / asset).read_bytes()
